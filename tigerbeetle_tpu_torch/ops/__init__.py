"""Device operations: the hash table, the commit kernels' compositions, and the
CUDA kernel bindings (``_cuda``)."""
