// K31 shard_combine: the wrap-sum of the S shard partials a device holds,
// for every row of a gather round at once.
//
// Replaces tigerbeetle_tpu/parallel/sharded.py:156-164 (`_ShardGather`'s
// `jax.lax.psum` of found, the global slot and each gathered column) and
// :367 `any_shard`'s psum, within one device: the JAX package does one psum
// a column; this sums the whole packed int64 buffer of a round (every key
// set, every column, the overflow words) in one launch.  Across cards an
// NCCL all-reduce of the result follows (parallel/mesh.py).
//
// Semantics: out[m] = sum over s of partial[s * M + m], mod 2^64.  The terms
// are owner-masked, so at most one is nonzero per element and the sum is
// exact, as the JAX package's determinism note says (sharded.py:23-25).
//
// What bounds it on the H100: bytes: S * M words read once, in columns
// (thread m reads partial[s * M + m] for each s, coalesced across threads),
// and M words written once.
#include "common.cuh"

__global__ void shard_combine_kernel(const uint64_t* __restrict__ partial,
                                     int64_t S, int64_t M,
                                     uint64_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t m = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; m < M;
       m += stride) {
    uint64_t sum = 0;
    for (int64_t s = 0; s < S; ++s) sum += partial[s * M + m];
    out[m] = sum;
  }
}

extern "C" int tb_shard_combine(const void* partial, int64_t S, int64_t M,
                                void* out, void* stream) {
  if (S < 0 || M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const int threads = 256;
  int64_t blocks = (M + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride past 16 a SM
  shard_combine_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)partial, S, M, (uint64_t*)out);
  return (int)cudaGetLastError();
}
