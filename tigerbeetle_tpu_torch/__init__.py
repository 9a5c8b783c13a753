"""tigerbeetle-tpu on PyTorch and CUDA: the port of ``tigerbeetle_tpu`` to one
NVIDIA H100.

The JAX package beside this one is the reference.  This package never imports
JAX nor anything of ``tigerbeetle_tpu``: the modules it needs that carry no JAX
(``types``, ``config``, ``obs.metrics``, ``testing.model``) are copies, kept
equal to their sources apart from import lines by ``tests/test_torch_machine.py``.

Every u64 rides as an int64 tensor holding the same bits, every u32 as an
int32 tensor holding the same bits (see ``u128``).  Device work on the commit
path runs in hand-written CUDA kernels (``csrc/``, bound in ``ops/_cuda.py``);
each kernel has a plain PyTorch version beside it, used for tensors that lie
on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with no
card and no explicit ``"cpu"`` they raise (``device.resolve``).
"""

__version__ = "0.1.0"
