// K31 shard_combine: the wrap-sum of the S shard partials a device holds.
//
// Replaces tigerbeetle_tpu/parallel/sharded.py:367 `any_shard`'s psum (the
// flag words ORed as 0/1 terms) within one device, before an NCCL
// all-reduce across cards (parallel/mesh.py `Mesh.psum`).  `_ShardGather`'s
// psum (:156-164) needs no sum within a device: K30 writes the device's one
// answer row itself, and only the NCCL all-reduce across cards remains.
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
