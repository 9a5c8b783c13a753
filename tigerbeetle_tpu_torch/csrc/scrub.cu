// K21 scrub_fold: the scrub digest of the three ledger pads in one launch.
//
// Replaces tigerbeetle_tpu/ops/scrub.py:151 `scrub_digest` (with :137-147
// `_fold_accounts`, `_fold_transfers`, `_fold_posted`, :129 `leaf_hashes`
// and :108-124 `row_hash_*`): out[p] = the wrapping u64 sum, over the live
// slots of pad p (accounts, transfers, posted), of the pad's row fold
// (leaf.cuh).  The accounts fold is bit for bit K5's `ledger_digest`.
//
// blockIdx.y picks the pad; the blocks of a pad stride over its slots, sum
// in registers, reduce in the block with integer shuffles, and add the
// block's sum to out[p] with one u64 atomicAdd.  Integer addition wraps and
// commutes, so the result is exact and independent of the order.
//
// What bounds it on the H100: bytes.  It reads the 16 B key pair of every
// slot once, coalesced, and the digested columns of live slots only (72 B an
// account, 24 B a transfer, 4 B a posted row); the few mix64 a slot are
// integer work far below the bytes' time.
#include "leaf.cuh"

struct ScrubPads {
  PadCols pad[3];
};

__global__ void scrub_fold_kernel(ScrubPads a, ull* out) {
  __shared__ ull red[32];
  const PadCols& p = a.pad[blockIdx.y];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  ull sum = 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < p.capacity; i += stride)
    sum += leaf_at(p, i);
  const ull total = block_sum(sum, red);
  if (threadIdx.x == 0 && total) atomicAdd(out + blockIdx.y, total);
}

// `keys`: six pointers (key_lo, key_hi of accounts, transfers, posted);
// `cols`: the accounts' nine, the transfers' three and the posted pad's one
// column (leaf.cuh); `caps`: the three capacities; `out` (three u64) must be
// zero on entry.
extern "C" int tb_scrub_fold(const void* const* keys, const void* const* cols,
                             const int64_t* caps, void* out, void* stream) {
  ScrubPads a;
  const void* const* c = cols;
  int64_t most = 0;
  for (int k = 0; k < 3; ++k) {
    int err = pack_pad(&a.pad[k], k, keys[2 * k], keys[2 * k + 1], c, caps[k]);
    if (err) return err;
    c += pad_ncols(k);
    if (caps[k] > most) most = caps[k];
  }
  const int threads = 256;
  int64_t blocks = (most + threads - 1) / threads;
  if (blocks > 352) blocks = 352;  // with three pads, 8 blocks on each SM
  scrub_fold_kernel<<<dim3((unsigned)blocks, 3), threads, 0,
                      (cudaStream_t)stream>>>(a, (ull*)out);
  return (int)cudaGetLastError();
}
