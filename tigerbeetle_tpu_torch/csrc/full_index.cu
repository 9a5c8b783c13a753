// K9 full_index: the batch's id groups and the in-batch pending join of the
// general transfer kernel.
//
// Replaces tigerbeetle_tpu/ops/transfer_full.py:199 `_build_id_index` (a
// lexsort of the ids, run ids, `any_dup`) and the pending join built on
// :212 `_search128` (:725-731 `pj_hit`/`pj_group`).
//
// The JAX function sorts the ids to group equal ones; only the grouping is
// used, so here each group is labelled by its lowest lane (the port's plain
// version labels it the same way, and the two are compared array for
// array).  Lanes are grouped through a batch-local open-addressing table of
// lane indices, as K3 groups duplicates (batch_hash.cuh): the first lane to
// claim a slot keys it, and an atomicMin per slot gives the lowest lane.
// Id 0 (padding, and invalid events) is a key like any other: its group
// never wins (such lanes are never ok), but a pending_id of 0 does join it,
// as the JAX search does.  `any_dup` is set by a lane with a nonzero id that
// is not its group's lowest.  The pending join looks each lane's pending_id
// up in the same table.
//
// One block of 1,024 threads, 8 lanes each.  What bounds it on the H100:
// latency (three dependent phases of a few hashed reads per lane; the
// 2 x 2 hsize words of table fit in L2); the bytes it must move (ids and
// pending ids in, four lane arrays out, about 0.4 MB at 8,192 lanes) take
// about 0.1 us.
#include "batch_hash.cuh"
#include "full_common.cuh"

__global__ void __launch_bounds__(FULL_THREADS, 1)
    full_index_kernel(const uint64_t* __restrict__ id_lo,
                      const uint64_t* __restrict__ id_hi,
                      const uint64_t* __restrict__ pend_lo,
                      const uint64_t* __restrict__ pend_hi, int n,
                      int* __restrict__ hkey, int* __restrict__ hlead,
                      int hsize, int* __restrict__ slot_of,
                      int64_t* __restrict__ group_out,
                      uint8_t* __restrict__ any_dup,
                      uint8_t* __restrict__ pj_hit,
                      int64_t* __restrict__ pj_group) {
  const int T = blockDim.x, tid = threadIdx.x;
  for (int j = tid; j < hsize; j += T) {
    hkey[j] = -1;
    hlead[j] = INT_MAX;
  }
  if (tid == 0) *any_dup = 0;
  __syncthreads();
  for (int i = tid; i < n; i += T) {
    const int h = batch_hash_insert(hkey, hsize, id_lo, id_hi, i);
    slot_of[i] = h;
    atomicMin(hlead + h, i);
  }
  __syncthreads();
  for (int i = tid; i < n; i += T) {
    const int lead = hlead[slot_of[i]];
    group_out[i] = lead;
    if (lead != i && (id_lo[i] | id_hi[i]) != 0) *any_dup = 1;
    const int h = batch_hash_find(hkey, hsize, id_lo, id_hi, pend_lo[i],
                                  pend_hi[i]);
    pj_hit[i] = h >= 0 ? 1 : 0;
    pj_group[i] = h >= 0 ? hlead[h] : 0;
  }
}

extern "C" int tb_full_index(const void* id_lo, const void* id_hi,
                             const void* pend_lo, const void* pend_hi,
                             int64_t n, void* scratch, int64_t hsize,
                             void* group, void* any_dup, void* pj_hit,
                             void* pj_group, void* stream) {
  if (n <= 0 || n > FULL_MAX_LEGS / 2 || hsize < 2 * n ||
      (hsize & (hsize - 1)))
    return (int)cudaErrorInvalidValue;
  int* s = (int*)scratch;  // hkey[hsize], hlead[hsize], slot_of[n]
  full_index_kernel<<<1, FULL_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)id_lo, (const uint64_t*)id_hi, (const uint64_t*)pend_lo,
      (const uint64_t*)pend_hi, (int)n, s, s + hsize, (int)hsize,
      s + 2 * hsize, (int64_t*)group, (uint8_t*)any_dup, (uint8_t*)pj_hit,
      (int64_t*)pj_group);
  return (int)cudaGetLastError();
}
