// K14 run_merge: stable merge-path merge of sorted index runs.
//
// Replaces tigerbeetle_tpu/ops/index.py:77 `_merge` (concatenate the
// sorted runs, then a stable lexsort) in the Bentley–Saxe carry of
// `TransferIndex.append_batch` (:246) and `FieldIndex.append_batch`
// (ops/scan_builder.py:264), and the merge rounds of the full builds
// (`_full_build_side` :88, `_full_build_field` scan_builder.py:177) after
// K13's chunk sort.  Merging A (earlier in the concatenation) with B, A's
// element first on equal keys, gives the stable sort of A ++ B; the carry
// (run + level 0 + level 1 + ...) is a chain of such pairwise merges, so the
// result is the JAX array byte for byte.
//
// Design: each job merges `npairs` pairs (A_p, B_p) laid out at fixed
// strides (one pair for a carry step; every pair of adjacent runs for a
// round of a full build), and a launch takes up to two jobs (the debit and
// credit sides).  Each block owns 1,024 outputs of one pair: two threads
// find the tile's merge-path splits by binary search over device memory,
// the block stages the tile's keys from A and B in shared memory (24 KB),
// and each of 256 threads merges 4 outputs from its own split, found by a
// binary search in shared memory.  Payload columns are read by source index.
//
// What bounds it on the H100: bytes.  Each entry is read once (40 B) and
// written once (40 B); the searches add log2 reads per tile and per thread
// in shared memory.
#include "index_common.cuh"

#define MERGE_TILE 1024
#define MERGE_THREADS 256
#define MERGE_ITEMS 4

struct MergeJob {
  const uint64_t* a[5];
  const uint64_t* b[5];
  uint64_t* o[5];
  int64_t la, lb, npairs, stride_a, stride_b, stride_o;
};

struct MergeJobs {
  MergeJob j[2];
};

__global__ void run_merge_kernel(MergeJobs jobs) {
  const MergeJob& J = jobs.j[blockIdx.y];
  const int64_t total = J.la + J.lb;
  const int64_t tiles = (total + MERGE_TILE - 1) / MERGE_TILE;
  const int64_t pair = blockIdx.x / tiles;
  if (pair >= J.npairs) return;
  const int64_t d0 = (blockIdx.x % tiles) * MERGE_TILE;
  const int64_t d1 = d0 + MERGE_TILE < total ? d0 + MERGE_TILE : total;
  const uint64_t* a[5];
  const uint64_t* b[5];
  uint64_t* o[5];
  for (int c = 0; c < 5; ++c) {
    a[c] = J.a[c] + pair * J.stride_a;
    b[c] = J.b[c] + pair * J.stride_b;
    o[c] = J.o[c] + pair * J.stride_o;
  }
  __shared__ int64_t split[2];
  __shared__ uint64_t s_hi[MERGE_TILE], s_lo[MERGE_TILE], s_ts[MERGE_TILE];
  if (threadIdx.x < 2)
    split[threadIdx.x] = merge_split<int64_t>(
        J.la, J.lb, threadIdx.x ? d1 : d0, [&](int64_t i, int64_t j) {
          return ix_less(ix_load(b, j), ix_load(a, i));
        });
  __syncthreads();
  const int64_t i0 = split[0], j0 = d0 - split[0];
  const int na = (int)(split[1] - i0), nb = (int)((d1 - split[1]) - j0);
  for (int e = threadIdx.x; e < na + nb; e += blockDim.x) {
    const uint64_t* const* src = e < na ? a : b;
    const int64_t g = e < na ? i0 + e : j0 + (e - na);
    s_hi[e] = src[IX_ACCT_HI][g];
    s_lo[e] = src[IX_ACCT_LO][g];
    s_ts[e] = src[IX_TS][g];
  }
  __syncthreads();
  const int ld = threadIdx.x * MERGE_ITEMS;
  if (ld >= na + nb) return;
  // This thread's split inside the tile (B staged after A's na entries).
  const int lo = merge_split<int>(na, nb, ld, [&](int i, int j) {
    return ix_less(IxKey{s_hi[na + j], s_lo[na + j], s_ts[na + j]},
                   IxKey{s_hi[i], s_lo[i], s_ts[i]});
  });
  int ia = lo, ib = ld - lo;
  for (int it = 0; it < MERGE_ITEMS && ld + it < na + nb; ++it) {
    bool take_a;
    if (ib >= nb) {
      take_a = true;
    } else if (ia >= na) {
      take_a = false;
    } else {
      const IxKey ka{s_hi[ia], s_lo[ia], s_ts[ia]};
      const IxKey kb{s_hi[na + ib], s_lo[na + ib], s_ts[na + ib]};
      take_a = !ix_less(kb, ka);
    }
    const int si = take_a ? ia : na + ib;
    const uint64_t* const* src = take_a ? a : b;
    const int64_t g = take_a ? i0 + ia : j0 + ib;
    const int64_t out = d0 + ld + it;
    o[IX_ACCT_HI][out] = s_hi[si];
    o[IX_ACCT_LO][out] = s_lo[si];
    o[IX_TS][out] = s_ts[si];
    o[IX_TID_LO][out] = src[IX_TID_LO][g];
    o[IX_TID_HI][out] = src[IX_TID_HI][g];
    if (take_a) ++ia; else ++ib;
  }
}

// `cols`: jobs x 15 pointers (A's five columns, B's, the output's);
// `sizes`: jobs x 6 int64 (la, lb, npairs, stride_a, stride_b, stride_o).
extern "C" int tb_run_merge(const void* const* cols, const int64_t* sizes,
                            int jobs, void* stream) {
  if (jobs < 1 || jobs > 2) return (int)cudaErrorInvalidValue;
  MergeJobs m;
  int64_t blocks = 0;
  for (int j = 0; j < jobs; ++j) {
    MergeJob& J = m.j[j];
    for (int c = 0; c < 5; ++c) {
      J.a[c] = (const uint64_t*)cols[15 * j + c];
      J.b[c] = (const uint64_t*)cols[15 * j + 5 + c];
      J.o[c] = (uint64_t*)cols[15 * j + 10 + c];
    }
    const int64_t* s = sizes + 6 * j;
    J.la = s[0]; J.lb = s[1]; J.npairs = s[2];
    J.stride_a = s[3]; J.stride_b = s[4]; J.stride_o = s[5];
    if (J.la < 0 || J.lb < 0 || J.npairs < 0) return (int)cudaErrorInvalidValue;
    const int64_t tiles = (J.la + J.lb + MERGE_TILE - 1) / MERGE_TILE;
    if (tiles * J.npairs > blocks) blocks = tiles * J.npairs;
  }
  if (blocks == 0) return 0;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  run_merge_kernel<<<dim3((unsigned)blocks, (unsigned)jobs), MERGE_THREADS, 0,
                     (cudaStream_t)stream>>>(m);
  return (int)cudaGetLastError();
}
