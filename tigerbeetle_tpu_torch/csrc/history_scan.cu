// K16 history_scan: get_account_history's masked scan of the history log,
// its top k and its side-selected gather.
//
// Replaces tigerbeetle_tpu/ops/query.py:38 `scan_history` with :29 `_top_k`
// (an argsort of the whole log).  A slot's key is ts (descending) or ~ts
// (ascending) where it matches: below `count`, the account on a wanted
// side, ts_min <= ts <= ts_max; else 0.  The result is the k slots of
// largest (key, slot), largest first, with valid = key != 0; past the
// matches that is the other slots, highest slot first.
//
// Design: the log below `count` carries strictly increasing timestamps
// (every commit path appends in lane order, and a rolled-back chain pops
// `count`).  So the matches (key != 0) in slot order have monotone keys,
// and the top k needs no sort: with r the number of matches below slot s
// and m all of them, a match goes to position m-1-r (descending) or r
// (ascending), a non-match to cap-1-s+r.  Three launches: per-block match
// counts (which also check the timestamps below `count`, raising a flag if
// one is not larger than the one before), one block's scan of those
// counts, and the placement with each block's prefix of its matches (warp
// ballots).  Positions below k write valid and the nine row columns.  The
// wrapper raises if the flag is set: the answer is the plain version's or
// none.
//
// What bounds it on the H100: bytes.  The two passes read five u64 columns
// of every slot (the side ids and the timestamp, 40 B) and the placement
// gathers 80 B for each of the k results.
#include "common.cuh"

#define HS_THREADS 1024

// History columns in the order of ops/state_machine.py HISTORY_COLS.
enum {
  H_DR_ID_LO = 0, H_DR_ID_HI = 1, H_DR_BAL = 2,  // 8 balance columns
  H_CR_ID_LO = 10, H_CR_ID_HI = 11, H_CR_BAL = 12, H_TS = 20, H_COLS = 21
};

struct HistQuery {
  const uint64_t* c[H_COLS];
  const int64_t* count;
  int64_t cap, k;
  uint64_t acct_lo, acct_hi, ts_min, ts_max;
  int want_dr, want_cr, desc;
};

static __device__ __forceinline__ bool hs_is_dr(const HistQuery& q, int64_t s) {
  return q.want_dr && q.c[H_DR_ID_LO][s] == q.acct_lo &&
         q.c[H_DR_ID_HI][s] == q.acct_hi;
}

static __device__ __forceinline__ bool hs_top(const HistQuery& q, int64_t s,
                                              int64_t count, bool* is_dr) {
  *is_dr = hs_is_dr(q, s);
  const bool is_cr = q.want_cr && q.c[H_CR_ID_LO][s] == q.acct_lo &&
                     q.c[H_CR_ID_HI][s] == q.acct_hi;
  const uint64_t ts = q.c[H_TS][s];
  const bool match = s < count && (*is_dr || is_cr) && ts >= q.ts_min &&
                     ts <= q.ts_max;
  const uint64_t key = match ? (q.desc ? ts : ~ts) : 0;
  return key != 0;
}

__global__ void hs_count_kernel(HistQuery q, int64_t* __restrict__ block_counts,
                                int* __restrict__ err) {
  const int64_t s = blockIdx.x * (int64_t)HS_THREADS + threadIdx.x;
  const int64_t count = *q.count;
  bool flag = false, is_dr;
  if (s < q.cap) {
    flag = hs_top(q, s, count, &is_dr);
    if (s + 1 < count && !(q.c[H_TS][s] < q.c[H_TS][s + 1])) atomicOr(err, 1);
  }
  const int n = __syncthreads_count(flag);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = n;
}

// Exclusive scan of nb block counts in place; the total lands at [nb].
__global__ void hs_scan_kernel(int64_t* __restrict__ block_counts, int64_t nb) {
  __shared__ int64_t part[HS_THREADS];
  __shared__ int64_t carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < nb; base += HS_THREADS) {
    const int64_t i = base + threadIdx.x;
    const int64_t v = i < nb ? block_counts[i] : 0;
    part[threadIdx.x] = v;
    __syncthreads();
    for (int off = 1; off < HS_THREADS; off <<= 1) {
      const int64_t add = threadIdx.x >= off ? part[threadIdx.x - off] : 0;
      __syncthreads();
      part[threadIdx.x] += add;
      __syncthreads();
    }
    if (i < nb) block_counts[i] = carry + part[threadIdx.x] - v;
    __syncthreads();
    if (threadIdx.x == HS_THREADS - 1) carry += part[HS_THREADS - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) block_counts[nb] = carry;
}

__global__ void hs_place_kernel(HistQuery q,
                                const int64_t* __restrict__ block_offsets,
                                int64_t nb, uint8_t* __restrict__ out_valid,
                                Ptrs out_rows) {
  __shared__ int warp_sums[HS_THREADS / 32];
  const int64_t s = blockIdx.x * (int64_t)HS_THREADS + threadIdx.x;
  const int64_t count = *q.count;
  bool is_dr = false;
  const bool flag = s < q.cap && hs_top(q, s, count, &is_dr);
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = __popc(ballot);
  __syncthreads();
  int before = __popc(ballot & ((1u << lane) - 1));
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  if (s >= q.cap) return;
  const int64_t r = block_offsets[blockIdx.x] + before;
  const int64_t m = block_offsets[nb];
  const int64_t pos = flag ? (q.desc ? m - 1 - r : r) : q.cap - 1 - s + r;
  if (pos >= q.k) return;
  out_valid[pos] = flag;
  uint64_t* const* rows = (uint64_t* const*)out_rows.p;
  rows[0][pos] = q.c[H_TS][s];
  const int side = is_dr ? H_DR_BAL : H_CR_BAL;
  for (int f = 0; f < 8; ++f) rows[1 + f][pos] = q.c[side + f][s];
}

// `cols`: the 21 history columns; `count`: the device count (int64[1]);
// `scratch`: int64[cap / 1,024 + 2]; `err`: int32[1], zero on entry, set
// when the log's timestamps below count do not increase; `out_rows`: nine
// columns (timestamp, then the four balance fields lo/hi) of k entries.
extern "C" int tb_history_scan(const void* const* cols, const void* count,
                               int64_t cap, int64_t k, uint64_t acct_lo,
                               uint64_t acct_hi, uint64_t ts_min,
                               uint64_t ts_max, int want_dr, int want_cr,
                               int desc, void* scratch, void* err,
                               void* out_valid, void* const* out_rows,
                               void* stream) {
  if (cap < 1 || k < 1 || k > cap) return (int)cudaErrorInvalidValue;
  HistQuery q;
  for (int c = 0; c < H_COLS; ++c) q.c[c] = (const uint64_t*)cols[c];
  q.count = (const int64_t*)count;
  q.cap = cap;
  q.k = k;
  q.acct_lo = acct_lo; q.acct_hi = acct_hi;
  q.ts_min = ts_min; q.ts_max = ts_max;
  q.want_dr = want_dr; q.want_cr = want_cr; q.desc = desc;
  Ptrs rows;
  const int perr = pack_ptrs(&rows, 9, (const void* const*)out_rows);
  if (perr) return perr;
  const int64_t nb = (cap + HS_THREADS - 1) / HS_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  int64_t* counts = (int64_t*)scratch;
  hs_count_kernel<<<(unsigned)nb, HS_THREADS, 0, st>>>(q, counts, (int*)err);
  hs_scan_kernel<<<1, HS_THREADS, 0, st>>>(counts, nb);
  hs_place_kernel<<<(unsigned)nb, HS_THREADS, 0, st>>>(
      q, counts, nb, (uint8_t*)out_valid, rows);
  return (int)cudaGetLastError();
}
