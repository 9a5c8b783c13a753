// K15 index_window: the index query, in two launches.
//
// Window mode replaces tigerbeetle_tpu/ops/index.py:111 `_search3` and :132
// `_query_side` (also ops/scan_builder.py:210 `_leaf_window`): for each
// (side, level) window, the first entry at or past (acct, ts_min) ascending,
// or the last one before (acct, ts_max + 1) descending (u64 wrap kept), then
// k entries walking away from it, each kept (ts, tid) when it lies in the
// level, matches the account and ts_min <= ts <= ts_max, else (U64_MAX, 0, 0).
// The search repeats the JAX loop: bit_length(n) halvings with the midpoint
// clipped at n - 1.
//
// Union mode replaces :165 `query_transfers`' concatenation, want gating and
// stable argsort: a candidate's key is U64_MAX where its side is not wanted
// or it is invalid, else ts (ascending) or ~ts (descending).  Each window's
// keys are non-decreasing (the valid candidates are a rank-ordered prefix,
// the rest U64_MAX), so the stable-sort position of candidate c of window w
// is  i_c + sum_{v<w} upper_v(key_c) + sum_{v>w} lower_v(key_c),  with
// lower/upper the bounds of key_c in window v found by binary search; no
// sort is needed, and equal keys (the U64_MAX tail) keep concatenation
// order, as argsort's.  Positions below k are written.
//
// Design: window mode runs a (k / 1,024 blocks) x (windows) grid; each
// block repeats its window's search (one thread, ~log2(n) reads) and fills
// 1,024 lanes.  Union mode runs one thread per candidate; a thread stops
// as soon as its position reaches k, so the invalid candidates past the
// first window cost one search each.
//
// What bounds it on the H100: latency.  The bytes are k x 40 B per window
// read and 24 B per candidate written, microseconds at 3.35 TB/s; the
// searches are chains of dependent reads.
#include "index_common.cuh"

#define WIN_MAX 64
#define WIN_THREADS 1024

struct WinLevels {
  const uint64_t* c[WIN_MAX][5];
  int64_t n[WIN_MAX];
};

static __device__ int64_t search3(const uint64_t* const* c, int64_t n,
                                  const IxKey& q) {
  int64_t lo = 0, hi = n;
  int iters = 0;
  for (uint64_t v = (uint64_t)n; v; v >>= 1) ++iters;
  for (int it = 0; it < iters; ++it) {
    int64_t mid = (lo + hi) / 2;
    if (mid > n - 1) mid = n - 1;
    const bool less = ix_less(ix_load(c, mid), q);
    if (lo < hi) {
      if (less) lo = mid + 1; else hi = mid;
    }
  }
  return lo;
}

__global__ void index_window_kernel(WinLevels L, uint64_t acct_lo,
                                    uint64_t acct_hi, uint64_t ts_min,
                                    uint64_t ts_max, int64_t k, int desc,
                                    uint64_t* __restrict__ out_ts,
                                    uint64_t* __restrict__ out_lo,
                                    uint64_t* __restrict__ out_hi) {
  const int w = blockIdx.y;
  const uint64_t* const* c = L.c[w];
  const int64_t n = L.n[w];
  __shared__ int64_t bound;
  if (threadIdx.x == 0) {
    const IxKey q{acct_hi, acct_lo, desc ? ts_max + 1 : ts_min};
    bound = search3(c, n, q);
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < k;
       i += stride) {
    const int64_t pos = desc ? bound - 1 - i : bound + i;
    const bool in_range = pos >= 0 && pos < n;
    const int64_t safe = pos < 0 ? 0 : (pos > n - 1 ? n - 1 : pos);
    const uint64_t e_ts = c[IX_TS][safe];
    const bool valid = in_range && c[IX_ACCT_HI][safe] == acct_hi &&
                       c[IX_ACCT_LO][safe] == acct_lo && e_ts >= ts_min &&
                       e_ts <= ts_max;
    const int64_t o = (int64_t)w * k + i;
    out_ts[o] = valid ? e_ts : IX_SENT;
    out_lo[o] = valid ? c[IX_TID_LO][safe] : 0;
    out_hi[o] = valid ? c[IX_TID_HI][safe] : 0;
  }
}

struct UnionArgs {
  const uint64_t* ts;
  int64_t k;
  int nwin, nwin_first;  // windows in all, and of the first side
  int want_first, want_second, desc;
};

static __device__ __forceinline__ uint64_t union_key(const UnionArgs& u,
                                                     int64_t idx) {
  const int w = (int)(idx / u.k);
  const bool want = w < u.nwin_first ? u.want_first : u.want_second;
  const uint64_t ts = want ? u.ts[idx] : IX_SENT;
  return ts == IX_SENT ? IX_SENT : (u.desc ? ~ts : ts);
}

// First i in [0, k) of window w with key >= x (strict: key > x).
static __device__ int64_t window_bound(const UnionArgs& u, int w, uint64_t x,
                                       bool strict) {
  int64_t lo = 0, hi = u.k;
  const int64_t base = (int64_t)w * u.k;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const uint64_t km = union_key(u, base + mid);
    if (strict ? km <= x : km < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void index_union_kernel(UnionArgs u,
                                   const uint64_t* __restrict__ cand_lo,
                                   const uint64_t* __restrict__ cand_hi,
                                   uint8_t* __restrict__ out_valid,
                                   uint64_t* __restrict__ out_lo,
                                   uint64_t* __restrict__ out_hi) {
  const int64_t c = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (c >= (int64_t)u.nwin * u.k) return;
  const int wc = (int)(c / u.k);
  const uint64_t key = union_key(u, c);
  int64_t pos = c - (int64_t)wc * u.k;
  for (int w = 0; w < u.nwin && pos < u.k; ++w) {
    if (w == wc) continue;
    pos += window_bound(u, w, key, w < wc);
  }
  if (pos >= u.k) return;
  const int w = wc;
  const bool want = w < u.nwin_first ? u.want_first : u.want_second;
  out_valid[pos] = want && u.ts[c] != IX_SENT;
  out_lo[pos] = cand_lo[c];
  out_hi[pos] = cand_hi[c];
}

// `cols`: nwin x 5 level column pointers; `ns`: nwin level lengths; the
// outputs hold nwin x k entries, window after window.
extern "C" int tb_index_window(const void* const* cols, const int64_t* ns,
                               int nwin, uint64_t acct_lo, uint64_t acct_hi,
                               uint64_t ts_min, uint64_t ts_max, int64_t k,
                               int desc, void* out_ts, void* out_lo,
                               void* out_hi, void* stream) {
  if (nwin < 1 || nwin > WIN_MAX || k < 1) return (int)cudaErrorInvalidValue;
  WinLevels L;
  for (int w = 0; w < nwin; ++w) {
    for (int c = 0; c < 5; ++c) L.c[w][c] = (const uint64_t*)cols[5 * w + c];
    L.n[w] = ns[w];
    if (ns[w] < 1) return (int)cudaErrorInvalidValue;
  }
  const int64_t bx = (k + WIN_THREADS - 1) / WIN_THREADS;
  index_window_kernel<<<dim3((unsigned)bx, (unsigned)nwin), WIN_THREADS, 0,
                        (cudaStream_t)stream>>>(
      L, acct_lo, acct_hi, ts_min, ts_max, k, desc, (uint64_t*)out_ts,
      (uint64_t*)out_lo, (uint64_t*)out_hi);
  return (int)cudaGetLastError();
}

// The union of window mode's nwin x k candidates (the first nwin_first
// windows are one side's) into k results: valid, tid_lo, tid_hi.
extern "C" int tb_index_union(const void* cand_ts, const void* cand_lo,
                              const void* cand_hi, int nwin, int nwin_first,
                              int want_first, int want_second, int desc,
                              int64_t k, void* out_valid, void* out_lo,
                              void* out_hi, void* stream) {
  if (nwin < 1 || nwin > 2 * WIN_MAX || k < 1) return (int)cudaErrorInvalidValue;
  UnionArgs u{(const uint64_t*)cand_ts, k, nwin, nwin_first, want_first,
              want_second, desc};
  const int threads = 256;
  const int64_t blocks = ((int64_t)nwin * k + threads - 1) / threads;
  index_union_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      u, (const uint64_t*)cand_lo, (const uint64_t*)cand_hi,
      (uint8_t*)out_valid, (uint64_t*)out_lo, (uint64_t*)out_hi);
  return (int)cudaGetLastError();
}
