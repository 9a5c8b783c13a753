// K15 index_window: the index query.
//
// Window mode replaces tigerbeetle_tpu/ops/index.py:111 `_search3` and :132
// `_query_side` (also ops/scan_builder.py:210 `_leaf_window`): for each
// (side, level) window, the first entry at or past (acct, ts_min) ascending,
// or the last one before (acct, ts_max + 1) descending (u64 wrap kept), then
// k entries walking away from it, each kept (ts, tid) when it lies in the
// level, matches the account and ts_min <= ts <= ts_max, else (U64_MAX, 0, 0).
//
// Union mode replaces :165 `query_transfers` (window mode, then the
// concatenation, the want gating and the stable argsort) without making the
// nwin x k candidates.  In a sorted level the valid candidates of a window
// are a prefix, m of them: the entries between two bounds of the level.
// The sort key of a candidate is ts ascending, ~ts descending, U64_MAX where
// its side is not wanted or it is invalid; the keys below U64_MAX of a
// wanted window are a prefix too (r entries; an entry of ts U64_MAX, or of
// ts 0 descending, keys U64_MAX).  So the result is: first the r-prefixes of
// the wanted windows merged by key, an entry's position being its index plus
// the count of keys <= its key in every earlier window and of keys < it in
// every later one (stable argsort's order); then, from position R (the sum
// of the r), the candidates with key U64_MAX in concatenation order: of a
// wanted window its candidates from r on, of another all k, each (valid
// where it is a valid candidate and its ts is not U64_MAX, its tid where it
// is a valid candidate, else 0).  Only positions below k are written.  If
// some wanted window has r = k, no entry whose key passes the smallest such
// window's k-th key can reach a position below k, so each window's merged
// prefix is cut there first.
//
// Design.  A window's bounds come from a 32-ary search by one warp: each
// lane loads one pivot a round and a ballot narrows the range 32-fold, so
// a level of 2^23 entries takes 5 rounds of dependent loads (the bounds a
// window needs are searched together: two, or three where ts_max is
// U64_MAX ascending or ts_min is 0 descending).  Window mode: a block of
// 1,024 threads a (window, 1,024 candidates), its warp 0 searching.  Union
// mode: one block of 1,024 threads, a warp a window; after a barrier the
// merged prefixes' entries (key and tid) are staged in shared memory, all
// their loads in flight at once (up to UNION_STAGE_MAX entries, else read
// from the levels), and each thread ranks entries by binary searches in
// the other windows (a window whose first key passes, or whose last key
// does not, is counted without a search), then the block writes the
// closed-form tail.  One block, because the work of a query is a few
// thousand entries and the block barriers cost far less than grid ones.
// The parent had thread 0 of each block search alone (24 dependent reads
// on 2^23 entries) and then wrote and ranked all nwin x k candidates.
// On the queries phase's pyramid (22 levels, 1.3 GB) a 64- or 128-ary
// search (two or four pivots a lane, a round fewer) was slower on an H100
// 80GB HBM3: a round costs its loads, not only its latency.
//
// What bounds it on the H100: latency; the bytes are the searches' pivots,
// the valid entries and the k results.
#include "index_common.cuh"
#include "phase_clock.cuh"

#define WIN_MAX 64
#define WIN_THREADS 1024
#define UNION_THREADS 1024
#define UNION_STAGE_MAX 8192  // staged entries: 192 KB of shared memory
struct WinLevels {
  const uint64_t* c[WIN_MAX][5];
  int64_t n[WIN_MAX];
};

struct WinQuery {
  uint64_t acct_lo, acct_hi, ts_min, ts_max;
  int64_t k;
  int desc;
  int nwin, nwin_first;  // windows in all, and of the first side
  int want_first, want_second;
};

// A window: its start, its valid candidates (m) and those of them whose
// key is below U64_MAX (r), each at most k.
struct WinDesc {
  int64_t bound, m, r;
};

// The first index of each of NQ sorted-level queries: q[j]'s lower bound
// (first entry >= q[j]), or its upper bound (first entry > q[j]) where
// upper[j].  One warp, 32-ary: each round lane l tests pivot lo + (l + 1)
// step - 1 of every live range, and the ballot's count of pivots still
// before the bound narrows each range to one step.  Equal to the JAX
// search's clipped-midpoint loop on a sorted level.
template <int NQ>
static __device__ void warp_bounds(const uint64_t* const* c, int64_t n,
                                   const IxKey (&q)[NQ],
                                   const bool (&upper)[NQ],
                                   int64_t (&res)[NQ]) {
  const int lane = threadIdx.x & 31;
  int64_t lo[NQ], hi[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) lo[j] = 0, hi[j] = n;
  for (;;) {
    bool live = false;
#pragma unroll
    for (int j = 0; j < NQ; ++j) live |= lo[j] < hi[j];
    if (!live) break;
    int64_t step[NQ];
    bool before[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      step[j] = (hi[j] - lo[j] + 31) >> 5;
      const int64_t p = lo[j] + (lane + 1) * step[j] - 1;
      before[j] = false;
      if (p < hi[j]) {
        const IxKey e = ix_load(c, p);
        before[j] = upper[j] ? !ix_less(q[j], e) : ix_less(e, q[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int cnt = __popc(__ballot_sync(0xffffffffu, before[j]));
      if (lo[j] < hi[j]) {
        const int64_t top = lo[j] + (cnt + 1) * step[j] - 1;
        lo[j] += cnt * step[j];
        if (top < hi[j]) hi[j] = top;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NQ; ++j) res[j] = lo[j];
}

// Window w's descriptor (every lane of the calling warp gets it).
// Ascending: the candidates start at the lower bound of (acct, ts_min);
// the valid ones end at the upper bound of (acct, ts_max), those with ts
// below U64_MAX at that of (acct, min(ts_max, U64_MAX - 1)).  Descending:
// they start below the lower bound of (acct, ts_max + 1) (wrapping, as the
// JAX code does) and end at the lower bound of (acct, ts_min), those with
// ts above 0 at that of (acct, max(ts_min, 1)).
static __device__ WinDesc window_desc(const WinLevels& L, int w,
                                      const WinQuery& Q) {
  const uint64_t* const* c = L.c[w];
  const int64_t n = L.n[w];
  // The third bound differs from the second only where ts_max is U64_MAX
  // (ascending) or ts_min is 0 (descending).
  const uint64_t ts0 = Q.desc ? Q.ts_max + 1 : Q.ts_min;
  const uint64_t ts1 = Q.desc ? Q.ts_min : Q.ts_max;
  const uint64_t ts2 = Q.desc ? (Q.ts_min > 0 ? Q.ts_min : 1)
                              : (Q.ts_max < IX_SENT ? Q.ts_max : IX_SENT - 1);
  const bool up = !Q.desc;
  int64_t b[3];
  if (ts2 == ts1) {
    const IxKey q[2] = {{Q.acct_hi, Q.acct_lo, ts0},
                        {Q.acct_hi, Q.acct_lo, ts1}};
    const bool u[2] = {false, up};
    int64_t r2[2];
    warp_bounds<2>(c, n, q, u, r2);
    b[0] = r2[0];
    b[1] = b[2] = r2[1];
  } else {
    const IxKey q[3] = {{Q.acct_hi, Q.acct_lo, ts0},
                        {Q.acct_hi, Q.acct_lo, ts1},
                        {Q.acct_hi, Q.acct_lo, ts2}};
    const bool u[3] = {false, up, up};
    warp_bounds<3>(c, n, q, u, b);
  }
  auto clamp = [&](int64_t v) { return v < 0 ? 0 : (v > Q.k ? Q.k : v); };
  WinDesc d;
  d.bound = b[0];
  d.m = clamp(Q.desc ? b[0] - b[1] : b[1] - b[0]);
  d.r = clamp(Q.desc ? b[0] - b[2] : b[2] - b[0]);
  return d;
}

static __device__ __forceinline__ int64_t win_pos(const WinQuery& Q,
                                                  int64_t bound, int64_t i) {
  return Q.desc ? bound - 1 - i : bound + i;
}

__global__ void __launch_bounds__(WIN_THREADS)
    index_window_kernel(WinLevels L, WinQuery Q,
                        uint64_t* __restrict__ out_ts,
                        uint64_t* __restrict__ out_lo,
                        uint64_t* __restrict__ out_hi) {
  const int w = blockIdx.y;
  const uint64_t* const* c = L.c[w];
  __shared__ int64_t s_bound, s_m;
  if (threadIdx.x < 32) {
    const WinDesc d = window_desc(L, w, Q);
    if (threadIdx.x == 0) s_bound = d.bound, s_m = d.m;
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < Q.k;
       i += stride) {
    const int64_t o = (int64_t)w * Q.k + i;
    if (i < s_m) {
      const int64_t p = win_pos(Q, s_bound, i);
      out_ts[o] = c[IX_TS][p];
      out_lo[o] = c[IX_TID_LO][p];
      out_hi[o] = c[IX_TID_HI][p];
    } else {
      out_ts[o] = IX_SENT;
      out_lo[o] = 0;
      out_hi[o] = 0;
    }
  }
}

// The union's shared state: per window its start, m, r, merged prefix c
// (r cut at the prune key), its first index in the staged keys and in the
// tail, and its prefix's first and last keys; the windows whose prefix is
// not empty (`nz`); `keys` (dynamic) the staged keys, window after window.
struct UnionShared {
  int64_t bound[WIN_MAX], m[WIN_MAX], r[WIN_MAX], c[WIN_MAX];
  int64_t off[WIN_MAX + 1], tail[WIN_MAX + 1];
  uint64_t kth[WIN_MAX], first[WIN_MAX], last[WIN_MAX];
  int nz[WIN_MAX];
  int nnz;
  int64_t total_r;
};

static __device__ __forceinline__ bool union_want(const WinQuery& Q, int w) {
  return w < Q.nwin_first ? Q.want_first : Q.want_second;
}

static __device__ __forceinline__ uint64_t union_key(const WinQuery& Q,
                                                     uint64_t ts) {
  return Q.desc ? ~ts : ts;
}

__global__ void __launch_bounds__(UNION_THREADS, 1)
    index_union_kernel(WinLevels L, WinQuery Q,
                       uint8_t* __restrict__ out_valid,
                       uint64_t* __restrict__ out_lo,
                       uint64_t* __restrict__ out_hi) {
  extern __shared__ uint64_t keys[];
  __shared__ UnionShared S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwin = Q.nwin;
  const int64_t k = Q.k;
  PHASE_MARK(0);

  // 1. Each window's bounds, a warp a window; the key of a wanted
  //    window's k-th candidate where all k have a key below U64_MAX.
  for (int w = warp; w < nwin; w += UNION_THREADS / 32) {
    const WinDesc d = window_desc(L, w, Q);
    if (lane == 0) {
      const bool want = union_want(Q, w);
      S.bound[w] = d.bound;
      S.m[w] = d.m;
      S.r[w] = want ? d.r : 0;
      S.kth[w] = want && d.r == k
                     ? union_key(Q, L.c[w][IX_TS][win_pos(Q, d.bound, k - 1)])
                     : IX_SENT;
    }
  }
  __syncthreads();
  PHASE_MARK(1);

  // 2. The prune key (U64_MAX: none), then each wanted window's merged
  //    prefix: its keys at or below it.
  uint64_t cut = IX_SENT;
  for (int w = lane; w < nwin; w += 32) cut = S.kth[w] < cut ? S.kth[w] : cut;
  for (int o = 16; o; o >>= 1) {
    const uint64_t v = __shfl_xor_sync(0xffffffffu, cut, o);
    cut = v < cut ? v : cut;
  }
  for (int w = warp; w < nwin; w += UNION_THREADS / 32) {
    const int64_t r = S.r[w], bound = S.bound[w];
    int64_t lo = 0, hi = r;
    while (cut != IX_SENT && lo < hi) {  // first i with key > cut, 32-ary
      const int64_t step = (hi - lo + 31) >> 5;
      const int64_t p = lo + (lane + 1) * step - 1;
      const bool before =
          p < hi && union_key(Q, L.c[w][IX_TS][win_pos(Q, bound, p)]) <= cut;
      const int cnt = __popc(__ballot_sync(0xffffffffu, before));
      const int64_t top = lo + (cnt + 1) * step - 1;
      lo += cnt * step;
      if (top < hi) hi = top;
    }
    if (lane == 0) S.c[w] = cut == IX_SENT ? r : lo;
  }
  __syncthreads();
  PHASE_MARK(2);

  // 3. Offsets of the staged keys and of the tail, and the windows with a
  //    merged prefix (warp 0, a scan over at most 64 windows, two a lane).
  if (warp == 0) {
    int64_t cs[2], ts_[2];
    for (int h = 0; h < 2; ++h) {
      const int w = 2 * lane + h;
      cs[h] = w < nwin ? S.c[w] : 0;
      ts_[h] = w < nwin ? k - S.r[w] : 0;
    }
    int64_t a = cs[0] + cs[1], b = ts_[0] + ts_[1], rr = 0;
    for (int w = lane; w < nwin; w += 32) rr += S.r[w];
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t av = __shfl_up_sync(0xffffffffu, a, o);
      const int64_t bv = __shfl_up_sync(0xffffffffu, b, o);
      if (lane >= o) a += av, b += bv;
      rr += __shfl_xor_sync(0xffffffffu, rr, o);
    }
    const int64_t a0 = a - cs[0] - cs[1], b0 = b - ts_[0] - ts_[1];
    S.off[2 * lane] = a0;
    S.tail[2 * lane] = b0;
    S.off[2 * lane + 1] = a0 + cs[0];
    S.tail[2 * lane + 1] = b0 + ts_[0];
    if (lane == 31) S.off[WIN_MAX] = a, S.tail[WIN_MAX] = b;
    if (lane == 0) S.total_r = rr;
    int before = 0;
    for (int base = 0; base < WIN_MAX; base += 32) {
      const int w = base + lane;
      const bool has = w < nwin && S.c[w] > 0;
      const unsigned bal = __ballot_sync(0xffffffffu, has);
      if (has) S.nz[before + __popc(bal & ((1u << lane) - 1))] = w;
      before += __popc(bal);
    }
    if (lane == 0) S.nnz = before;
  }
  __syncthreads();
  PHASE_MARK(3);
  const int nnz = S.nnz;
  const int64_t n_staged = S.off[nwin];
  const bool staged = n_staged <= UNION_STAGE_MAX;
  uint64_t* tids = keys + UNION_STAGE_MAX;  // tid_lo, tid_hi of each entry

  // The window of a flat index into offsets `o` (o[0] = 0).
  auto window_of = [&](const int64_t* o, int64_t x) {
    int lo = 0, hi = nwin - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (o[mid] <= x) lo = mid; else hi = mid - 1;
    }
    return lo;
  };

  // 4. Stage the merged prefixes' entries, key and tid, two a thread with
  //    their loads in flight together (past UNION_STAGE_MAX entries they
  //    are read from the levels); each prefix's first and last key.
  if (staged) {
    for (int64_t e0 = threadIdx.x; e0 < n_staged; e0 += 2 * UNION_THREADS) {
      uint64_t ts[2], lo[2], hi[2];
      int ws[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int64_t e = e0 + u * UNION_THREADS;
        if (e < n_staged) {
          const int w = ws[u] = window_of(S.off, e);
          const int64_t p = win_pos(Q, S.bound[w], e - S.off[w]);
          ts[u] = L.c[w][IX_TS][p];
          lo[u] = L.c[w][IX_TID_LO][p];
          hi[u] = L.c[w][IX_TID_HI][p];
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int64_t e = e0 + u * UNION_THREADS;
        if (e < n_staged) {
          const int w = ws[u];
          const uint64_t key = union_key(Q, ts[u]);
          keys[e] = key;
          tids[2 * e] = lo[u];
          tids[2 * e + 1] = hi[u];
          if (e == S.off[w]) S.first[w] = key;
          if (e == S.off[w + 1] - 1) S.last[w] = key;
        }
      }
    }
  } else if (threadIdx.x < nnz) {
    const int w = S.nz[threadIdx.x];
    const int64_t bound = S.bound[w];
    S.first[w] = union_key(Q, L.c[w][IX_TS][win_pos(Q, bound, 0)]);
    S.last[w] = union_key(Q, L.c[w][IX_TS][win_pos(Q, bound, S.c[w] - 1)]);
  }
  __syncthreads();
  PHASE_MARK(4);
  auto key_at = [&](int w, int64_t i) -> uint64_t {
    return staged ? keys[S.off[w] + i]
                  : union_key(Q, L.c[w][IX_TS][win_pos(Q, S.bound[w], i)]);
  };

  // 5. Each merged entry to its position below k: its index, plus the keys
  //    of each other window before it (<= its key in an earlier window, <
  //    it in a later one; a window whose first key is not before it, or
  //    whose last key is, counted without a search).
  for (int64_t e = threadIdx.x; e < n_staged; e += UNION_THREADS) {
    const int w = window_of(S.off, e);
    const int64_t i = e - S.off[w];
    const uint64_t key = key_at(w, i);
    int64_t pos = i;
    for (int y = 0; y < nnz && pos < k; ++y) {
      const int v = S.nz[y];
      if (v == w) continue;
      const bool le = v < w;
      auto before = [&](uint64_t x) { return le ? x <= key : x < key; };
      if (!before(S.first[v])) continue;
      const int64_t cv = S.c[v];
      if (before(S.last[v])) {
        pos += cv;
        continue;
      }
      int64_t lo = 1, hi = cv - 1;  // first index not before, in [1, cv - 1]
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (before(key_at(v, mid))) lo = mid + 1; else hi = mid;
      }
      pos += lo;
    }
    if (pos < k) {
      const int64_t p = win_pos(Q, S.bound[w], i);
      out_valid[pos] = 1;
      out_lo[pos] = staged ? tids[2 * e] : L.c[w][IX_TID_LO][p];
      out_hi[pos] = staged ? tids[2 * e + 1] : L.c[w][IX_TID_HI][p];
    }
  }

#ifdef TB_PHASE_CLOCK
  __syncthreads();  // the ranks' end, not thread 0's
#endif
  PHASE_MARK(5);

  // 6. The tail: from position total_r, each window's candidates with key
  //    U64_MAX in concatenation order, until position k.
  for (int w = 0; w < nwin; ++w) {
    const int64_t start = S.total_r + S.tail[w];
    if (start >= k) break;
    const int64_t end = start + (S.tail[w + 1] - S.tail[w]) < k
                            ? start + (S.tail[w + 1] - S.tail[w])
                            : k;
    const int64_t r = S.r[w], m = S.m[w], bound = S.bound[w];
    const bool want = union_want(Q, w);
    for (int64_t pos = start + threadIdx.x; pos < end;
         pos += UNION_THREADS) {
      const int64_t i = r + (pos - start);
      uint8_t valid = 0;
      uint64_t lo = 0, hi = 0;
      if (i < m) {
        const int64_t p = win_pos(Q, bound, i);
        valid = want && L.c[w][IX_TS][p] != IX_SENT;
        lo = L.c[w][IX_TID_LO][p];
        hi = L.c[w][IX_TID_HI][p];
      }
      out_valid[pos] = valid;
      out_lo[pos] = lo;
      out_hi[pos] = hi;
    }
  }
#ifdef TB_PHASE_CLOCK
  __syncthreads();  // the block's end, not thread 0's
#endif
  PHASE_MARK(6);
}

PHASE_CLOCK_ENTRIES(tb_index_query_phases)

static int pack_levels(WinLevels* L, const void* const* cols,
                       const int64_t* ns, int nwin) {
  if (nwin < 1 || nwin > WIN_MAX) return (int)cudaErrorInvalidValue;
  for (int w = 0; w < nwin; ++w) {
    for (int c = 0; c < 5; ++c) L->c[w][c] = (const uint64_t*)cols[5 * w + c];
    L->n[w] = ns[w];
    if (ns[w] < 1) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// `cols`: nwin x 5 level column pointers; `ns`: nwin level lengths; the
// outputs hold nwin x k entries, window after window.
extern "C" int tb_index_window(const void* const* cols, const int64_t* ns,
                               int nwin, uint64_t acct_lo, uint64_t acct_hi,
                               uint64_t ts_min, uint64_t ts_max, int64_t k,
                               int desc, void* out_ts, void* out_lo,
                               void* out_hi, void* stream) {
  WinLevels L;
  int err = pack_levels(&L, cols, ns, nwin);
  if (err || k < 1) return err ? err : (int)cudaErrorInvalidValue;
  const WinQuery Q{acct_lo, acct_hi, ts_min, ts_max, k, desc, nwin, nwin,
                   1, 1};
  const int64_t bx = (k + WIN_THREADS - 1) / WIN_THREADS;
  index_window_kernel<<<dim3((unsigned)bx, (unsigned)nwin), WIN_THREADS, 0,
                        (cudaStream_t)stream>>>(
      L, Q, (uint64_t*)out_ts, (uint64_t*)out_lo, (uint64_t*)out_hi);
  return (int)cudaGetLastError();
}

// The query's k results (valid, tid_lo, tid_hi) from the windows of one or
// two sides (the first nwin_first windows are the first side's), in one
// launch.
extern "C" int tb_index_union(const void* const* cols, const int64_t* ns,
                              int nwin, int nwin_first, int want_first,
                              int want_second, uint64_t acct_lo,
                              uint64_t acct_hi, uint64_t ts_min,
                              uint64_t ts_max, int64_t k, int desc,
                              void* out_valid, void* out_lo, void* out_hi,
                              void* stream) {
  WinLevels L;
  int err = pack_levels(&L, cols, ns, nwin);
  if (err || k < 1 || nwin_first < 0 || nwin_first > nwin)
    return err ? err : (int)cudaErrorInvalidValue;
  const size_t smem = 3 * UNION_STAGE_MAX * sizeof(uint64_t);
  // Once a device: the shared memory past 48 KB.
  static bool opted[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64 || !opted[dev]) {
    e = cudaFuncSetAttribute(index_union_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 0 && dev < 64) opted[dev] = true;
  }
  const WinQuery Q{acct_lo, acct_hi, ts_min, ts_max, k, desc, nwin,
                   nwin_first, want_first, want_second};
  index_union_kernel<<<1, UNION_THREADS, smem, (cudaStream_t)stream>>>(
      L, Q, (uint8_t*)out_valid, (uint64_t*)out_lo, (uint64_t*)out_hi);
  return (int)cudaGetLastError();
}

// What the compiler and the card make of the two launches: for window
// mode (out[0..2]) and union mode (out[3..5]): registers a thread, local
// memory a thread in bytes (spills and stack), threads a block; out[6] the
// union's shared memory a block in bytes (static and dynamic).
extern "C" int tb_index_window_info(int* out) {
  cudaFuncAttributes a, u;
  cudaError_t err = cudaFuncGetAttributes(&a, (const void*)index_window_kernel);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&u, (const void*)index_union_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = WIN_THREADS;
  out[3] = u.numRegs;
  out[4] = (int)u.localSizeBytes;
  out[5] = UNION_THREADS;
  out[6] = (int)(u.sharedSizeBytes + 3 * UNION_STAGE_MAX * sizeof(uint64_t));
  return 0;
}
