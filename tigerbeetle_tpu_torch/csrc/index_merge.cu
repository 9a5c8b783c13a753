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
// credit sides).  A block owns MERGE_TILE outputs of one pair: warps 0 and
// 1 find the tile's two merge-path splits at once, each by a 32-ary search
// over device memory (a lane a probe, about five steps at 2^25); the block
// stages all five columns of the tile's A and B ranges in shared memory
// with cp.async; each thread finds its own split there by binary search
// and merges MERGE_ITEMS outputs into a list of staged positions; then the
// block writes each column of the tile back in order, a warp's stores
// contiguous.
//
// The full builds move only live entries.  A sorted run ends in the
// entries whose key is the sentinel key (every non-live entry, and any live
// one whose key is that key), and a stable merge of two runs is the merge
// of their prefixes, then A's tail, then B's.  So a build's rounds merge
// the prefixes alone (`prefix` mode: the first round finds each chunk's
// prefix by a warp's search and keeps it; each round writes its runs'
// prefix lengths for the next), and `tb_run_merge_tail` writes the level's
// tail once at the end: every chunk's tail in chunk order, which is the
// sentinel-keyed entries in position order, as the stable sort has them.
//
// What bounds it on the H100: bytes.  Each entry is read once (40 B) and
// written once (40 B) a round; a build's rounds read and write the live
// entries only, and its tail is written once.
#include "index_common.cuh"

#define MERGE_TILE 2048
#define MERGE_THREADS 256
#define MERGE_ITEMS (MERGE_TILE / MERGE_THREADS)
#define TAIL_THREADS 256
#define SCAN_THREADS 1024

struct MergeJob {
  const uint64_t* a[5];
  const uint64_t* b[5];
  uint64_t* o[5];
  int64_t la, lb, npairs, stride_a, stride_b, stride_o;
  const int64_t* pin;  // prefix mode: the input runs' prefixes (null: search)
  int64_t* pout;       // prefix mode: the output runs' prefixes
  int64_t* pchunk;     // the searched input prefixes, kept for the tail
};

struct MergeJobs {
  MergeJob j[2];
};

static __device__ __forceinline__ bool is_sent(uint64_t hi, uint64_t lo,
                                               uint64_t ts) {
  return (hi & lo & ts) == IX_SENT;
}

// The first index of a sorted run of `n` whose key is the sentinel key (n
// if none): a 32-ary search by one warp, every lane returning it.
static __device__ __forceinline__ int64_t warp_prefix(const uint64_t* hi,
                                                      const uint64_t* lo,
                                                      const uint64_t* ts,
                                                      int64_t n) {
  const int lane = threadIdx.x & 31;
  int64_t l = 0, h = n;
  while (l < h) {
    const int64_t step = (h - l + 31) / 32;
    const int64_t i = l + (int64_t)(lane + 1) * step - 1;
    const bool p = i >= h || is_sent(hi[i], lo[i], ts[i]);
    const unsigned m = __ballot_sync(0xffffffffu, p);
    const int f = __ffs(m) - 1;  // lane 31's probe is at or past h - 1
    if (f < 0) return h;
    const int64_t at = l + (int64_t)(f + 1) * step - 1;
    l = l + (int64_t)f * step;
    h = at < h ? at : h;
  }
  return l;
}

// The merge-path split of diagonal d (how many of the stable merge's first
// d outputs come from A) over device memory: a 32-ary search by one warp,
// every lane returning it.  The predicate B[d-1-i] < A[i] is false, then
// true, over i in [max(0, d-nb), min(d, na)).
static __device__ __forceinline__ int64_t warp_split(const uint64_t* const* a,
                                                     const uint64_t* const* b,
                                                     int64_t na, int64_t nb,
                                                     int64_t d) {
  const int lane = threadIdx.x & 31;
  int64_t l = d > nb ? d - nb : 0, h = d < na ? d : na;
  while (l < h) {
    const int64_t step = (h - l + 31) / 32;
    const int64_t i = l + (int64_t)(lane + 1) * step - 1;
    bool p = true;
    if (i < h) {
      const int64_t j = d - 1 - i;
      p = ix_less(IxKey{b[IX_ACCT_HI][j], b[IX_ACCT_LO][j], b[IX_TS][j]},
                  IxKey{a[IX_ACCT_HI][i], a[IX_ACCT_LO][i], a[IX_TS][i]});
    }
    const unsigned m = __ballot_sync(0xffffffffu, p);
    const int f = __ffs(m) - 1;
    if (f < 0) return h;
    const int64_t at = l + (int64_t)(f + 1) * step - 1;
    l = l + (int64_t)f * step;
    h = at < h ? at : h;
  }
  return l;
}

static __device__ __forceinline__ void cp_async8(void* smem_dst,
                                                 const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src)
               : "memory");
}

static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__global__ void __launch_bounds__(MERGE_THREADS)
    run_merge_kernel(const __grid_constant__ MergeJobs jobs) {
  extern __shared__ uint64_t s_col[];  // 5 x MERGE_TILE, then the order
  uint16_t* s_ord = reinterpret_cast<uint16_t*>(s_col + 5 * MERGE_TILE);
  __shared__ int64_t s_len[2], s_split[2];
  const MergeJob& J = jobs.j[blockIdx.y];
  const int64_t tiles = (J.la + J.lb + MERGE_TILE - 1) / MERGE_TILE;
  if (tiles == 0) return;
  const int64_t pair = blockIdx.x / tiles;
  if (pair >= J.npairs) return;
  const int64_t d0 = (blockIdx.x % tiles) * MERGE_TILE;
  const uint64_t* a[5];
  const uint64_t* b[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    a[c] = J.a[c] + pair * J.stride_a;
    b[c] = J.b[c] + pair * J.stride_b;
  }
  const int warp = threadIdx.x >> 5;
  if (J.pout != nullptr && J.pin == nullptr) {
    if (warp < 2) {
      const int64_t p = warp_prefix(warp ? b[IX_ACCT_HI] : a[IX_ACCT_HI],
                                    warp ? b[IX_ACCT_LO] : a[IX_ACCT_LO],
                                    warp ? b[IX_TS] : a[IX_TS],
                                    warp ? J.lb : J.la);
      if ((threadIdx.x & 31) == 0) s_len[warp] = p;
    }
    __syncthreads();
  } else if (threadIdx.x == 0) {
    s_len[0] = J.pout ? J.pin[2 * pair] : J.la;
    s_len[1] = J.pout ? J.pin[2 * pair + 1] : J.lb;
  }
  __syncthreads();
  const int64_t na_all = s_len[0], nb_all = s_len[1];
  const int64_t total = na_all + nb_all;
  if (d0 == 0 && threadIdx.x == 0 && J.pout != nullptr) {
    J.pout[pair] = total;
    if (J.pin == nullptr && J.pchunk != nullptr) {
      J.pchunk[2 * pair] = na_all;
      J.pchunk[2 * pair + 1] = nb_all;
    }
  }
  if (d0 >= total) return;
  const int64_t d1 = d0 + MERGE_TILE < total ? d0 + MERGE_TILE : total;
  if (warp < 2) {
    const int64_t d = warp ? d1 : d0;
    const int64_t s = d == 0 ? 0 : d == total ? na_all
                                              : warp_split(a, b, na_all,
                                                           nb_all, d);
    if ((threadIdx.x & 31) == 0) s_split[warp] = s;
  }
  __syncthreads();
  const int64_t i0 = s_split[0], j0 = d0 - s_split[0];
  const int na = (int)(s_split[1] - i0), nb = (int)((d1 - s_split[1]) - j0);
  const int n = na + nb;
  // Stage the tile's A range, then its B range, all five columns.
#pragma unroll
  for (int k = 0; k < MERGE_ITEMS; ++k) {
    const int e = threadIdx.x + k * MERGE_THREADS;
    if (e < n) {
      const bool from_a = e < na;
      const int64_t g = from_a ? i0 + e : j0 + (e - na);
#pragma unroll
      for (int c = 0; c < 5; ++c)
        cp_async8(s_col + c * MERGE_TILE + e, (from_a ? a[c] : b[c]) + g);
    }
  }
  cp_async_wait();
  __syncthreads();
  const uint64_t* s_hi = s_col + IX_ACCT_HI * MERGE_TILE;
  const uint64_t* s_lo = s_col + IX_ACCT_LO * MERGE_TILE;
  const uint64_t* s_ts = s_col + IX_TS * MERGE_TILE;
  const int ld = threadIdx.x * MERGE_ITEMS;
  if (ld < n) {
    // This thread's split inside the tile (B staged after A's na entries).
    const int lo = merge_split<int>(na, nb, ld, [&](int i, int j) {
      return ix_less(IxKey{s_hi[na + j], s_lo[na + j], s_ts[na + j]},
                     IxKey{s_hi[i], s_lo[i], s_ts[i]});
    });
    int ia = lo, ib = ld - lo;
#pragma unroll
    for (int it = 0; it < MERGE_ITEMS; ++it) {
      if (ld + it >= n) break;
      bool take_a;
      if (ib >= nb) {
        take_a = true;
      } else if (ia >= na) {
        take_a = false;
      } else {
        take_a = !ix_less(IxKey{s_hi[na + ib], s_lo[na + ib], s_ts[na + ib]},
                          IxKey{s_hi[ia], s_lo[ia], s_ts[ia]});
      }
      s_ord[ld + it] = (uint16_t)(take_a ? ia++ : na + ib++);
    }
  }
  __syncthreads();
  const int64_t out0 = pair * J.stride_o + d0;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    uint64_t* o = J.o[c] + out0;
    const uint64_t* s = s_col + c * MERGE_TILE;
#pragma unroll
    for (int k = 0; k < MERGE_ITEMS; ++k) {
      const int e = threadIdx.x + k * MERGE_THREADS;
      if (e < n) o[e] = s[s_ord[e]];
    }
  }
}

static const size_t MERGE_SMEM =
    5 * MERGE_TILE * sizeof(uint64_t) + MERGE_TILE * sizeof(uint16_t);

// `cols`: jobs x 15 pointers (A's five columns, B's, the output's);
// `sizes`: jobs x 6 int64 (la, lb, npairs, stride_a, stride_b, stride_o);
// `prefix`: null, or jobs x 3 pointers (pin, pout, pchunk): with pout, the
// pairs' live prefixes alone are merged (pin null: found by search, and
// kept in pchunk when given).
extern "C" int tb_run_merge(const void* const* cols, const int64_t* sizes,
                            const void* const* prefix, int jobs,
                            void* stream) {
  if (jobs < 1 || jobs > 2) return (int)cudaErrorInvalidValue;
  // The shared-memory opt-in holds for the current device only.
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64 || !opted[dev]) {
    e = cudaFuncSetAttribute(
        run_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)MERGE_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 0 && dev < 64) opted[dev] = true;
  }
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
    J.pin = prefix ? (const int64_t*)prefix[3 * j] : nullptr;
    J.pout = prefix ? (int64_t*)prefix[3 * j + 1] : nullptr;
    J.pchunk = prefix ? (int64_t*)prefix[3 * j + 2] : nullptr;
    if (J.la < 0 || J.lb < 0 || J.npairs < 0 ||
        (J.pout == nullptr && (J.pin || J.pchunk)))
      return (int)cudaErrorInvalidValue;
    const int64_t tiles = (J.la + J.lb + MERGE_TILE - 1) / MERGE_TILE;
    if (tiles * J.npairs > blocks) blocks = tiles * J.npairs;
  }
  if (blocks == 0) return 0;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  run_merge_kernel<<<dim3((unsigned)blocks, (unsigned)jobs), MERGE_THREADS,
                     MERGE_SMEM, (cudaStream_t)stream>>>(m);
  return (int)cudaGetLastError();
}

// -- a full build's tail ------------------------------------------------------

struct TailJob {
  const uint64_t* src[5];  // K13's sorted chunks
  uint64_t* dst[5];        // the merged level (its prefix written)
  const int64_t* pchunk;   // each chunk's prefix
  const int64_t* pfinal;   // the level's prefix
  int64_t* off;            // scratch: each chunk's tail offset
  int64_t chunks, chunk;
};

struct TailJobs {
  TailJob j[2];
};

// Each chunk's offset in the level's tail: an exclusive scan of the chunks'
// tail lengths, one block a job.
__global__ void __launch_bounds__(SCAN_THREADS)
    run_merge_scan_kernel(const __grid_constant__ TailJobs jobs) {
  __shared__ int64_t red[32];
  const TailJob& J = jobs.j[blockIdx.x];
  const int64_t per = (J.chunks + SCAN_THREADS - 1) / SCAN_THREADS;
  const int64_t c0 = threadIdx.x * per;
  const int64_t c1 = c0 + per < J.chunks ? c0 + per : J.chunks;
  int64_t mine = 0;
  for (int64_t c = c0; c < c1; ++c) mine += J.chunk - J.pchunk[c];
  // Block-wide exclusive scan of `mine`: warps, then the warps' sums.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int64_t w = red[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    red[lane] = w;
  }
  __syncthreads();
  int64_t run = (warp ? red[warp - 1] : 0) + incl - mine;
  for (int64_t c = c0; c < c1; ++c) {
    J.off[c] = run;
    run += J.chunk - J.pchunk[c];
  }
}

// A block a chunk: its tail's entries go to the level's tail at the
// chunk's offset; their keys are the sentinel key, their ids copied.
__global__ void __launch_bounds__(TAIL_THREADS)
    run_merge_tail_kernel(const __grid_constant__ TailJobs jobs) {
  const TailJob& J = jobs.j[blockIdx.y];
  const int64_t c = blockIdx.x;
  if (c >= J.chunks) return;
  const int64_t p = J.pchunk[c];
  const int64_t base = *J.pfinal + J.off[c] - p;
  for (int64_t r = p + threadIdx.x; r < J.chunk; r += TAIL_THREADS) {
    const int64_t g = c * J.chunk + r, out = base + r;
    J.dst[IX_ACCT_LO][out] = IX_SENT;
    J.dst[IX_ACCT_HI][out] = IX_SENT;
    J.dst[IX_TS][out] = IX_SENT;
    J.dst[IX_TID_LO][out] = J.src[IX_TID_LO][g];
    J.dst[IX_TID_HI][out] = J.src[IX_TID_HI][g];
  }
}

// `cols`: jobs x 10 pointers (the chunks' five columns, the level's);
// `sizes`: jobs x 2 int64 (chunks, chunk); `prefix`: jobs x 2 pointers
// (pchunk, pfinal); `off`: jobs x chunks int64 of scratch.
extern "C" int tb_run_merge_tail(const void* const* cols,
                                 const int64_t* sizes,
                                 const void* const* prefix, int jobs,
                                 void* off, void* stream) {
  if (jobs < 1 || jobs > 2 || off == nullptr) return (int)cudaErrorInvalidValue;
  TailJobs m;
  int64_t most = 0;
  for (int j = 0; j < jobs; ++j) {
    TailJob& J = m.j[j];
    for (int c = 0; c < 5; ++c) {
      J.src[c] = (const uint64_t*)cols[10 * j + c];
      J.dst[c] = (uint64_t*)cols[10 * j + 5 + c];
    }
    J.chunks = sizes[2 * j];
    J.chunk = sizes[2 * j + 1];
    J.pchunk = (const int64_t*)prefix[2 * j];
    J.pfinal = (const int64_t*)prefix[2 * j + 1];
    J.off = (int64_t*)off + (int64_t)j * sizes[0];
    if (J.chunks < 1 || J.chunk < 1 || J.chunks != sizes[0] ||
        J.chunks > 0x7FFFFFFF || J.pchunk == nullptr || J.pfinal == nullptr)
      return (int)cudaErrorInvalidValue;
    if (J.chunks > most) most = J.chunks;
  }
  run_merge_scan_kernel<<<jobs, SCAN_THREADS, 0, (cudaStream_t)stream>>>(m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  run_merge_tail_kernel<<<dim3((unsigned)most, (unsigned)jobs), TAIL_THREADS,
                          0, (cudaStream_t)stream>>>(m);
  return (int)cudaGetLastError();
}
