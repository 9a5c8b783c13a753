// K16 history_scan: get_account_history's masked scan of the history log,
// its top k and its side-selected gather.
//
// Replaces tigerbeetle_tpu/ops/query.py:38 `scan_history` with :29 `_top_k`
// (an argsort of the whole log).  A slot's key is ts (descending) or ~ts
// (ascending) where it matches: below `count`, the account on a wanted
// side, ts_min <= ts <= ts_max; else 0.  The result is the k slots of
// largest (key, slot), largest first, with valid = key != 0; past the
// matches that is the other slots, highest slot first.  A row's balances
// are its debit side's when the account is its debit account (and debits
// are wanted), else its credit side's, for a match and a non-match alike.
//
// The top k needs no sort: the log below `count` carries strictly
// increasing timestamps (every commit path appends in lane order, and a
// rolled-back chain pops `count`), so the matches in slot order have
// monotone keys.  With r the matches below slot s and m all of them, a
// match goes to position m-1-r (descending) or r (ascending), a non-match
// to cap-1-s+r (r = m for the slots at and above `count`).
//
// Design: one cooperative launch of the blocks the card holds; each
// block owns a contiguous range of the 32-slot words below `count`.
//  A. Each warp reads the low words of the two side ids and the timestamp
//     of 32 slots at a time (two such words in flight), the high words only
//     where a low word matches, checks that the timestamps increase (across
//     the range's edge too), and writes its ballot of matches as one word of
//     a bitmap; the block writes its match count and whether its range
//     failed the check.
//  -- one grid barrier --
//  B. Each block sums the counts before it (r) and all of them (m); block 0
//     writes the error word (so no memset is made).
//  C. A block whose matches or non-matches can land below k walks its
//     bitmap words (a scan of their popcounts gives each bit its r) and
//     places those rows; when m < k, the slots at and above `count` fill
//     the positions after the matches, highest first.  Only the at most k
//     placed rows are read beyond phase A, and nothing at or above `count`
//     is read but the placed rows.
// The wrapper raises when the error word is set: the answer is the plain
// version's or none.
//
// What bounds it on the H100: bytes, 24 a row below count (two side ids'
// low words and the timestamp), once.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define HS_THREADS 256
#define HS_WARPS (HS_THREADS / 32)
#define HS_UNROLL 2  // a warp's bitmap words in flight at once

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
  int64_t* block_count;  // [grid]
  int64_t* block_err;    // [grid]
  uint32_t* bitmap;      // [(cap + 31) / 32]
  int* err;
  uint8_t* out_valid;
  uint64_t* rows[9];
};

static __device__ __forceinline__ bool hs_flag(const HistQuery& q, int64_t s,
                                               uint64_t dr_lo, uint64_t cr_lo,
                                               uint64_t ts) {
  const bool is_dr = q.want_dr && dr_lo == q.acct_lo &&
                     q.c[H_DR_ID_HI][s] == q.acct_hi;
  const bool is_cr = q.want_cr && cr_lo == q.acct_lo &&
                     q.c[H_CR_ID_HI][s] == q.acct_hi;
  const uint64_t key = q.desc ? ts : ~ts;
  return (is_dr || is_cr) && ts >= q.ts_min && ts <= q.ts_max && key != 0;
}

// Writes result position `pos` from slot s.
static __device__ void hs_place(const HistQuery& q, int64_t s, int64_t pos,
                                bool match) {
  const uint64_t dlo = q.c[H_DR_ID_LO][s], dhi = q.c[H_DR_ID_HI][s];
  const uint64_t ts = q.c[H_TS][s];
  const bool is_dr = q.want_dr && dlo == q.acct_lo && dhi == q.acct_hi;
  const int side = is_dr ? H_DR_BAL : H_CR_BAL;
  uint64_t v[8];
#pragma unroll
  for (int f = 0; f < 8; ++f) v[f] = q.c[side + f][s];
  q.out_valid[pos] = match ? 1 : 0;
  q.rows[0][pos] = ts;
#pragma unroll
  for (int f = 0; f < 8; ++f) q.rows[1 + f][pos] = v[f];
}

// Block-wide sums of (a, b) over the threads, to every thread.
static __device__ void block_sum2(int64_t* a, int64_t* b, int64_t* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t x = *a, y = *b;
  for (int o = 16; o; o >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, o);
    y += __shfl_xor_sync(0xffffffffu, y, o);
  }
  __syncthreads();
  if (lane == 0) {
    sh[warp] = x;
    sh[HS_WARPS + warp] = y;
  }
  __syncthreads();
  x = y = 0;
  for (int w = 0; w < HS_WARPS; ++w) {
    x += sh[w];
    y += sh[HS_WARPS + w];
  }
  *a = x;
  *b = y;
}

__global__ void __launch_bounds__(HS_THREADS)
    history_scan_kernel(const __grid_constant__ HistQuery q) {
  __shared__ int64_t sh[2 * HS_WARPS];
  __shared__ int64_t wsum[HS_WARPS];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t G = gridDim.x, b = blockIdx.x;
  int64_t count = *q.count;
  count = count < 0 ? 0 : (count > q.cap ? q.cap : count);
  const int64_t words = (count + 31) / 32;
  const int64_t per = (words + G - 1) / G;
  const int64_t w0 = b * per < words ? b * per : words;
  const int64_t w1 = w0 + per < words ? w0 + per : words;

  // -- A: the match bitmap, the block's count and its order check ---------
  int64_t cnt = 0, bad = 0;
  for (int64_t wb = w0 + (int64_t)warp * HS_UNROLL; wb < w1;
       wb += (int64_t)HS_WARPS * HS_UNROLL) {
    uint64_t dlo[HS_UNROLL], clo[HS_UNROLL], ts[HS_UNROLL], nxt[HS_UNROLL];
#pragma unroll
    for (int u = 0; u < HS_UNROLL; ++u) {
      const int64_t s = (wb + u) * 32 + lane;
      const bool in = wb + u < w1 && s < count;
      dlo[u] = in ? q.c[H_DR_ID_LO][s] : 0;
      clo[u] = in ? q.c[H_CR_ID_LO][s] : 0;
      ts[u] = in ? q.c[H_TS][s] : 0;
      const int64_t sn = (wb + u) * 32 + 32;  // the slot after the word
      nxt[u] = (lane == 31 && wb + u < w1 && sn < count) ? q.c[H_TS][sn] : 0;
    }
#pragma unroll
    for (int u = 0; u < HS_UNROLL; ++u) {
      const int64_t s = (wb + u) * 32 + lane;
      const bool in = wb + u < w1 && s < count;
      uint64_t next = __shfl_down_sync(0xffffffffu, ts[u], 1);
      if (lane == 31) next = nxt[u];
      if (in && s + 1 < count && !(ts[u] < next)) bad = 1;
      const bool flag = in && hs_flag(q, s, dlo[u], clo[u], ts[u]);
      const unsigned word = __ballot_sync(0xffffffffu, flag);
      if (lane == 0 && wb + u < w1) q.bitmap[wb + u] = word;
      cnt += __popc(word);
    }
  }
  if (lane != 0) cnt = 0;  // a warp's count is its lane 0's
  block_sum2(&cnt, &bad, sh);
  const int64_t c_b = cnt;
  if (threadIdx.x == 0) {
    q.block_count[b] = c_b;
    q.block_err[b] = bad;
  }
  grid.sync();

  // -- B: the matches before this block's range, all of them, the error ---
  int64_t before = 0, m = 0, failed = 0, unused = 0;
  for (int64_t j = threadIdx.x; j < G; j += HS_THREADS) {
    const int64_t v = __ldcg((const long long*)q.block_count + j);
    m += v;
    before += j < b ? v : 0;
    failed += __ldcg((const long long*)q.block_err + j) != 0;
  }
  block_sum2(&before, &m, sh);
  if (b == 0) {
    block_sum2(&failed, &unused, sh);
    if (threadIdx.x == 0) *q.err = failed != 0;
  }

  // -- C: the rows placed below k ----------------------------------------
  const int64_t k = q.k, cap = q.cap;
  const int64_t s0 = w0 * 32, s1 = w1 * 32 < count ? w1 * 32 : count;
  const int64_t lo_rank = q.desc ? m - k : 0, hi_rank = q.desc ? m : k;
  const bool matches = c_b > 0 && before + c_b > lo_rank && before < hi_rank;
  // A non-match's position is at least cap - s1 + before.
  const bool fill = s1 - s0 > c_b && cap - s1 + before < k;
  if (matches || fill) {
    const int64_t nw = w1 - w0;
    const int64_t tpw = (nw + HS_THREADS - 1) / HS_THREADS;
    const int64_t a = w0 + threadIdx.x * tpw < w1 ? w0 + threadIdx.x * tpw : w1;
    const int64_t z = a + tpw < w1 ? a + tpw : w1;
    int64_t mine = 0;
    for (int64_t w = a; w < z; ++w) mine += __popc(__ldcg(q.bitmap + w));
    // Exclusive scan of `mine` over the block.
    int64_t inc = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t t = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += t;
    }
    if (lane == 31) wsum[warp] = inc;
    __syncthreads();
    int64_t r = before + inc - mine;
    for (int w = 0; w < warp; ++w) r += wsum[w];
    for (int64_t w = a; w < z; ++w) {
      const uint32_t word = __ldcg(q.bitmap + w);
      const int64_t sb = w * 32;
      if (matches) {
        for (uint32_t bits = word; bits; bits &= bits - 1) {
          const int bit = __ffs(bits) - 1;
          const int64_t rank = r + __popc(word & ((1u << bit) - 1));
          const int64_t pos = q.desc ? m - 1 - rank : rank;
          if (pos >= 0 && pos < k) hs_place(q, sb + bit, pos, true);
        }
      }
      if (fill) {
        const uint32_t live = sb + 32 <= count ? 0xffffffffu
                                               : (1u << (count - sb)) - 1;
        for (uint32_t bits = ~word & live; bits; bits &= bits - 1) {
          const int bit = __ffs(bits) - 1;
          const int64_t rank = r + __popc(word & ((1u << bit) - 1));
          const int64_t pos = cap - 1 - (sb + bit) + rank;
          if (pos < k) hs_place(q, sb + bit, pos, false);
        }
      }
      r += __popc(word);
    }
  }
  // The slots at and above count, highest first after the matches.
  if (m < k) {
    const int64_t lo = cap - (k - m) > count ? cap - (k - m) : count;
    for (int64_t s = lo + b * HS_THREADS + threadIdx.x; s < cap;
         s += G * HS_THREADS)
      hs_place(q, s, cap - 1 - s + m, false);
  }
}

// Blocks the current device holds at once of the kernel (kept a device).
static int hs_resident(int* resident) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 0 && dev < 64 && cached[dev] > 0) {
    *resident = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, history_scan_kernel, HS_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  *resident = sms * per_sm;
  if (dev >= 0 && dev < 64) cached[dev] = *resident;
  return 0;
}

// The launch's blocks for a log of `cap` slots (a block for each 1,024
// slots, at most what the card holds) and the scratch it needs, in int64
// words: two per block and the bitmap.
extern "C" int tb_history_scan_scratch(int64_t cap, int64_t* blocks,
                                       int64_t* words) {
  if (cap < 1) return (int)cudaErrorInvalidValue;
  int resident = 0;
  const int err = hs_resident(&resident);
  if (err) return err;
  int64_t g = (cap + 1023) / 1024;
  if (g > resident) g = resident;
  if (g < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks = g;
  *words = 2 * g + ((cap + 31) / 32 + 1) / 2;
  return 0;
}

// `cols`: the 21 history columns; `count`: the device count (int64[1]);
// `scratch`: int64[words] of tb_history_scan_scratch, for `blocks` blocks;
// `err`: int32[1], written 1 when the log's timestamps below count do not
// increase, else 0; `out_rows`: nine columns (timestamp, then the four
// balance fields lo/hi) of k entries.
extern "C" int tb_history_scan(const void* const* cols, const void* count,
                               int64_t cap, int64_t k, uint64_t acct_lo,
                               uint64_t acct_hi, uint64_t ts_min,
                               uint64_t ts_max, int want_dr, int want_cr,
                               int desc, void* scratch, int64_t blocks,
                               void* err, void* out_valid,
                               void* const* out_rows, void* stream) {
  if (cap < 1 || k < 1 || k > cap || blocks < 1)
    return (int)cudaErrorInvalidValue;
  HistQuery q;
  for (int c = 0; c < H_COLS; ++c) q.c[c] = (const uint64_t*)cols[c];
  q.count = (const int64_t*)count;
  q.cap = cap;
  q.k = k;
  q.acct_lo = acct_lo; q.acct_hi = acct_hi;
  q.ts_min = ts_min; q.ts_max = ts_max;
  q.want_dr = want_dr; q.want_cr = want_cr; q.desc = desc;
  q.block_count = (int64_t*)scratch;
  q.block_err = q.block_count + blocks;
  q.bitmap = (uint32_t*)(q.block_err + blocks);
  q.err = (int*)err;
  q.out_valid = (uint8_t*)out_valid;
  for (int f = 0; f < 9; ++f) q.rows[f] = (uint64_t*)out_rows[f];
  void* args[] = {&q};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)history_scan_kernel, dim3((unsigned)blocks),
      dim3(HS_THREADS), args, 0, (cudaStream_t)stream);
  // A refused launch leaves its error as the thread's last error too.
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}
