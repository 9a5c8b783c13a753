// K10 full_legs: exact running balances of all four account fields at every
// leg of a batch, and the apply's balance scatter.
//
// Replaces tigerbeetle_tpu/ops/transfer_full.py:266 `_leg_balances` (with
// :239 `_limbs_to_u128`) and the apply's account scatter at run tails,
// :1376-1386.
//
// Each event has a debit leg (2i) and a credit leg (2i+1).  Legs sorted by
// (account slot, leg position) put every account's legs together in event
// order, so sums of the legs' deltas within each slot run give each
// account's fields before (exclusive) and after (inclusive) every event.
// The six delta streams are the JAX function's: debits_pending added by a
// pending and released by a post or void (dp_add, dp_sub), debits_posted
// added by a regular transfer or a post (dpo_add), and the same three on
// the credit side; a leg's delta is 0 unless its lane was accepted by the
// previous Jacobi iterate (`ok`).  Per field, as in JAX:
//     added, ov = start + add;  val, neg = added - sub;  bad = ov | neg,
// at both the exclusive and the inclusive sums, and `arith_broken` is set
// when any live leg is bad.
//
// The JAX function splits each u64 delta into 16-bit parts and stacks a u32
// cumsum and cummax, for the TPU's vector memory; here the sums are exact
// unsigned __int128 segmented sums (a run of <= 2^14 u64 deltas stays
// under 2^78).
//
// The grid: one cooperative launch of ceil(2n / 128) blocks of LEG_THREADS
// = 128 threads (128 blocks on 128 of the H100's 132 SMs at 8,192 lanes),
// one sorted leg a thread.  The sorted keys come from the sort cache (K12's,
// or the previous pass's sort) when the legs' slots are those it sorted:
// each thread then loads its key, its lane's six inputs and its leg's start
// balances once (all loads issued together), and the block scans the six
// streams together (one segment head for all six) in shared memory; each
// block publishes its aggregate and whether any of its legs' slots differs
// from the cache's, and after ONE grid barrier folds the aggregates of the
// blocks before it into its carry (a run may span every block) and writes
// the four fields coalesced.  When the cache is stale (in-batch pending
// references change a post's accounts between passes; no cache on its
// own), the launch sorts on the whole card instead: the chunk sort of
// full_common.cuh (blocks 0..p/1,024-1 each sort a chunk of 1,024 keys, 8
// a thread in registers; a grid barrier; every block stages the sorted
// chunks, 128 KB at 16,384 legs, by cp.async and places its own keys by
// rank, four chunks' searches in lockstep; a grid barrier), refreshes the
// cache, and scans as above: three barriers more.  `arith_broken` is reset by one
// thread before the first barrier and set after the last by one store a
// warp whose live legs saw a bad field.
//
// In the Jacobi loop (full_pass.cu) the launch reads the loop's control
// words first and returns at once when the loop is over, so the host
// queues every pass without reading anything back.  A stats pair (when
// given) counts the launches that ran and those that sorted.
//
// What bounds it on the H100: latency: the lane inputs' dependent gathers,
// the block scans and one grid barrier (four when the cache is stale, with
// the chunk sorts' 55 compare-exchange steps and the merge's 15 binary
// searches a key); the bytes (about 2.6 MB in and out at 8,192 lanes)
// would take under 1 us at the card's 3.35 TB/s.
#include <cooperative_groups.h>

#include "full_common.cuh"
#include "phase_clock.cuh"

namespace cg = cooperative_groups;

#define LEG_THREADS 128
#define LEG_MAX_BLOCKS (FULL_MAX_LEGS / LEG_THREADS)  // 128
#define LEG_CHUNK 1024   // keys a block sorts when the cache is stale
static_assert(LEG_CHUNK == 8 * LEG_THREADS, "8 keys a thread in a chunk sort");
#define LEG_STREAMS 6
#define LEG_AGG_WORDS (2 * LEG_STREAMS + 1)  // a block's aggregate
static_assert((LEG_MAX_BLOCKS * LEG_AGG_WORDS) % 2 == 0,
              "the aggregates' 16-byte copies stay inside the array");

enum LegPtr {
  L_START,  // 8 leg-domain start balances: dp lo/hi, dpo, cp, cpo
  L_OK = L_START + 8, L_AMT, L_PAMT, L_DR_SLOT, L_CR_SLOT, L_DR_LIVE,
  L_CR_LIVE, L_PENDING, L_POST, L_POSTVOID,
  L_LEG_POS,
  L_VAL,  // 16 outputs: {dp, dpo, cp, cpo} x {pre, incl} x {lo, hi}
  L_S_SLOT = L_VAL + 16, L_S_LIVE, L_IS_LAST, L_ARITH,
  L_SCRATCH,  // int64 words: legs_scratch_words(n) in ops/_cuda.py
  L_STATS,    // uint64[2]: launches that ran, launches that sorted; or null
  L_CTRL, L_PROVED, L_NEEDED,
  L_CACHE_KEYS, L_CACHE_SLOT, L_CACHE_OK,  // the sort cache, or null
  L_NPTRS
};

#define LP(T, k) (static_cast<T*>(const_cast<void*>(a.p[k])))

// Six segmented sums with one head: (a head was seen, the sums since the
// last head).
struct Seg6 {
  u128 v[LEG_STREAMS];
  int head;
};

static __device__ __forceinline__ Seg6 seg6_zero() {
  Seg6 x;
#pragma unroll
  for (int s = 0; s < LEG_STREAMS; ++s) x.v[s] = 0;
  x.head = 0;
  return x;
}

static __device__ __forceinline__ Seg6 seg6_op(const Seg6& a, const Seg6& b) {
  Seg6 r;
#pragma unroll
  for (int s = 0; s < LEG_STREAMS; ++s) r.v[s] = b.head ? b.v[s] : a.v[s] + b.v[s];
  r.head = a.head | b.head;
  return r;
}

// Inclusive scan across the warp, in lane order.
static __device__ __forceinline__ Seg6 warp_scan6(Seg6 x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Seg6 t;
#pragma unroll
    for (int s = 0; s < LEG_STREAMS; ++s) t.v[s] = shfl_up_any(x.v[s], off);
    t.head = shfl_up_any(x.head, off);
    if (lane >= off) x = seg6_op(t, x);
  }
  return x;
}

// Leg j's slot (j in input order): its lane's debit (j even) or credit
// slot, `cap` when dead.
static __device__ __forceinline__ uint64_t leg_slot(const Ptrs& a, int j,
                                                    uint64_t cap) {
  const int i = j >> 1;
  const bool dr = (j & 1) == 0;
  const bool live = dr ? LP(const uint8_t, L_DR_LIVE)[i] != 0
                       : LP(const uint8_t, L_CR_LIVE)[i] != 0;
  return live ? (uint64_t)(dr ? LP(const int64_t, L_DR_SLOT)[i]
                              : LP(const int64_t, L_CR_SLOT)[i])
              : cap;
}

// Scratch (int64 words; ops/_cuda.py legs_scratch_words): the aggregates
// [LEG_MAX_BLOCKS][LEG_AGG_WORDS], the stale flags [LEG_MAX_BLOCKS], the
// sorted chunks [p] and, with no cache, the sorted keys [p].
struct LegScratch {
  uint64_t* agg;
  uint64_t* stale;
  uint64_t* chunks;
  uint64_t* keys;
};

static __device__ __forceinline__ LegScratch leg_scratch(const Ptrs& a,
                                                         int p) {
  LegScratch s;
  s.agg = LP(uint64_t, L_SCRATCH);
  s.stale = s.agg + LEG_MAX_BLOCKS * LEG_AGG_WORDS;
  s.chunks = s.stale + LEG_MAX_BLOCKS;
  s.keys = LP(uint64_t, L_CACHE_KEYS) ? LP(uint64_t, L_CACHE_KEYS)
                                      : s.chunks + p;
  return s;
}

// One sorted leg's work, from the key at position j to the block's scan.
struct Leg {
  uint64_t key, slot;
  int L;
  bool in, last;
  uint64_t d[LEG_STREAMS];
  u128 start[4];
  Seg6 incl;  // the block's inclusive scan at this leg
};

// Loads leg j's key (from `keys`, maybe written by this launch), its
// lane's inputs and its start balances, computes its six deltas, scans the
// block and stores the block's aggregate.  Every thread of the block calls
// it.
static __device__ Leg scan_leg(const Ptrs& a, const uint64_t* keys, int j,
                               int n2, bool has_pv, uint64_t* agg) {
  __shared__ Seg6 wsh[LEG_THREADS / 32];
  Leg g;
  g.in = j < n2;
  g.key = g.in ? ldcg_u64(keys, j) : 0;
  const uint64_t prev = g.in && j > 0 ? ldcg_u64(keys, j - 1) : ~0ull;
  const uint64_t next = g.in && j + 1 < n2 ? ldcg_u64(keys, j + 1) : ~0ull;
  g.slot = g.key >> 15;
  g.L = (int)(g.key & 0x7FFF);
  g.last = g.in && (j + 1 == n2 || (next >> 15) != g.slot);
  const int i = g.L >> 1;
  const bool dr = (g.L & 1) == 0;
  Seg6 x = seg6_zero();
  if (g.in) {
    const bool ok = LP(const uint8_t, L_OK)[i] != 0;
    const bool pend = LP(const uint8_t, L_PENDING)[i] != 0;
    const bool pv = LP(const uint8_t, L_POSTVOID)[i] != 0;
    const bool pst = LP(const uint8_t, L_POST)[i] != 0;
    const uint64_t amt = LP(const uint64_t, L_AMT)[i];
    const uint64_t pamt = LP(const uint64_t, L_PAMT)[i];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      g.start[f] = ((u128)LP(const uint64_t, L_START + 2 * f + 1)[g.L] << 64) |
                   LP(const uint64_t, L_START + 2 * f)[g.L];
    }
    const bool reg = !pend && !pv;
    const uint64_t add = ok && pend ? amt : 0;
    const uint64_t sub = ok && has_pv && pv ? pamt : 0;
    const uint64_t posted = ok && (reg || pst) ? amt : 0;
    g.d[0] = dr ? add : 0;
    g.d[1] = dr ? sub : 0;
    g.d[2] = dr ? posted : 0;
    g.d[3] = dr ? 0 : add;
    g.d[4] = dr ? 0 : sub;
    g.d[5] = dr ? 0 : posted;
#pragma unroll
    for (int s = 0; s < LEG_STREAMS; ++s) x.v[s] = g.d[s];
    x.head = j == 0 || (prev >> 15) != g.slot;
  } else {
#pragma unroll
    for (int s = 0; s < LEG_STREAMS; ++s) g.d[s] = 0;
#pragma unroll
    for (int f = 0; f < 4; ++f) g.start[f] = 0;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_scan6(x);
  if (lane == 31) wsh[warp] = x;
  __syncthreads();
  Seg6 pre = seg6_zero();
  for (int w = 0; w < warp; ++w) pre = seg6_op(pre, wsh[w]);
  g.incl = seg6_op(pre, x);
  if (threadIdx.x == blockDim.x - 1) {
    uint64_t* out = agg + blockIdx.x * LEG_AGG_WORDS;
#pragma unroll
    for (int s = 0; s < LEG_STREAMS; ++s) {
      out[2 * s] = (uint64_t)g.incl.v[s];
      out[2 * s + 1] = (uint64_t)(g.incl.v[s] >> 64);
    }
    out[2 * LEG_STREAMS] = (uint64_t)g.incl.head;
  }
  __syncthreads();  // wsh is reused by the next call
  return g;
}

// The stale sort's chunk at full size: 1,024 keys over the block's 128
// threads, 8 a thread in registers (thread t holds keys 8t..8t+7), through
// the bitonic network's 55 steps: the partner in the thread's own registers
// (j < 8), in another lane of the warp (8 <= j < 256: a shuffle), or in
// another warp (j = 256, 512: through shared memory, 3 of the 55 steps).
static __device__ __forceinline__ uint64_t cx(uint64_t mine, uint64_t other,
                                              int i, int j, int k) {
  const bool asc = (i & k) == 0, low = (i & j) == 0;
  return low == asc ? (mine < other ? mine : other)
                    : (mine < other ? other : mine);
}

template <int J>
static __device__ __forceinline__ void cx_regs(uint64_t (&v)[8], int t,
                                               int k) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if ((r & J) == 0) {
      const int i = 8 * t + r;
      const uint64_t a = v[r], b = v[r ^ J];
      if ((a > b) == ((i & k) == 0)) {
        v[r] = b;
        v[r ^ J] = a;
      }
    }
  }
}

template <class SlotOf>
static __device__ void sort_chunk_1024(uint64_t* sh, int c, int n2,
                                       SlotOf slot_of, uint64_t* chunks) {
  const int t = threadIdx.x;
  uint64_t v[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = c * LEG_CHUNK + 8 * t + r;
    v[r] = j < n2 ? (slot_of(j) << 15) | (uint64_t)j : ~0ull;
  }
  for (int k = 2; k <= LEG_CHUNK; k <<= 1) {
    for (int j = k >> 1; j >= 8; j >>= 1) {
      if (j >= 8 * 32) {
#pragma unroll
        for (int r = 0; r < 8; ++r) sh[8 * t + r] = v[r];
        __syncthreads();
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = 8 * t + r;
          v[r] = cx(v[r], sh[i ^ j], i, j, k);
        }
        __syncthreads();
      } else {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = 8 * t + r;
          const uint64_t o = __shfl_xor_sync(
              0xffffffffu, (unsigned long long)v[r], j >> 3);
          v[r] = cx(v[r], o, i, j, k);
        }
      }
    }
    if (k >= 8) cx_regs<4>(v, t, k);
    if (k >= 4) cx_regs<2>(v, t, k);
    cx_regs<1>(v, t, k);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) chunks[c * LEG_CHUNK + 8 * t + r] = v[r];
}

// After the grid barrier that follows scan_leg: the carry from the blocks
// before this one (their aggregates folded in order by warp 0), then leg
// j's four fields, slot outputs and position, and the arith flag.
static __device__ void finish_leg(const Ptrs& a, const Leg& g, int j,
                                  const uint64_t* agg, uint64_t cap) {
  __shared__ Seg6 carry_sh;
  // The aggregates of the blocks before this one, staged by 16-byte
  // cp.async copies (one round trip; the array's length is even, so the
  // copy past an odd count stays inside it).
  __shared__ __align__(16) uint64_t agg_sh[LEG_MAX_BLOCKS * LEG_AGG_WORDS];
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  for (int k = 2 * threadIdx.x; k < b * LEG_AGG_WORDS; k += 2 * blockDim.x) {
    cp_async16(agg_sh + k, agg + k);
  }
  cp_async_wait_all();
  __syncthreads();
  if (threadIdx.x < 32) {
    const int per = (b + 31) / 32;
    Seg6 acc = seg6_zero();
    for (int c = lane * per; c < b && c < (lane + 1) * per; ++c) {
      const uint64_t* w = agg_sh + c * LEG_AGG_WORDS;
      Seg6 t;
#pragma unroll
      for (int s = 0; s < LEG_STREAMS; ++s) {
        t.v[s] = ((u128)w[2 * s + 1] << 64) | w[2 * s];
      }
      t.head = (int)w[2 * LEG_STREAMS];
      acc = seg6_op(acc, t);
    }
    acc = warp_scan6(acc);
    if (lane == 31) carry_sh = acc;
  }
  __syncthreads();
  const Seg6 sum = seg6_op(carry_sh, g.incl);
  bool bad_any = false;
  if (g.in) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int as = f == 0 ? 0 : f == 1 ? 2 : f == 2 ? 3 : 5;
      const u128 add_i = sum.v[as], add_e = add_i - g.d[as];
      u128 sub_i = 0, sub_e = 0;
      if (f == 0 || f == 2) {
        const int ss = f == 0 ? 1 : 4;
        sub_i = sum.v[ss];
        sub_e = sub_i - g.d[ss];
      }
      const u128 start = g.start[f];
      const u128 added_e = start + add_e, added_i = start + add_i;
      const u128 pre = added_e - sub_e, incl = added_i - sub_i;
      const bool bad = added_e < start || added_e < sub_e ||
                       added_i < start || added_i < sub_i;
      if (g.slot < cap && bad) bad_any = true;
      LP(uint64_t, L_VAL + 4 * f + 0)[j] = (uint64_t)pre;
      LP(uint64_t, L_VAL + 4 * f + 1)[j] = (uint64_t)(pre >> 64);
      LP(uint64_t, L_VAL + 4 * f + 2)[j] = (uint64_t)incl;
      LP(uint64_t, L_VAL + 4 * f + 3)[j] = (uint64_t)(incl >> 64);
    }
    LP(int64_t, L_S_SLOT)[j] = (int64_t)g.slot;
    LP(uint8_t, L_S_LIVE)[j] = g.slot < cap ? 1 : 0;
    LP(uint8_t, L_IS_LAST)[j] = g.last ? 1 : 0;
    LP(int64_t, L_LEG_POS)[g.L] = j;
  }
  // The reset of the flag (thread 0 of block 0, at the start) is behind a
  // grid barrier; every store sets it, so one a warp.
  if (__any_sync(0xffffffffu, bad_any) && lane == 0) *LP(uint8_t, L_ARITH) = 1;
}

__global__ void __launch_bounds__(LEG_THREADS, 1)
    full_legs_kernel(Ptrs a, int n, int has_pv, uint64_t cap, int aux, int p) {
  extern __shared__ __align__(16) uint64_t sh[];
  const int* ctrl = LP(const int, L_CTRL);
  if (ctrl && !aux &&
      !full_should_run(ctrl, LP(const uint8_t, L_PROVED),
                       LP(const int, L_NEEDED)))
    return;  // every thread reads the same words: the whole grid returns
  cg::grid_group grid = cg::this_grid();
  PHASE_MARK(0);
  const int n2 = 2 * n, b = blockIdx.x, B = gridDim.x;
  const int j = b * LEG_THREADS + threadIdx.x;
  const LegScratch sc = leg_scratch(a, p);
  uint64_t* cache_slot = LP(uint64_t, L_CACHE_SLOT);
  int* cache_ok = LP(int, L_CACHE_OK);
  uint64_t* stats = LP(uint64_t, L_STATS);
  if (b == 0 && threadIdx.x == 0) {
    *LP(uint8_t, L_ARITH) = 0;
    if (stats) atomicAdd((unsigned long long*)stats, 1ull);
  }
  bool stale = cache_ok == nullptr || __ldcg(cache_ok) == 0;
  if (!stale) {
    // The cache's keys, on the guess that the slots are those it sorted;
    // each block's verdict on its own legs beside its aggregate.
    const bool differs = j < n2 && ldcg_u64(cache_slot, j) != leg_slot(a, j, cap);
    const int any = __syncthreads_or(differs);
    if (threadIdx.x == 0) sc.stale[b] = (uint64_t)any;
    const Leg g = scan_leg(a, sc.keys, j, n2, has_pv, sc.agg);
    PHASE_MARK(1);
    grid.sync();
    PHASE_MARK(2);
    // B <= LEG_MAX_BLOCKS = LEG_THREADS: a verdict a thread.
    stale = __syncthreads_or(threadIdx.x < B &&
                             ldcg_u64(sc.stale, threadIdx.x) != 0);
    if (!stale) {
      finish_leg(a, g, j, sc.agg, cap);
      PHASE_MARK(7);
      return;
    }
  }
  if (stats && b == 0 && threadIdx.x == 0)
    atomicAdd((unsigned long long*)stats + 1, 1ull);
  // The stale cache's sort over the card: chunk sorts, a barrier, the
  // merge by rank (and the cache refreshed), a barrier.
  const int chunk = p < LEG_CHUNK ? p : LEG_CHUNK, nch = p / chunk;
  auto slot_of = [&](int k) { return leg_slot(a, k, cap); };
  if (b < nch) {
    if (chunk == LEG_CHUNK) {
      sort_chunk_1024(sh, b, n2, slot_of, sc.chunks);
    } else {
      sort_leg_chunk(sh, b, chunk, n2, slot_of, sc.chunks);
    }
  }
  PHASE_MARK(3);
  grid.sync();
  stage_chunks(sh, sc.chunks, p);
  if (j < n2) {
    sc.keys[chunk_rank(sh, chunk, nch, j)] = sh[j];
    if (cache_slot) cache_slot[j] = slot_of(j);
  }
  PHASE_MARK(4);
  grid.sync();
  const Leg g = scan_leg(a, sc.keys, j, n2, has_pv, sc.agg);
  PHASE_MARK(5);
  grid.sync();
  if (cache_ok && b == 0 && threadIdx.x == 0) *cache_ok = 1;
  finish_leg(a, g, j, sc.agg, cap);
  PHASE_MARK(6);
}

PHASE_CLOCK_ENTRIES(tb_full_legs_phases)

// The launch's shape for `n` lanes: blocks, threads, dynamic shared bytes
// (the stale sort's staged chunks) and the padded leg count p.
static void legs_shape(int64_t n, int* blocks, int* bytes, int* p) {
  int q = 2;
  while (q < 2 * n) q <<= 1;
  *p = q;
  *bytes = 8 * q;
  *blocks = (int)((2 * n + LEG_THREADS - 1) / LEG_THREADS);
}

extern "C" int tb_full_legs(const void* const* ptrs, int nptrs, int64_t n,
                            int has_pv, uint64_t cap, int aux, void* stream) {
  if (nptrs != L_NPTRS || n <= 0 || 2 * n > FULL_MAX_LEGS)
    return (int)cudaErrorInvalidValue;
  Ptrs a;
  int err = pack_ptrs(&a, nptrs, ptrs);
  if (err) return err;
  if (a.p[L_SCRATCH] == nullptr || a.p[L_ARITH] == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((a.p[L_CACHE_KEYS] == nullptr) != (a.p[L_CACHE_OK] == nullptr) ||
      (a.p[L_CACHE_KEYS] == nullptr) != (a.p[L_CACHE_SLOT] == nullptr))
    return (int)cudaErrorInvalidValue;
  static bool opted = false;
  if (!opted) {
    err = full_smem_opt_in(full_legs_kernel, 8 * FULL_MAX_LEGS);
    if (err) return err;
    opted = true;
  }
  int blocks = 0, bytes = 0, p = 0;
  legs_shape(n, &blocks, &bytes, &p);
  int ni = (int)n, aux_i = aux, pv = has_pv;
  uint64_t c = cap;
  void* args[] = {&a, &ni, &pv, &c, &aux_i, &p};
  err = (int)cudaLaunchCooperativeKernel((const void*)full_legs_kernel,
                                         dim3((unsigned)blocks),
                                         dim3(LEG_THREADS), args,
                                         (size_t)bytes, (cudaStream_t)stream);
  if (err) cudaGetLastError();  // a refused launch leaves its error behind
  return err;
}

// What the compiler and the card make of K10's launch for `n` lanes:
// out[0..5] = registers, local bytes a thread, threads a block, blocks,
// dynamic shared bytes, blocks resident on one SM.
extern "C" int tb_full_legs_info(int64_t n, int* out) {
  if (n <= 0 || 2 * n > FULL_MAX_LEGS) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, (const void*)full_legs_kernel);
  if (e != cudaSuccess) return (int)e;
  int err = full_smem_opt_in(full_legs_kernel, 8 * FULL_MAX_LEGS);
  if (err) return err;
  int blocks = 0, bytes = 0, p = 0, per_sm = 0;
  legs_shape(n, &blocks, &bytes, &p);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, full_legs_kernel,
                                                    LEG_THREADS, bytes);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = LEG_THREADS;
  out[3] = blocks;
  out[4] = bytes;
  out[5] = per_sm;
  return 0;
}

// The apply's balance scatter: where the batch commits (*gate == 0), the
// last live leg of each slot run writes its account's four inclusive
// fields (8 columns in ledger order).  Slots of run tails are unique.  In
// the slot-base form (one shard of a sharded ledger,
// tigerbeetle_tpu/parallel/sharded.py:439-450) the slots are global and a
// tail writes only when its slot lies in [slot_base, slot_base + cap), at
// slot - slot_base of the shard's columns; the single device passes base 0.
__global__ void full_legs_apply_kernel(const int* __restrict__ gate, int n2,
                                       const uint8_t* __restrict__ scat,
                                       const int64_t* __restrict__ s_slot,
                                       int64_t slot_base, uint64_t cap,
                                       Ptrs incl, Ptrs cols) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n2 || *gate != 0 || !scat[j]) return;
  const uint64_t slot = (uint64_t)(s_slot[j] - slot_base);
  if (slot >= cap) return;  // another shard's account
  for (int c = 0; c < 8; ++c) {
    static_cast<uint64_t*>(const_cast<void*>(cols.p[c]))[slot] =
        static_cast<const uint64_t*>(incl.p[c])[j];
  }
}

extern "C" int tb_full_legs_apply(const void* gate, int64_t n2,
                                  const void* scat, const void* s_slot,
                                  int64_t slot_base, int64_t cap,
                                  const void* const* incl,
                                  const void* const* cols, void* stream) {
  Ptrs v, c;
  int err = pack_ptrs(&v, 8, incl);
  if (!err) err = pack_ptrs(&c, 8, cols);
  if (err) return err;
  if (n2 <= 0) return 0;
  const int threads = 256;
  full_legs_apply_kernel<<<(unsigned)((n2 + threads - 1) / threads), threads, 0,
                           (cudaStream_t)stream>>>(
      (const int*)gate, (int)n2, (const uint8_t*)scat, (const int64_t*)s_slot,
      slot_base, (uint64_t)cap, v, c);
  return (int)cudaGetLastError();
}
