// K11 full_pass: one Jacobi pass of the general transfer kernel, and the
// launches around the pass loop (lane set-up; the history append, its own
// __global__ function below).
//
// Replaces tigerbeetle_tpu/ops/transfer_full.py:806 `one_pass` (and what it
// calls: :178 `_first_code`, :228 `_group_winner`, :1442 `_exists_regular`,
// :1467 `_exists_postvoid`, ops/state_machine.py:287 `_chain_codes`), the
// loop of :1150 `step_pass` / :1199 (the while form), the aux pass and
// routing flags of :1209-1307, the wave-scheduler inputs of :738-794, and
// the history append of `create_transfers_full_impl`, :1408-1424.
//
// Modes of one launch:
//   INIT  lane constants (valid, pending, post/void, linked), the carry
//         (ok all False, codes 0xFFFFFFFF, amounts the raw amounts), the
//         first pass's empty winners, each lane's linked-chain start (the
//         flags do not change between passes), the loop control words, and
//         the wave scheduler's inputs (hazard, unschedulable, the
//         effective debit/credit slots) for K12;
//   PRE   from the previous iterate's winners (each id group's first ok
//         lane, taken by the POST before): the in-batch pending reference
//         of each post/void lane and the effective accounts, written as
//         K10's leg inputs;
//   POST  after K10: the balancing clamps, the overflow and limit ladders,
//         the composed rows, the regular and post/void ladders, the
//         duplicate override, the double post/void grouping (keyed on the
//         resolved pending timestamp; key 0 left out), chain codes; then
//         either the new carry, the next pass's winners, k and the
//         stability flag (a loop pass) or the plan's outputs, history
//         values and FLAG_SEQ route (aux);
// and, apart, the history append where the batch commits: an exclusive
// prefix over the lanes that record history, rows past the capacity
// dropped, the count grown by all of them.
// A loop launch (PRE, K10, POST) reads the control words first and returns
// at once once the loop is over (the JAX while condition: a stable pass
// seen, the budget spent, or the proved wave bound reached), so the host
// queues `max_passes` passes and the aux pass without a read.
//
// The grid: every launch (the history append too) is one cooperative
// launch of ceil(n / 64) blocks of PASS_THREADS = 64 threads, 128 blocks
// on 128 of the H100's 132 SMs at 8,192 lanes (fewer if the card holds
// fewer at once; each thread then walks a contiguous run of lanes), one
// lane a thread.  The batch-wide steps cross blocks at grid barriers
// (cooperative_groups' grid.sync(); PRE has one, POST four, INIT one): the
// winners, the fulfilment winners and the post/void hash are device-memory
// atomics (atomicMin, atomicCAS) whose resets sit behind a barrier before
// their uses; the chain starts are a two-level max-scan (a block scan, then
// each block's last start from the blocks before it), done once in INIT;
// stability, unschedulable and the routing flags are per-block ORs that
// one thread folds after the last barrier.  What other blocks wrote in the
// same launch is read with __ldcg (L2, never a stale L1 line).  Every
// output is a function of the inputs alone: the atomics are integer min,
// CAS on a hash keyed by lane-independent keys, and sums.
//
// What bounds it on the H100: latency.  Each lane reads about 110 columns
// and its legs' balances; the bytes a pass must move (about 8 MB at 8,192
// lanes with post/void) take about 2.5 us at 3.35 TB/s, so the grid
// barriers and the launches hold it.  The ten launches of a core that
// return at once (a stable pass seen) cost a launch each.
#include <cooperative_groups.h>

#include "full_common.cuh"

#undef F_OK  // <unistd.h>'s access() mode, which the headers above pull in

namespace cg = cooperative_groups;

#define PASS_THREADS 64
#define PASS_MAX_BLOCKS (8 * FULL_THREADS / PASS_THREADS)  // 128

enum FullPtr {
  F_BATCH = 0,                 // 19 columns, TRANSFER_BATCH_COLS order
  F_EX_FOUND = F_BATCH + 19,
  F_E_TAB,                     // 17 columns, TRANSFER_COLS order
  F_P_TAB_FOUND = F_E_TAB + 17,
  F_P_TAB,                     // 17
  F_DRT = F_P_TAB + 17,        // 4 account views of 12: found, slot,
  F_CRT = F_DRT + 12,          //   flags, ledger, 8 balance columns
  F_PDR = F_CRT + 12,
  F_PCR = F_PDR + 12,
  F_POSTED_FOUND = F_PCR + 12,
  F_POSTED_VAL,
  F_GROUP, F_ANY_DUP, F_PJ_HIT, F_PJ_GROUP,
  F_CTRL, F_PROVED, F_NEEDED,
  F_VALID, F_PENDING, F_POST, F_POSTVOID, F_LINKED,
  F_OK_C, F_CODE_C, F_AMT_C_LO, F_AMT_C_HI,
  F_HAZARD, F_UNSCHED, F_WDR_SLOT, F_WDR_LIVE, F_WCR_SLOT, F_WCR_LIVE,
  F_WINNER, F_REF,
  F_LEG_START,                 // 8 leg-domain start balances
  F_DR_SLOT = F_LEG_START + 8, F_CR_SLOT, F_DR_LIVE, F_CR_LIVE, F_PAMT,
  F_FLAGS_DR, F_FLAGS_CR,
  F_LEG_POS, F_LEG_VAL,        // 16 values of K10
  F_S_SLOT = F_LEG_VAL + 16, F_S_LIVE, F_IS_LAST, F_ARITH,
  F_ROW,                       // 17 composed rows, TRANSFER_COLS order
  F_CODE_T = F_ROW + 17, F_PRE_CHAIN, F_NEAR_OV, F_FKEY, F_FHASH, F_CHAIN,
  F_CODES, F_OK, F_PV_OK, F_POSTED_KEY, F_DO_HIST,
  F_HIST,                      // 21 columns, HISTORY_COLS order
  F_ROUTE = F_HIST + 21, F_PASSES, F_WAVE_BOUND,
  F_CACHE_OK,                  // K10/K12's sort cache: invalid per batch
  F_GRID,                      // int32[2 * PASS_MAX_BLOCKS]: per-block partials
  F_NPTRS
};

// TRANSFER_COLS indices (the batch holds them at +2, after the id).
enum TC {
  TC_DR_LO, TC_DR_HI, TC_CR_LO, TC_CR_HI, TC_AMT_LO, TC_AMT_HI, TC_PID_LO,
  TC_PID_HI, TC_UD128_LO, TC_UD128_HI, TC_UD64, TC_UD32, TC_TIMEOUT,
  TC_LEDGER, TC_CODE, TC_FLAGS, TC_TS, TC_N
};
enum View { V_FOUND, V_SLOT, V_FLAGS, V_LEDGER, V_BAL0 };
enum Mode { M_INIT, M_PRE, M_POST };

struct FullPtrs {
  const void* p[F_NPTRS];
};

struct Env {
  FullPtrs a;
  int n, count, has_pv, use_waves, max_passes, hsize;
  uint64_t batch_ts;
};

static __device__ __forceinline__ bool tc_is_u32(int c) {
  return c >= TC_UD32 && c <= TC_FLAGS;
}

#define PTR(T, k) (static_cast<T*>(const_cast<void*>(e.a.p[k])))
#define B8(k, i) (PTR(const uint8_t, k)[i] != 0)

static __device__ __forceinline__ uint64_t col(const Env& e, int k, bool u32,
                                               int i) {
  return u32 ? (uint64_t)PTR(const uint32_t, k)[i] : PTR(const uint64_t, k)[i];
}
// Batch column c of TRANSFER_COLS (or -2 / -1: the id).
static __device__ __forceinline__ uint64_t bcol(const Env& e, int c, int i) {
  return col(e, F_BATCH + 2 + c, tc_is_u32(c), i);
}
static __device__ __forceinline__ uint64_t id_lo(const Env& e, int i) {
  return PTR(const uint64_t, F_BATCH)[i];
}
static __device__ __forceinline__ uint64_t id_hi(const Env& e, int i) {
  return PTR(const uint64_t, F_BATCH + 1)[i];
}
static __device__ __forceinline__ u128 mk(uint64_t lo, uint64_t hi) {
  return ((u128)hi << 64) | lo;
}
static __device__ __forceinline__ u128 val128(const Env& e, int k, int j) {
  return mk(PTR(const uint64_t, k)[j], PTR(const uint64_t, k + 1)[j]);
}
static __device__ __forceinline__ uint64_t ts_of(const Env& e, int i) {
  return e.batch_ts - (uint64_t)e.count + (uint64_t)i + 1;
}

// Per-lane flags of the batch (as the JAX kernel core masks them).
struct LaneFlags {
  bool valid, post, void_, postvoid, pending, linked, bal_dr, bal_cr;
};
static __device__ LaneFlags lane_flags(const Env& e, int i) {
  LaneFlags f;
  const uint32_t fl = (uint32_t)bcol(e, TC_FLAGS, i);
  f.valid = i < e.count;
  f.post = e.has_pv && (fl & 4u) && f.valid;
  f.void_ = e.has_pv && (fl & 8u) && f.valid;
  f.postvoid = f.post || f.void_;
  f.pending = (fl & 2u) && f.valid;
  f.linked = (fl & 1u) && f.valid;
  f.bal_dr = (fl & 16u) && f.valid;
  f.bal_cr = (fl & 32u) && f.valid;
  return f;
}

// The resolved pending row of lane i: the in-batch pending lane `ref` (its
// timestamp, the previous iterate's amount, its batch columns) or the table
// pending.
struct Row {
  uint64_t v[TC_N];
};
static __device__ Row resolve_p(const Env& e, int i, int ref) {
  Row p;
  for (int c = 0; c < TC_N; ++c) {
    if (ref < 0) {
      p.v[c] = col(e, F_P_TAB + c, tc_is_u32(c), i);
    } else if (c == TC_TS) {
      p.v[c] = ts_of(e, ref);
    } else if (c == TC_AMT_LO) {
      p.v[c] = PTR(const uint64_t, F_AMT_C_LO)[ref];
    } else if (c == TC_AMT_HI) {
      p.v[c] = PTR(const uint64_t, F_AMT_C_HI)[ref];
    } else {
      p.v[c] = bcol(e, c, ref);
    }
  }
  return p;
}

static __device__ __forceinline__ bool near_start(const Env& e, int view,
                                                  int i) {
  const uint64_t near_w = 0x7FFFFFFFFFFF0000ull;
  if (!B8(view + V_FOUND, i)) return false;
  for (int f = 0; f < 4; ++f) {
    if (PTR(const uint64_t, view + V_BAL0 + 2 * f + 1)[i] >= near_w) return true;
  }
  return false;
}

// create_transfer_exists against row `e_` (a table row or a winner's row).
static __device__ uint32_t exists_regular(const Env& e, int i, const Row& r,
                                          u128 t_amt) {
  auto ne128 = [&](int c) {
    return bcol(e, c, i) != r.v[c] || bcol(e, c + 1, i) != r.v[c + 1];
  };
  if (bcol(e, TC_FLAGS, i) != r.v[TC_FLAGS]) return 36;
  if (ne128(TC_DR_LO)) return 37;
  if (ne128(TC_CR_LO)) return 38;
  if ((uint64_t)t_amt != r.v[TC_AMT_LO] || (uint64_t)(t_amt >> 64) != r.v[TC_AMT_HI])
    return 39;
  if (ne128(TC_PID_LO)) return 40;
  if (ne128(TC_UD128_LO)) return 41;
  if (bcol(e, TC_UD64, i) != r.v[TC_UD64]) return 42;
  if (bcol(e, TC_UD32, i) != r.v[TC_UD32]) return 43;
  if (bcol(e, TC_TIMEOUT, i) != r.v[TC_TIMEOUT]) return 44;
  if (bcol(e, TC_CODE, i) != r.v[TC_CODE]) return 45;
  return 46;
}

// post_or_void_pending_transfer_exists against row `r`, pending `p`.
static __device__ uint32_t exists_postvoid(const Env& e, int i, const Row& r,
                                           const Row& p) {
  auto pair_ne = [](uint64_t a0, uint64_t a1, uint64_t b0, uint64_t b1) {
    return a0 != b0 || a1 != b1;
  };
  const uint64_t tal = bcol(e, TC_AMT_LO, i), tah = bcol(e, TC_AMT_HI, i);
  const bool amount_ne =
      (tal == 0 && tah == 0)
          ? pair_ne(r.v[TC_AMT_LO], r.v[TC_AMT_HI], p.v[TC_AMT_LO], p.v[TC_AMT_HI])
          : pair_ne(tal, tah, r.v[TC_AMT_LO], r.v[TC_AMT_HI]);
  const uint64_t tul = bcol(e, TC_UD128_LO, i), tuh = bcol(e, TC_UD128_HI, i);
  const bool ud128_ne =
      (tul == 0 && tuh == 0)
          ? pair_ne(r.v[TC_UD128_LO], r.v[TC_UD128_HI], p.v[TC_UD128_LO],
                    p.v[TC_UD128_HI])
          : pair_ne(tul, tuh, r.v[TC_UD128_LO], r.v[TC_UD128_HI]);
  const uint64_t t64 = bcol(e, TC_UD64, i), t32 = bcol(e, TC_UD32, i);
  const bool ud64_ne = t64 == 0 ? r.v[TC_UD64] != p.v[TC_UD64] : t64 != r.v[TC_UD64];
  const bool ud32_ne = t32 == 0 ? r.v[TC_UD32] != p.v[TC_UD32] : t32 != r.v[TC_UD32];
  if (bcol(e, TC_FLAGS, i) != r.v[TC_FLAGS]) return 36;
  if (amount_ne) return 39;
  if (pair_ne(bcol(e, TC_PID_LO, i), bcol(e, TC_PID_HI, i), r.v[TC_PID_LO],
              r.v[TC_PID_HI]))
    return 40;
  if (ud128_ne) return 41;
  if (ud64_ne) return 42;
  if (ud32_ne) return 43;
  return 46;
}

static __device__ __forceinline__ bool balance_code(uint32_t c) {
  return (c >= 47 && c <= 52) || c == 54 || c == 55;
}

static __device__ __forceinline__ bool add_ov(u128 a, u128 b) {
  return a + b < a;
}
static __device__ __forceinline__ u128 sub_sat(u128 a, u128 b) {
  return a >= b ? a - b : 0;
}
static __device__ __forceinline__ u128 min128(u128 a, u128 b) {
  return a <= b ? a : b;
}

// Cross-block reads: values another block wrote in the same launch (before
// a grid barrier) come from L2.
static __device__ __forceinline__ uint64_t ldcg64(const void* p, int i) {
  return (uint64_t)__ldcg(static_cast<const unsigned long long*>(p) + i);
}
static __device__ __forceinline__ int ldcg32(const int* p, int i) {
  return __ldcg(p + i);
}
static __device__ __forceinline__ uint64_t col_cg(const Env& e, int k, bool u32,
                                                  int i) {
  return u32 ? (uint64_t)__ldcg(static_cast<const unsigned int*>(e.a.p[k]) + i)
             : ldcg64(e.a.p[k], i);
}

// This thread's lanes: a contiguous run, so a block's lanes are contiguous
// and in thread order (the chain-start scan needs that).
struct Lanes {
  int lo, hi;
};
static __device__ __forceinline__ Lanes grid_lanes(int n) {
  const int T = gridDim.x * blockDim.x;
  const int per = (n + T - 1) / T;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  Lanes L;
  L.lo = g * per < n ? g * per : n;
  L.hi = L.lo + per < n ? L.lo + per : n;
  return L;
}

static __device__ __forceinline__ void grid_sync() { cg::this_grid().sync(); }

// Per-block partials (F_GRID): the chain-start scan's and a flag word.
static __device__ __forceinline__ int* part_scan(const Env& e) {
  return PTR(int, F_GRID);
}
static __device__ __forceinline__ int* part_flags(const Env& e) {
  return PTR(int, F_GRID) + PASS_MAX_BLOCKS;
}

// The OR of every block's flag word (after a grid barrier).
static __device__ int fold_flags(const Env& e) {
  int f = 0;
  for (int b = 0; b < (int)gridDim.x; ++b) f |= ldcg32(part_flags(e), b);
  return f;
}

// The block's OR of `v`, stored as its flag word (thread 0).
static __device__ void block_flags(const Env& e, int v) {
  __shared__ int sh;
  if (threadIdx.x == 0) sh = 0;
  __syncthreads();
  if (v) atomicOr(&sh, v);
  __syncthreads();
  if (threadIdx.x == 0) part_flags(e)[blockIdx.x] = sh;
}

// ---------------------------------------------------------------------------

static __device__ void mode_init(const Env& e) {
  __shared__ int shint[32];
  const Lanes L = grid_lanes(e.n);
  int uns = 0;
  for (int i = L.lo; i < L.hi; ++i) {
    const LaneFlags f = lane_flags(e, i);
    PTR(uint8_t, F_VALID)[i] = f.valid;
    PTR(uint8_t, F_PENDING)[i] = f.pending;
    PTR(uint8_t, F_POST)[i] = f.post;
    PTR(uint8_t, F_POSTVOID)[i] = f.postvoid;
    PTR(uint8_t, F_LINKED)[i] = f.linked;
    PTR(uint8_t, F_OK_C)[i] = 0;
    PTR(uint32_t, F_CODE_C)[i] = 0xFFFFFFFFu;
    PTR(uint64_t, F_AMT_C_LO)[i] = bcol(e, TC_AMT_LO, i);
    PTR(uint64_t, F_AMT_C_HI)[i] = bcol(e, TC_AMT_HI, i);
    PTR(int, F_WINNER)[i] = e.n;  // the first pass: no ok lane, no winner
    if (e.use_waves) {
      const bool dr_limf =
          (PTR(const uint32_t, F_DRT + V_FLAGS)[i] & 2u) && B8(F_DRT + V_FOUND, i);
      const bool cr_limf =
          (PTR(const uint32_t, F_CRT + V_FLAGS)[i] & 4u) && B8(F_CRT + V_FOUND, i);
      bool hazard = f.valid && (f.bal_dr || f.bal_cr || dr_limf || cr_limf ||
                                near_start(e, F_DRT, i) || near_start(e, F_CRT, i));
      if (f.linked) uns = 1;
      const int dv = f.postvoid ? F_PDR : F_DRT, cv = f.postvoid ? F_PCR : F_CRT;
      if (e.has_pv) {
        hazard = hazard || (f.postvoid && (near_start(e, F_PDR, i) ||
                                           near_start(e, F_PCR, i)));
        if (f.postvoid && B8(F_PJ_HIT, i)) uns = 1;
      }
      PTR(uint8_t, F_HAZARD)[i] = hazard;
      PTR(int64_t, F_WDR_SLOT)[i] = PTR(const int64_t, dv + V_SLOT)[i];
      PTR(int64_t, F_WCR_SLOT)[i] = PTR(const int64_t, cv + V_SLOT)[i];
      PTR(uint8_t, F_WDR_LIVE)[i] =
          B8(dv + V_FOUND, i) && (f.postvoid || f.valid);
      PTR(uint8_t, F_WCR_LIVE)[i] =
          B8(cv + V_FOUND, i) && (f.postvoid || f.valid);
    }
  }
  // Chain starts (ops/state_machine.py:287): the last lane at or before
  // each lane where a chain opens; within the block by a max-scan, across
  // blocks by each block's last start.  The flags are this thread's own
  // lanes', just written.
  auto is_start = [&](int j) {
    const LaneFlags f = lane_flags(e, j);
    return f.linked && !(j > 0 && lane_flags(e, j - 1).linked);
  };
  int last = -1;
  for (int j = L.lo; j < L.hi; ++j) {
    if (is_start(j)) last = j;
  }
  int top = -1;
  int cur = block_scan_excl(last, -1, OpMax(), shint, &top);
  int* cstart = PTR(int, F_CHAIN);
  for (int j = L.lo; j < L.hi; ++j) {
    if (is_start(j)) cur = j;
    cstart[j] = cur;
  }
  if (threadIdx.x == 0) part_scan(e)[blockIdx.x] = top;
  block_flags(e, uns);
  grid_sync();
  int before = -1;
  for (int b = 0; b < (int)blockIdx.x; ++b) {
    const int t = ldcg32(part_scan(e), b);
    if (t > before) before = t;
  }
  for (int j = L.lo; j < L.hi; ++j) {
    if (cstart[j] < before) cstart[j] = before;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int* ctrl = PTR(int, F_CTRL);
    ctrl[C_K] = 0;
    ctrl[C_EVER_STABLE] = 0;
    ctrl[C_MAX_PASSES] = e.max_passes;
    PTR(int, F_CACHE_OK)[0] = 0;
    if (e.use_waves) {
      PTR(uint8_t, F_UNSCHED)[0] = (fold_flags(e) || B8(F_ANY_DUP, 0)) ? 1 : 0;
    } else {
      PTR(uint8_t, F_PROVED)[0] = 0;
      PTR(int, F_NEEDED)[0] = 8 + 1;  // the JAX package's _MAX_PASSES + 1
    }
  }
}

static __device__ void mode_pre(const Env& e) {
  const Lanes L = grid_lanes(e.n);
  const int n = e.n;
  int* winner = PTR(int, F_WINNER);
  const int64_t* group = PTR(const int64_t, F_GROUP);
  // The winners of the previous iterate (reset to n by INIT or by the
  // POST before): each id group's lowest ok lane.
  for (int i = L.lo; i < L.hi; ++i) {
    if (B8(F_OK_C, i)) atomicMin(winner + group[i], i);
  }
  grid_sync();
  for (int i = L.lo; i < L.hi; ++i) {
    const LaneFlags f = lane_flags(e, i);
    int ref = -1;
    if (e.has_pv && f.postvoid && B8(F_PJ_HIT, i)) {
      const int pw = ldcg32(winner, (int)PTR(const int64_t, F_PJ_GROUP)[i]);
      if (pw < n && pw < i && B8(F_OK_C, pw)) ref = pw;
    }
    PTR(int, F_REF)[i] = ref;
    // Effective accounts: the in-batch pending's own (at lane ref), the
    // table pending's (post/void), or the event's.
    const int dv = ref >= 0 ? F_DRT : (f.postvoid ? F_PDR : F_DRT);
    const int cv = ref >= 0 ? F_CRT : (f.postvoid ? F_PCR : F_CRT);
    const int src = ref >= 0 ? ref : i;
    PTR(int64_t, F_DR_SLOT)[i] = PTR(const int64_t, dv + V_SLOT)[src];
    PTR(int64_t, F_CR_SLOT)[i] = PTR(const int64_t, cv + V_SLOT)[src];
    PTR(uint8_t, F_DR_LIVE)[i] = B8(dv + V_FOUND, src) && f.valid;
    PTR(uint8_t, F_CR_LIVE)[i] = B8(cv + V_FOUND, src) && f.valid;
    PTR(uint32_t, F_FLAGS_DR)[i] = PTR(const uint32_t, dv + V_FLAGS)[src];
    PTR(uint32_t, F_FLAGS_CR)[i] = PTR(const uint32_t, cv + V_FLAGS)[src];
    for (int b = 0; b < 8; ++b) {
      PTR(uint64_t, F_LEG_START + b)[2 * i] =
          PTR(const uint64_t, dv + V_BAL0 + b)[src];
      PTR(uint64_t, F_LEG_START + b)[2 * i + 1] =
          PTR(const uint64_t, cv + V_BAL0 + b)[src];
    }
    PTR(uint64_t, F_PAMT)[i] =
        ref >= 0 ? PTR(const uint64_t, F_AMT_C_LO)[ref]
                 : PTR(const uint64_t, F_P_TAB + TC_AMT_LO)[i];
  }
}

// Lane i's code before the duplicate override; writes its composed row.
static __device__ uint32_t lane_code(const Env& e, int i) {
  const LaneFlags f = lane_flags(e, i);
  const int ref = PTR(const int, F_REF)[i];
  const Row p = resolve_p(e, i, ref);
  const bool p_found = B8(F_P_TAB_FOUND, i) || ref >= 0;
  const bool p_is_pending = (p.v[TC_FLAGS] & 2u) && p_found;
  const u128 p_amt = mk(p.v[TC_AMT_LO], p.v[TC_AMT_HI]);
  const u128 t_amt = mk(bcol(e, TC_AMT_LO, i), bcol(e, TC_AMT_HI, i));
  const u128 tid = mk(id_lo(e, i), id_hi(e, i));
  const u128 t_dr = mk(bcol(e, TC_DR_LO, i), bcol(e, TC_DR_HI, i));
  const u128 t_cr = mk(bcol(e, TC_CR_LO, i), bcol(e, TC_CR_HI, i));
  const u128 pend_id = mk(bcol(e, TC_PID_LO, i), bcol(e, TC_PID_HI, i));
  const u128 MAX = ~(u128)0;
  const uint64_t ts = ts_of(e, i);
  const uint32_t flags = (uint32_t)bcol(e, TC_FLAGS, i);
  const uint32_t timeout = (uint32_t)bcol(e, TC_TIMEOUT, i);
  const uint32_t ledger = (uint32_t)bcol(e, TC_LEDGER, i);
  const uint32_t code_col = (uint32_t)bcol(e, TC_CODE, i);
  const bool balancing = f.bal_dr || f.bal_cr;

  // Balances before the event, from K10's legs.
  const int64_t dpos = PTR(const int64_t, F_LEG_POS)[2 * i];
  const int64_t cpos = PTR(const int64_t, F_LEG_POS)[2 * i + 1];
  const u128 a_dp = val128(e, F_LEG_VAL + 0, dpos);
  const u128 a_dpo = val128(e, F_LEG_VAL + 4, dpos);
  const u128 a_cpo = val128(e, F_LEG_VAL + 12, dpos);
  const u128 b_cp = val128(e, F_LEG_VAL + 8, cpos);
  const u128 b_cpo = val128(e, F_LEG_VAL + 12, cpos);
  const u128 b_dpo = val128(e, F_LEG_VAL + 4, cpos);

  // Balancing clamps (state_machine.zig:1286-1306).
  const u128 amount0 = (balancing && t_amt == 0) ? (u128)~0ull : t_amt;
  const u128 avail_dr = sub_sat(a_cpo, a_dpo + a_dp);
  const u128 amount1 = f.bal_dr ? min128(amount0, avail_dr) : amount0;
  const bool exceeds_credits_bal = f.bal_dr && amount1 == 0;
  const u128 avail_cr = sub_sat(b_dpo, b_cpo + b_cp);
  const u128 amount2 = f.bal_cr ? min128(amount1, avail_cr) : amount1;
  const bool exceeds_debits_bal = f.bal_cr && !exceeds_credits_bal && amount2 == 0;
  const u128 reg = amount2;

  // Overflow ladder and balance limits.
  const bool ov_dp = add_ov(reg, a_dp), ov_cp = add_ov(reg, b_cp);
  const bool ov_dpo = add_ov(reg, a_dpo), ov_cpo = add_ov(reg, b_cpo);
  const u128 dr_total = a_dp + a_dpo, cr_total = b_cp + b_cpo;
  const bool ov_d = add_ov(reg, dr_total), ov_c = add_ov(reg, cr_total);
  const bool dr_found = B8(F_DRT + V_FOUND, i), cr_found = B8(F_CRT + V_FOUND, i);
  const uint32_t dr_ledger = PTR(const uint32_t, F_DRT + V_LEDGER)[i];
  const uint32_t cr_ledger = PTR(const uint32_t, F_CRT + V_LEDGER)[i];
  const bool dr_limf = (PTR(const uint32_t, F_DRT + V_FLAGS)[i] & 2u) && dr_found;
  const bool cr_limf = (PTR(const uint32_t, F_CRT + V_FLAGS)[i] & 4u) && cr_found;
  const bool exceeds_credits_lim = dr_limf && (dr_total + reg) > a_cpo;
  const bool exceeds_debits_lim = cr_limf && (cr_total + reg) > b_dpo;

  // Effective amount and the composed row.
  Row row;
  for (int c = 0; c < TC_N; ++c) row.v[c] = bcol(e, c, i);
  row.v[TC_TS] = ts;
  u128 amount = reg;
  if (e.has_pv && f.postvoid) {
    amount = t_amt == 0 ? p_amt : t_amt;
    for (int c = TC_DR_LO; c <= TC_CR_HI; ++c) row.v[c] = p.v[c];
    if (bcol(e, TC_UD128_LO, i) == 0 && bcol(e, TC_UD128_HI, i) == 0) {
      row.v[TC_UD128_LO] = p.v[TC_UD128_LO];
      row.v[TC_UD128_HI] = p.v[TC_UD128_HI];
    }
    if (bcol(e, TC_UD64, i) == 0) row.v[TC_UD64] = p.v[TC_UD64];
    if (bcol(e, TC_UD32, i) == 0) row.v[TC_UD32] = p.v[TC_UD32];
    row.v[TC_LEDGER] = p.v[TC_LEDGER];
    row.v[TC_CODE] = p.v[TC_CODE];
    row.v[TC_TIMEOUT] = 0;
  }
  row.v[TC_AMT_LO] = (uint64_t)amount;
  row.v[TC_AMT_HI] = (uint64_t)(amount >> 64);
  for (int c = 0; c < TC_N; ++c) {
    if (tc_is_u32(c)) {
      PTR(uint32_t, F_ROW + c)[i] = (uint32_t)row.v[c];
    } else {
      PTR(uint64_t, F_ROW + c)[i] = row.v[c];
    }
  }

  // near_ov (the failed-chain hazard), for the aux pass.
  const uint64_t near = 0xFFFFFFFFFFFF0000ull;
  PTR(uint8_t, F_NEAR_OV)[i] =
      ((uint64_t)(a_dp >> 64) >= near || (uint64_t)(a_dpo >> 64) >= near ||
       (uint64_t)(b_cp >> 64) >= near || (uint64_t)(b_cpo >> 64) >= near);

  uint32_t code;
  if (!(e.has_pv && f.postvoid)) {
    // Regular ladder (state_machine.zig:1239-1368).
    const bool ex_found = B8(F_EX_FOUND, i);
    if (flags & 0xFFC0u) code = 4;
    else if (tid == 0) code = 5;
    else if (tid == MAX) code = 6;
    else if (t_dr == 0) code = 8;
    else if (t_dr == MAX) code = 9;
    else if (t_cr == 0) code = 10;
    else if (t_cr == MAX) code = 11;
    else if (t_dr == t_cr) code = 12;
    else if (pend_id != 0) code = 13;
    else if (!f.pending && timeout != 0) code = 17;
    else if (!balancing && t_amt == 0) code = 18;
    else if (ledger == 0) code = 19;
    else if (code_col == 0) code = 20;
    else if (!dr_found) code = 21;
    else if (!cr_found) code = 22;
    else if (dr_ledger != cr_ledger) code = 23;
    else if (ledger != dr_ledger) code = 24;
    else if (ex_found) {
      Row et;
      for (int c = 0; c < TC_N; ++c) et.v[c] = col(e, F_E_TAB + c, tc_is_u32(c), i);
      code = exists_regular(e, i, et, t_amt);
    } else if (exceeds_credits_bal) code = 54;
    else if (exceeds_debits_bal) code = 55;
    else if (f.pending && ov_dp) code = 47;
    else if (f.pending && ov_cp) code = 48;
    else if (ov_dpo) code = 49;
    else if (ov_cpo) code = 50;
    else if (ov_d) code = 51;
    else if (ov_c) code = 52;
    else if (ts + (uint64_t)timeout * 1000000000ull < ts) code = 53;
    else if (exceeds_credits_lim) code = 54;
    else if (exceeds_debits_lim) code = 55;
    else code = 0;
  } else {
    // Post/void ladder (state_machine.zig:1391-1453).
    const u128 p_dr = mk(p.v[TC_DR_LO], p.v[TC_DR_HI]);
    const u128 p_cr = mk(p.v[TC_CR_LO], p.v[TC_CR_HI]);
    const uint64_t expiry = p.v[TC_TS] + p.v[TC_TIMEOUT] * 1000000000ull;
    const bool expired = p.v[TC_TIMEOUT] != 0 && ts >= expiry;
    const bool posted_found = B8(F_POSTED_FOUND, i);
    const uint32_t posted_val = PTR(const uint32_t, F_POSTED_VAL)[i];
    if (flags & 0xFFC0u) code = 4;
    else if (tid == 0) code = 5;
    else if (tid == MAX) code = 6;
    else if (f.post && f.void_) code = 7;
    else if (f.pending) code = 7;
    else if (balancing) code = 7;
    else if (pend_id == 0) code = 14;
    else if (pend_id == MAX) code = 15;
    else if (pend_id == tid) code = 16;
    else if (timeout != 0) code = 17;
    else if (!p_found) code = 25;
    else if (!p_is_pending) code = 26;
    else if (t_dr != 0 && t_dr != p_dr) code = 27;
    else if (t_cr != 0 && t_cr != p_cr) code = 28;
    else if (ledger != 0 && ledger != (uint32_t)p.v[TC_LEDGER]) code = 29;
    else if (code_col != 0 && code_col != (uint32_t)p.v[TC_CODE]) code = 30;
    else if (amount > p_amt) code = 31;
    else if (f.void_ && amount < p_amt) code = 32;
    else if (B8(F_EX_FOUND, i)) {
      Row et;
      for (int c = 0; c < TC_N; ++c) et.v[c] = col(e, F_E_TAB + c, tc_is_u32(c), i);
      code = exists_postvoid(e, i, et, p);
    } else if (posted_found && posted_val == 1) code = 33;
    else if (posted_found && posted_val == 2) code = 34;
    else if (expired) code = 35;
    else code = 0;
  }
  if (PTR(const uint64_t, F_BATCH + 18)[i] != 0) code = 3;
  return code;
}

// The post/void hash's slot of key fkey[i] (inserting lane i if the key is
// new); other lanes' keys were written before the last grid barrier.
static __device__ int fhash_insert(const uint64_t* fkey, int* hkey, int hsize,
                                   int i) {
  const uint64_t k = fkey[i];
  uint64_t h = mix64(k, 0) & (uint64_t)(hsize - 1);
  for (;;) {
    const int prev = atomicCAS(hkey + h, -1, i);
    if (prev == -1 || ldcg64(fkey, prev) == k) return (int)h;
    h = (h + 1) & (uint64_t)(hsize - 1);
  }
}

// Routing flag bits of the aux pass's per-block words.
enum RouteBit { R_U128 = 1, R_LINKED = 2, R_INTRA = 4, R_HAZARD = 8 };

static __device__ void mode_post(const Env& e, int aux) {
  const Lanes L = grid_lanes(e.n);
  const int n = e.n;
  const int G = gridDim.x * blockDim.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t* code_t = PTR(uint32_t, F_CODE_T);
  int* fhkey = PTR(int, F_FHASH);
  int* fhwin = fhkey + e.hsize;
  uint64_t* fkey = PTR(uint64_t, F_FKEY);
  const int* cstart = PTR(const int, F_CHAIN);
  int* fail = PTR(int, F_CHAIN) + n;
  const uint8_t* linked = PTR(const uint8_t, F_LINKED);
  // A. Ladders and rows; the post/void keys (the resolved pending
  //    timestamp, 0 for none); the hash and the chains' first failures
  //    reset.
  for (int j = g; j < e.hsize; j += G) {
    fhkey[j] = -1;
    fhwin[j] = n;
  }
  for (int i = L.lo; i < L.hi; ++i) {
    code_t[i] = lane_code(e, i);
    fail[i] = n;
    if (e.has_pv) {
      const LaneFlags f = lane_flags(e, i);
      const int ref = PTR(const int, F_REF)[i];
      const bool p_found = B8(F_P_TAB_FOUND, i) || ref >= 0;
      uint64_t key = 0;
      if (f.postvoid && p_found) {
        key = ref >= 0 ? ts_of(e, ref)
                       : PTR(const uint64_t, F_P_TAB + TC_TS)[i];
      }
      fkey[i] = key;
    }
  }
  grid_sync();

  // B. Duplicate ids: the override replaces exactly the codes that follow
  //    the exists check in sequential order (the winner's row was composed
  //    in A, by its own lane).  Then each post/void lane joins the hash of
  //    its key, and a lane left with code 0 bids for its key's first
  //    fulfilment.
  const int* winner = PTR(const int, F_WINNER);
  const int64_t* group = PTR(const int64_t, F_GROUP);
  for (int i = L.lo; i < L.hi; ++i) {
    const int w = winner[group[i]];
    uint32_t code = code_t[i];
    if (w < n && i > w) {
      const LaneFlags f = lane_flags(e, i);
      const bool pv = e.has_pv && f.postvoid;
      const bool over = pv ? (code == 0 || code == 33 || code == 34 || code == 35)
                           : (code == 0 || code == 53 || balance_code(code));
      if (over) {
        Row wr;
        for (int c = 0; c < TC_N; ++c) wr.v[c] = col_cg(e, F_ROW + c, tc_is_u32(c), w);
        if (pv) {
          code = exists_postvoid(e, i, wr,
                                 resolve_p(e, i, PTR(const int, F_REF)[i]));
        } else {
          code = exists_regular(e, i, wr,
                                mk(bcol(e, TC_AMT_LO, i), bcol(e, TC_AMT_HI, i)));
        }
        code_t[i] = code;
      }
    }
    if (e.has_pv && fkey[i] != 0) {
      const int h = fhash_insert(fkey, fhkey, e.hsize, i);
      if (code == 0) atomicMin(fhwin + h, i);
    }
  }
  grid_sync();

  // C. Double post/void inside the batch: the first lane with code 0 keeps
  //    its pending, later lanes with 0 or 35 get already posted (33) or
  //    voided (34).  D. Invalid lanes 0; each chain's first failure.
  for (int i = L.lo; i < L.hi; ++i) {
    uint32_t code = code_t[i];
    if (e.has_pv && fkey[i] != 0) {
      const uint64_t k = fkey[i];
      uint64_t h = mix64(k, 0) & (uint64_t)(e.hsize - 1);
      while (ldcg64(fkey, ldcg32(fhkey, (int)h)) != k)
        h = (h + 1) & (uint64_t)(e.hsize - 1);
      const int fw = ldcg32(fhwin, (int)h);
      if (fw < n && i > fw && (code == 0 || code == 35)) {
        code = B8(F_POST, fw) ? 33 : 34;
      }
    }
    if (!(i < e.count)) code = 0;
    PTR(uint32_t, F_PRE_CHAIN)[i] = code;
    if (i == e.count - 1 && linked[i]) code = 2;  // chain open
    code_t[i] = code;
    const bool in_chain = linked[i] || (i > 0 && linked[i - 1]);
    if (in_chain && code != 0) atomicMin(fail + cstart[i], i);
  }
  grid_sync();

  // D. The chains' codes (ops/state_machine.py:287).
  for (int i = L.lo; i < L.hi; ++i) {
    const bool in_chain = linked[i] || (i > 0 && linked[i - 1]);
    if (!in_chain) continue;
    const int f = ldcg32(fail, cstart[i]);
    if (f >= n) continue;
    if (i < f) code_t[i] = 1;
    else if (i > f) code_t[i] = (i == e.count - 1 && linked[i]) ? 2 : 1;
  }

  int* ctrl = PTR(int, F_CTRL);
  if (!aux) {
    // E. Stability against the previous iterate, the new carry, and the
    //    next pass's winners reset (B read this pass's before the last
    //    barrier).
    int unstable = 0;
    for (int i = L.lo; i < L.hi; ++i) {
      const uint32_t code = code_t[i];
      const bool ok = code == 0 && i < e.count;
      const uint64_t lo = PTR(const uint64_t, F_ROW + TC_AMT_LO)[i];
      const uint64_t hi = PTR(const uint64_t, F_ROW + TC_AMT_HI)[i];
      if (code != PTR(const uint32_t, F_CODE_C)[i]) unstable = 1;
      if (ok && (lo != PTR(const uint64_t, F_AMT_C_LO)[i] ||
                 hi != PTR(const uint64_t, F_AMT_C_HI)[i]))
        unstable = 1;
      PTR(uint32_t, F_CODE_C)[i] = code;
      PTR(uint8_t, F_OK_C)[i] = ok;
      PTR(uint64_t, F_AMT_C_LO)[i] = lo;
      PTR(uint64_t, F_AMT_C_HI)[i] = hi;
      PTR(int, F_WINNER)[i] = n;
    }
    block_flags(e, unstable);
    grid_sync();
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      ctrl[C_K] += 1;
      ctrl[C_EVER_STABLE] = fold_flags(e) ? 0 : 1;
    }
    return;
  }

  // E'. The plan: codes, ok, posted keys, history values, routing word.
  int route = 0;
  for (int i = L.lo; i < L.hi; ++i) {
    const LaneFlags f = lane_flags(e, i);
    const uint32_t code = code_t[i];
    const bool ok = code == 0 && f.valid;
    const int ref = PTR(const int, F_REF)[i];
    PTR(uint32_t, F_CODES)[i] = code;
    PTR(uint8_t, F_OK)[i] = ok;
    const bool pv_ok = ok && f.postvoid;
    PTR(uint8_t, F_PV_OK)[i] = pv_ok;
    uint64_t p_ts = 0, p_amt_hi = 0;
    if (e.has_pv) {
      p_ts = ref >= 0 ? ts_of(e, ref) : PTR(const uint64_t, F_P_TAB + TC_TS)[i];
      p_amt_hi = ref >= 0 ? PTR(const uint64_t, F_AMT_C_HI)[ref]
                          : PTR(const uint64_t, F_P_TAB + TC_AMT_HI)[i];
    }
    PTR(uint64_t, F_POSTED_KEY)[i] = pv_ok ? p_ts : 0;
    const bool dr_hist = (PTR(const uint32_t, F_FLAGS_DR)[i] & 8u) && ok;
    const bool cr_hist = (PTR(const uint32_t, F_FLAGS_CR)[i] & 8u) && ok;
    PTR(uint8_t, F_DO_HIST)[i] = (dr_hist || cr_hist) && !f.postvoid;
    const int64_t dpos = PTR(const int64_t, F_LEG_POS)[2 * i];
    const int64_t cpos = PTR(const int64_t, F_LEG_POS)[2 * i + 1];
    // HISTORY_COLS: dr_id, dr_dp, dr_dpo, dr_cp, dr_cpo, cr_id, cr_dp,
    // cr_dpo, cr_cp, cr_cpo (each lo, hi), timestamp.  The K10 values are
    // {dp, dpo, cp, cpo} x {pre, incl} x {lo, hi}.
    for (int side = 0; side < 2; ++side) {
      const bool on = side == 0 ? dr_hist : cr_hist;
      const int64_t pos = side == 0 ? dpos : cpos;
      const int base = F_HIST + 10 * side;
      const int id_col = side == 0 ? TC_DR_LO : TC_CR_LO;
      PTR(uint64_t, base)[i] = on ? PTR(const uint64_t, F_ROW + id_col)[i] : 0;
      PTR(uint64_t, base + 1)[i] =
          on ? PTR(const uint64_t, F_ROW + id_col + 1)[i] : 0;
      for (int fld = 0; fld < 4; ++fld) {
        for (int h = 0; h < 2; ++h) {
          PTR(uint64_t, base + 2 + 2 * fld + h)[i] =
              on ? PTR(const uint64_t, F_LEG_VAL + 4 * fld + 2 + h)[pos] : 0;
        }
      }
    }
    PTR(uint64_t, F_HIST + 20)[i] = ts_of(e, i);
    if (f.valid && (bcol(e, TC_AMT_HI, i) != 0 || (f.postvoid && p_amt_hi != 0)))
      route |= R_U128;
    if (f.linked) route |= R_LINKED;
    if (ref >= 0 || f.postvoid) route |= R_INTRA;
    const bool in_chain = f.linked || (i > 0 && linked[i - 1]);
    if (in_chain && code != 0) {
      const bool dr_limf = (PTR(const uint32_t, F_DRT + V_FLAGS)[i] & 2u) &&
                           B8(F_DRT + V_FOUND, i);
      const bool cr_limf = (PTR(const uint32_t, F_CRT + V_FLAGS)[i] & 4u) &&
                           B8(F_CRT + V_FOUND, i);
      if (f.bal_dr || f.bal_cr || dr_limf || cr_limf || B8(F_NEAR_OV, i) ||
          balance_code(PTR(const uint32_t, F_PRE_CHAIN)[i]))
        route |= R_HAZARD;
    }
  }
  block_flags(e, route);
  grid_sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int fl = fold_flags(e);
    const int k = ctrl[C_K];
    const bool proved = B8(F_PROVED, 0);
    const int needed = PTR(const int, F_NEEDED)[0];
    const bool unconverged = !ctrl[C_EVER_STABLE] && !(proved && k >= needed);
    const bool linked_x_intra =
        (fl & R_LINKED) && (B8(F_ANY_DUP, 0) || (fl & R_INTRA));
    const bool route_seq = unconverged || (fl & R_U128) || linked_x_intra ||
                           (fl & R_HAZARD) || B8(F_ARITH, 0);
    PTR(int, F_ROUTE)[0] = route_seq ? 1 : 0;  // FLAG_SEQ
    PTR(int, F_PASSES)[0] = k;
    PTR(int, F_WAVE_BOUND)[0] = proved ? needed : 0;
  }
}

__global__ void __launch_bounds__(PASS_THREADS)
    full_pass_kernel(Env e, int mode, int aux) {
  if (mode == M_INIT) {
    mode_init(e);
    return;
  }
  if (!aux && !full_should_run(PTR(const int, F_CTRL), PTR(const uint8_t, F_PROVED),
                               PTR(const int, F_NEEDED)))
    return;  // every thread reads the same words: the whole grid returns
  if (mode == M_PRE) {
    mode_pre(e);
  } else {
    mode_post(e, aux);
  }
}

// Blocks of a cooperative launch of `kernel` over `n` lanes: one lane a
// thread, at most PASS_MAX_BLOCKS and what the card holds at once.
template <class K>
static int pass_blocks(K kernel, int n, int* resident, int* blocks) {
  if (*resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          PASS_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    *resident = sms * per_sm;
  }
  int b = (n + PASS_THREADS - 1) / PASS_THREADS;
  if (b > PASS_MAX_BLOCKS) b = PASS_MAX_BLOCKS;
  if (b > *resident) b = *resident;
  if (b < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks = b;
  return 0;
}

extern "C" int tb_full_pass(const void* const* ptrs, int nptrs, int mode,
                            int aux, int64_t n, int64_t count, uint64_t batch_ts,
                            int has_pv, int use_waves, int max_passes,
                            int64_t hsize, void* stream) {
  if (nptrs != F_NPTRS || n <= 0 || n > 8 * FULL_THREADS || count < 0 ||
      count > n || hsize < 2 * n || (hsize & (hsize - 1)) ||
      mode < M_INIT || mode > M_POST)
    return (int)cudaErrorInvalidValue;
  static int resident = 0;
  int blocks = 0;
  int err = pass_blocks(full_pass_kernel, (int)n, &resident, &blocks);
  if (err) return err;
  Env e;
  for (int k = 0; k < F_NPTRS; ++k) e.a.p[k] = ptrs[k];
  e.n = (int)n;
  e.count = (int)count;
  e.has_pv = has_pv;
  e.use_waves = use_waves;
  e.max_passes = max_passes;
  e.hsize = (int)hsize;
  e.batch_ts = batch_ts;
  void* args[] = {&e, &mode, &aux};
  return (int)cudaLaunchCooperativeKernel((const void*)full_pass_kernel,
                                          dim3((unsigned)blocks),
                                          dim3(PASS_THREADS), args, 0,
                                          (cudaStream_t)stream);
}

// The history append (create_transfers_full_impl, :1408-1424): where the
// batch commits (*gate == 0), each lane that records history writes its row
// at count + its exclusive prefix in lane order; rows past the capacity are
// dropped, and the count grows by every such lane.  The prefix is two-level:
// a block scan, then the block totals before it (`part`, one word a block,
// after the grid barrier).
__global__ void __launch_bounds__(PASS_THREADS)
    full_hist_kernel(const int* __restrict__ gate,
                     const uint8_t* __restrict__ do_hist, int n, Ptrs rows,
                     Ptrs cols, int64_t capacity, uint64_t* __restrict__ count,
                     int* __restrict__ part) {
  __shared__ int shint[32];
  if (*gate != 0) return;  // the whole grid returns
  const Lanes L = grid_lanes(n);
  int local = 0;
  for (int j = L.lo; j < L.hi; ++j) local += do_hist[j] ? 1 : 0;
  int total = 0;
  int off = block_scan_excl(local, 0, OpSum(), shint, &total);
  if (threadIdx.x == 0) part[blockIdx.x] = total;
  const uint64_t base = *count;  // every thread reads it before it grows
  grid_sync();
  int all = 0;
  for (int b = 0; b < (int)gridDim.x; ++b) {
    const int t = ldcg32(part, b);
    if (b < (int)blockIdx.x) off += t;
    all += t;
  }
  for (int j = L.lo; j < L.hi; ++j) {
    if (!do_hist[j]) continue;
    const uint64_t at = base + (uint64_t)off++;
    if (at >= (uint64_t)capacity) continue;
    for (int c = 0; c < 21; ++c) {
      static_cast<uint64_t*>(const_cast<void*>(cols.p[c]))[at] =
          static_cast<const uint64_t*>(rows.p[c])[j];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *count = base + (uint64_t)all;
}

extern "C" int tb_full_hist(const void* gate, const void* do_hist, int64_t n,
                            const void* const* rows, const void* const* cols,
                            int64_t capacity, void* count, void* part,
                            void* stream) {
  if (n <= 0 || n > 8 * FULL_THREADS) return (int)cudaErrorInvalidValue;
  static int resident = 0;
  int blocks = 0;
  int err = pass_blocks(full_hist_kernel, (int)n, &resident, &blocks);
  if (err) return err;
  Ptrs r, c;
  err = pack_ptrs(&r, 21, rows);
  if (!err) err = pack_ptrs(&c, 21, cols);
  if (err) return err;
  int ni = (int)n;
  void* args[] = {(void*)&gate, (void*)&do_hist, &ni, &r, &c, &capacity,
                  &count, &part};
  return (int)cudaLaunchCooperativeKernel((const void*)full_hist_kernel,
                                          dim3((unsigned)blocks),
                                          dim3(PASS_THREADS), args, 0,
                                          (cudaStream_t)stream);
}
