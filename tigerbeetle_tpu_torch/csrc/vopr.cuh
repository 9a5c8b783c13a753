// The batched VOPR's state layout, fault draws and step as device functions,
// shared by K27 vopr_draw (csrc/vopr_draw.cu), K28 vopr_step
// (csrc/vopr_step.cu) and K29 vopr_run (csrc/vopr_run.cu).
//
// Replaces tigerbeetle_tpu/sim/vopr_tpu.py:160 draw_faults and :217 step
// (vmapped over clusters at :738); sim/vopr_tpu.py's step_plain is the same
// model in plain PyTorch, and its comments number the phases as here.
//
// Design: one block per cluster, one THREAD PER RING SLOT.  Every
// cross-replica read of the rings in the model is column-local: a joiner,
// a state sync and a view-change install copy whole rows from another
// replica, a slot repair and the checksum repair read other replicas' copy
// of the SAME slot.  So thread s keeps column s of log, log_hdr and log_op
// (R values each) in registers, and computes each phase's new column from
// the old one in registers: no shared ring, no read-after-write hazard
// between replicas that install from each other in one step.  The
// per-replica scalars (status, view, ..., side) are small (9R ints), and
// every thread keeps and updates its own identical copy (uniform across the
// block), so the scalar phases need no barrier either.  Only four things
// cross columns, each through shared memory between barriers:
//   - the first mismatching op per replica (a min over slots), twice;
//   - the slot gathers log_op[prim][target % S] and log[r][(commit+1) % S];
//   - the canonical commit list (first writer wins, the max of a step's
//     proposals as u32 by atomicMax, after every thread read the old
//     value), in shared memory or, for long runs, in device memory;
//   - the violation flag (__syncthreads_or).
// R is a template parameter (1..6), so the per-replica arrays stay in
// registers; a gather by a runtime replica index is a select over R
// (pick), never a dynamic register index.
//
// The draws do not depend on the state: step t's faults come from the t-th
// key of the cluster's key chain alone.  So vopr_step takes them drawn
// (VoprFaults), and the kernels draw them where that is cheapest: K27 one
// key a thread, K28 reads K27's, and K29 draws 32 steps at once, one step
// a lane of one warp, into a ring in shared memory (vopr_run.cu).  The
// draws use integers only (threefry.cuh): thresholds and span multipliers
// the host computes once a launch (VoprDrawConsts).
//
// What bounds it on the H100: integer operations (the byte traffic of a
// cluster is its few KB of state, read once and written once).  Per
// cluster-step about 80 operations a threefry hash times 32 + 14R hashes,
// each done once, plus the (r, donor, slot) checksum scan, R^2 S, and the
// R S element phases (chip_smoke.py's vopr_ops counts them); against 132
// SMs x 64 INT32 lanes x 1.98 GHz.  The step itself is latency-bound: a
// chain of dependent phases with ~10 barriers, and a cluster has only S
// threads; the card is filled by running one block per cluster, thousands
// at once.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

#define VOPR_MAX_R 6
// At most this many slots, so at most this many threads a block.  K28 and
// K29 carry __launch_bounds__(VOPR_MAX_S): 65,536 registers a block over
// 256 threads leaves the compiler's own ceiling of 255 a thread, so the
// bound changes no code, and a block of VOPR_MAX_S threads launches at
// every R whatever registers the step takes.  (K29's one-warp clusters
// have their own, tighter bound: vopr_run.cu.)
#define VOPR_MAX_S 256
// K29 keeps the canonical list in shared memory up to this many ops.
#define VOPR_SHARED_MAX_OPS 1024

// sim/vopr_tpu.py BUG_CODES.
enum VoprBug {
  BUG_NONE = 0,
  BUG_COMMIT_QUORUM = 1,
  BUG_CANONICAL_BY_OP = 2,
  BUG_NO_TRUNCATE = 3,
  BUG_CORRUPT_SERVE = 4,
  BUG_WAL_WRAP = 5,
  BUG_SPLIT_BRAIN = 6,
  BUG_AMPUTATE_VOUCH = 7,
  BUG_JOIN_KEEP_STALE = 8,
  BUG_SCRUB_OFF = 9,
};

// sim/vopr_tpu.py FAULT_FIELDS: bool as one byte, *_slot, part_mode and
// part_lone int64, part_side int32.
enum VoprFaultField {
  F_SDC, F_SDC_SLOT, F_CRASH, F_RESTART, F_CORRUPT_GATE, F_CORRUPT_SLOT,
  F_AMPUTATE, F_REPART, F_PART_MODE, F_PART_LONE, F_PART_SIDE, F_APPEND,
  F_LINK, F_VC, F_SYNC, F_COUNT
};

// sim/vopr_tpu.py STATE_FIELDS (ClusterState): i32, u32 rings, bool.
enum VoprStateField {
  S_STATUS, S_VIEW, S_LOG_VIEW, S_OP, S_COMMIT, S_CHECKPOINT, S_ADOPTED_OP,
  S_DURABLE_OP, S_LOG, S_LOG_HDR, S_LOG_OP, S_PART_ACTIVE, S_SIDE,
  S_CANONICAL, S_VIOLATED, S_COUNT
};

// sim/vopr_tpu.py PROBS, in order.
enum VoprProb {
  P_CRASH, P_RESTART, P_APPEND, P_LINK, P_VIEW_CHANGE, P_CORRUPT,
  P_REPARTITION, P_AMPUTATE, P_SDC, P_COUNT
};

// A launch's draw constants (sim/vopr_tpu.py draw_consts, in this order):
// the Bernoulli threshold of each probability (threefry.cuh tf_bernoulli),
// then the randint spans S (the slots), 4 (the partition mode) and R (the
// lone replica).
struct VoprDrawConsts {
  uint64_t gate[P_COUNT];
  TfSpan slot, mode, lone;
};

// From the host's u64 words: a threshold a probability, then (magic, d,
// r32, mult) a span.  False when a span is not (S, 4, R).
static inline bool vopr_draw_consts(const uint64_t* w, int R, int S,
                                    VoprDrawConsts& c) {
  for (int k = 0; k < P_COUNT; ++k) c.gate[k] = w[k];
  TfSpan* spans[3] = {&c.slot, &c.mode, &c.lone};
  const uint64_t want[3] = {(uint64_t)S, 4, (uint64_t)R};
  for (int k = 0; k < 3; ++k) {
    const uint64_t* x = w + P_COUNT + 4 * k;
    if (x[1] != want[k]) return false;
    *spans[k] = TfSpan{x[0], (uint32_t)x[1], (uint32_t)x[2], (uint32_t)x[3]};
  }
  return true;
}

// One cluster's draws.  Bit r of a mask is replica r; a slot outside
// 0..S-1 (only from a caller's own faults) is -1, which no slot equals.
struct VoprFaults {
  uint32_t sdc, crash, restart, corrupt_gate, amputate, append, link, vc, sync;
  int sdc_slot[VOPR_MAX_R], corrupt_slot[VOPR_MAX_R], part_side[VOPR_MAX_R];
  bool repart;
  int part_mode, part_lone;
};

// Pointers of a batch of states (device memory), in VoprStateField order.
struct VoprStatePtrs {
  int32_t* rep[8];  // status .. durable_op, (N, R)
  uint32_t* log;    // (N, R, S)
  uint32_t* log_hdr;
  int32_t* log_op;
  uint8_t* part_active;  // (N,)
  int32_t* side;         // (N, R)
  uint32_t* canonical;   // (N, max_ops)
  uint8_t* violated;     // (N,)
};

struct VoprFaultPtrs {
  const void* f[F_COUNT];
};

// Block-shared scratch of one cluster (all threads see one copy).
struct VoprShared {
  int first_bad[VOPR_MAX_R];
  int t_lop[VOPR_MAX_R];
  uint32_t e_k[VOPR_MAX_R];
  int e_k_op[VOPR_MAX_R];
};

template <int R>
struct VoprReplicas {
  int status[R], view[R], log_view[R], op[R], commit[R], checkpoint[R],
      adopted_op[R], durable_op[R], side[R];
  bool part_active, violated;
};

template <int R>
struct VoprColumn {  // one ring slot s of every replica
  uint32_t log[R], hdr[R];
  int lop[R];
};

static const uint32_t VOPR_CORRUPT = 0x80000001u;
static const int VOPR_INF = 1 << 28;

static __device__ __forceinline__ bool vbit(uint32_t m, int r) {
  return (m >> r) & 1u;
}

// a[i] for a runtime i in 0..R-1, as a select (registers stay registers).
template <int R, typename T>
static __device__ __forceinline__ T pick(const T (&a)[R], int i) {
  T v = a[0];
#pragma unroll
  for (int k = 1; k < R; ++k) v = (i == k) ? a[k] : v;
  return v;
}

static __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
static __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// vsr/consensus.py quorums (copied to tigerbeetle_tpu_torch/vsr/consensus.py).
static __device__ __forceinline__ void vopr_quorums(int R, int& q_repl,
                                                    int& q_view) {
  if (R == 1) {
    q_repl = 1;
    q_view = 1;
    return;
  }
  const int majority = R / 2 + 1;
  q_repl = imax(2, R + 1 - majority);
  q_view = imax(majority, R + 1 - q_repl);
}

// sim/vopr_tpu.py _entry: u32 wrapping products.
static __device__ __forceinline__ uint32_t vopr_entry(int view, int op) {
  const uint32_t h = ((uint32_t)view * 2654435761u) ^ ((uint32_t)op * 40503u);
  return (h & 0x7FFFFFFFu) | 1u;
}

// ---------------------------------------------------------------------------
// draw_faults (K27's device function; K29 calls it once a step, in a lane)
// ---------------------------------------------------------------------------

template <int R>
static __device__ __forceinline__ VoprFaults vopr_draw(TfKey key,
                                                       const VoprDrawConsts& c) {
  // split(key, 10): crash, restart, cgate, cslot, part, append, link, vc,
  // sync, amp; split(k_part, 4): pm, pg, ps, pw; split(fold_in(key, 0x5DC)).
  const TfKey k_crash = tf_split(key, 0), k_restart = tf_split(key, 1),
              k_cgate = tf_split(key, 2), k_cslot = tf_split(key, 3),
              k_part = tf_split(key, 4), k_append = tf_split(key, 5),
              k_link = tf_split(key, 6), k_vc = tf_split(key, 7),
              k_sync = tf_split(key, 8), k_amp = tf_split(key, 9);
  const TfKey k_pm = tf_split(k_part, 0), k_pg = tf_split(k_part, 1),
              k_ps = tf_split(k_part, 2), k_pw = tf_split(k_part, 3);
  const TfKey k_sdc = tf_fold_in(key, 0x5DC);
  const TfKey k_sdc_gate = tf_split(k_sdc, 0), k_sdc_slot = tf_split(k_sdc, 1);
  const TfKey sdc_s0 = tf_split(k_sdc_slot, 0), sdc_s1 = tf_split(k_sdc_slot, 1);
  const TfKey cs_s0 = tf_split(k_cslot, 0), cs_s1 = tf_split(k_cslot, 1);
  const uint64_t* g = c.gate;
  VoprFaults f;
  f.sdc = f.crash = f.restart = f.corrupt_gate = f.amputate = 0;
  f.append = f.link = f.vc = f.sync = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t b = 1u << r;
    if (tf_bernoulli(k_sdc_gate, r, g[P_SDC])) f.sdc |= b;
    if (tf_bernoulli(k_crash, r, g[P_CRASH])) f.crash |= b;
    if (tf_bernoulli(k_restart, r, g[P_RESTART])) f.restart |= b;
    if (tf_bernoulli(k_cgate, r, g[P_CORRUPT])) f.corrupt_gate |= b;
    if (tf_bernoulli(k_amp, r, g[P_AMPUTATE])) f.amputate |= b;
    if (tf_bernoulli(k_append, r, g[P_APPEND])) f.append |= b;
    if (tf_bernoulli(k_link, r, g[P_LINK])) f.link |= b;
    if (tf_bernoulli(k_vc, r, g[P_VIEW_CHANGE])) f.vc |= b;
    if (tf_bernoulli(k_sync, r, TF_HALF)) f.sync |= b;
    f.part_side[r] = tf_bernoulli(k_ps, r, TF_HALF) ? 1 : 0;
    f.sdc_slot[r] = tf_randint_split(sdc_s0, sdc_s1, r, c.slot);
    f.corrupt_slot[r] = tf_randint_split(cs_s0, cs_s1, r, c.slot);
  }
  f.repart = tf_bernoulli(k_pg, 0, g[P_REPARTITION]);
  f.part_mode = tf_randint(k_pm, 0, c.mode);
  f.part_lone = tf_randint(k_pw, 0, c.lone);
  return f;
}

// ---------------------------------------------------------------------------
// step (K28 and K29): every thread of the block calls it; thread s < S owns
// column s.  canon points at the cluster's canonical list (shared or device
// memory).
// ---------------------------------------------------------------------------

template <int R>
static __device__ void vopr_step(VoprReplicas<R>& st, VoprColumn<R>& col,
                                 const int s, const int S, const int max_ops,
                                 const int bug, const VoprFaults& f,
                                 uint32_t* canon, VoprShared* sh) {
  const bool has = s < S;
  int q_repl, q_view;
  vopr_quorums(R, q_repl, q_view);
  if (bug == BUG_COMMIT_QUORUM) q_repl = imax(1, q_repl - 1);
  if (bug == BUG_SPLIT_BRAIN) q_view = 1;
  const int ckpt_interval = imax(1, S / 2);
  int commit0[R];
#pragma unroll
  for (int r = 0; r < R; ++r) commit0[r] = st.commit[r];

  // 1. Crashes and restarts, crash-time corruption, suffix amputation.
  bool crash[R], alive[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    crash[r] = vbit(f.crash, r) && st.status[r] == 0;
    const bool restart = vbit(f.restart, r) && st.status[r] == 1;
    st.status[r] = crash[r] ? 1 : (restart ? 0 : st.status[r]);
    if (has && vbit(f.corrupt_gate, r) && crash[r] && s == f.corrupt_slot[r] &&
        col.lop[r] >= 1)
      col.log[r] = VOPR_CORRUPT;
    const bool amputate = vbit(f.amputate, r) && crash[r];
    const int amp_floor = imax(st.commit[r], st.durable_op[r]);
    if (has && amputate && col.lop[r] > amp_floor && col.lop[r] <= st.op[r]) {
      col.log[r] = 0;
      col.hdr[r] = 0;
      col.lop[r] = 0;
    }
    if (amputate) st.op[r] = amp_floor;
    alive[r] = st.status[r] == 0;
  }

  // 1b. Silent SDC, then the scrub.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (has && vbit(f.sdc, r) && alive[r] && s == f.sdc_slot[r] &&
        col.lop[r] >= 1 && col.log[r] != 0 && col.log[r] != VOPR_CORRUPT)
      col.log[r] ^= 2u;
    if (bug != BUG_SCRUB_OFF && col.log[r] != col.hdr[r] && col.log[r] != 0 &&
        col.hdr[r] != 0 && col.log[r] != VOPR_CORRUPT)
      col.log[r] = VOPR_CORRUPT;
  }

  // 2. Partitions.
  if (f.repart) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      st.side[r] = f.part_mode == 2 ? (r == f.part_lone ? 1 : 0) : f.part_side[r];
    st.part_active = f.part_mode >= 2;
  }
  bool conn[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j)
      conn[i][j] = !st.part_active || st.side[i] == st.side[j] || i == j;

  // 3. Perceived views.
  int perceived[R], prim[R];
  bool connP[R], aliveP[R], p_current_for[R], acting[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    int m = 0;
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (conn[i][j] && alive[j]) m = imax(m, st.view[j]);
    perceived[i] = imax(m, st.view[i]);
    prim[i] = perceived[i] % R;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    connP[i] = false;
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (prim[i] == j) connP[i] = conn[i][j];
    aliveP[i] = pick<R>(alive, prim[i]);
    const bool currentP = pick<R>(st.log_view, prim[i]) == perceived[i];
    p_current_for[i] = aliveP[i] && currentP && connP[i];
    acting[i] = alive[i] && prim[i] == i && st.log_view[i] == perceived[i];
  }

  // 4. Joiner install (rows of the primary, as they were).
  {
    bool joiner[R];
    int opP[R], ckptP[R];
    uint32_t lp[R], hp[R];
    int lopp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      joiner[r] = alive[r] && st.log_view[r] < perceived[r] && p_current_for[r] &&
                  vbit(f.link, r);
      opP[r] = pick<R>(st.op, prim[r]);
      ckptP[r] = pick<R>(st.checkpoint, prim[r]);
      lp[r] = pick<R>(col.log, prim[r]);
      hp[r] = pick<R>(col.hdr, prim[r]);
      lopp[r] = pick<R>(col.lop, prim[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (bug == BUG_JOIN_KEEP_STALE) {
        if (joiner[r] && col.log[r] == 0) {
          col.log[r] = lp[r];
          col.hdr[r] = hp[r];
          col.lop[r] = lopp[r];
        }
      } else if (bug != BUG_NO_TRUNCATE && joiner[r]) {
        col.log[r] = lp[r];
        col.hdr[r] = hp[r];
        col.lop[r] = lopp[r];
      }
      if (bug != BUG_NO_TRUNCATE && joiner[r]) {
        st.op[r] = opP[r];
        st.checkpoint[r] = imax(st.checkpoint[r], ckptP[r]);
      }
      if (joiner[r]) {
        st.log_view[r] = perceived[r];
        st.view[r] = perceived[r];
        st.adopted_op[r] = opP[r];
        st.durable_op[r] = imin(st.durable_op[r], st.op[r]);
      }
    }
  }

  // 5. Acting primaries append.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int new_op = st.op[r] + 1;
    const bool floor_ok = bug == BUG_WAL_WRAP || new_op - st.checkpoint[r] <= S;
    const bool can_append =
        acting[r] && floor_ok && new_op < max_ops - 1 && vbit(f.append, r);
    if (can_append) {
      if (has && s == new_op % S) {
        const uint32_t e = vopr_entry(perceived[r], new_op);
        col.log[r] = e;
        col.hdr[r] = e;
        col.lop[r] = new_op;
      }
      st.op[r] = new_op;
      st.durable_op[r] = new_op;
    }
  }

  // 6. Primary self-repair by checksum: the (r, donor) scan of this slot.
  {
    uint32_t donor_entry[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      donor_entry[r] = 0;
#pragma unroll
      for (int d = 0; d < R; ++d) {
        const bool ok = alive[d] && conn[r][d] && col.lop[d] == col.lop[r] &&
                        col.log[d] != VOPR_CORRUPT && col.log[d] != 0 &&
                        (bug == BUG_CORRUPT_SERVE || col.log[d] == col.hdr[r]);
        if (ok && col.log[d] > donor_entry[r]) donor_entry[r] = col.log[d];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (acting[r] && col.log[r] == VOPR_CORRUPT && donor_entry[r] != 0)
        col.log[r] = donor_entry[r];
  }

  // 7. Matching prefix against the perceived primary (min over slots).
  int opP[R], ckptP[R], first_bad[R], prefix_ok[R];
  uint32_t lp[R];
  int lopP[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    opP[r] = pick<R>(st.op, prim[r]);
    ckptP[r] = pick<R>(st.checkpoint, prim[r]);
    lp[r] = pick<R>(col.log, prim[r]);
    lopP[r] = pick<R>(col.lop, prim[r]);
  }
  auto prefix = [&](const uint32_t (&lP)[R], const int (&loP)[R],
                    const int (&oP)[R]) {
    if (threadIdx.x < R) sh->first_bad[threadIdx.x] = VOPR_INF;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      bool differs = col.log[r] != lP[r];
      if (bug == BUG_CORRUPT_SERVE) differs = differs && col.log[r] != VOPR_CORRUPT;
      bool mismatch = differs && loP[r] >= 1;
      if (bug != BUG_WAL_WRAP) mismatch = mismatch || (col.lop[r] != loP[r] && loP[r] >= 1);
      if (bug == BUG_JOIN_KEEP_STALE) mismatch = col.log[r] == 0 && loP[r] >= 1;
      if (has && mismatch) atomicMin(&sh->first_bad[r], loP[r]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      first_bad[r] = sh->first_bad[r];
      prefix_ok[r] = imin(first_bad[r] - 1, oP[r]);
    }
    __syncthreads();  // first_bad is reset before its next use
  };
  prefix(lp, lopP, opP);

  // 8. Backup repair: slot sync, or state sync past the floor.
  bool is_backup[R];
  int target[R], t_slot[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    is_backup[r] = alive[r] && !acting[r] && p_current_for[r] &&
                   st.log_view[r] == perceived[r];
    target[r] = imin(first_bad[r], st.op[r] + 1);
    t_slot[r] = target[r] % S;
    if (has && s == t_slot[r]) sh->t_lop[r] = lopP[r];
  }
  __syncthreads();
  {
    bool reachable[R], t_in_ring[R], can_sync[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      t_in_ring[r] = bug == BUG_WAL_WRAP || sh->t_lop[r] == target[r];
      reachable[r] = is_backup[r] && vbit(f.link, r) && target[r] <= opP[r];
      can_sync[r] = reachable[r] && t_in_ring[r];
    }
    uint32_t hp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) hp[r] = pick<R>(col.hdr, prim[r]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (has && can_sync[r] && s == t_slot[r]) {
        col.log[r] = lp[r];
        col.hdr[r] = hp[r];
        col.lop[r] = bug == BUG_WAL_WRAP ? target[r] : lopP[r];
      }
      if (can_sync[r]) {
        const bool next = target[r] == st.durable_op[r] + 1;
        st.op[r] = imax(st.op[r], target[r]);
        if (next) st.durable_op[r] = target[r];
      }
    }
    // State sync: log and log_op as the primary's at the refresh above, the
    // headers as they are after the slot syncs.
#pragma unroll
    for (int r = 0; r < R; ++r) hp[r] = pick<R>(col.hdr, prim[r]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool state_sync = reachable[r] && !t_in_ring[r] && vbit(f.sync, r);
      if (state_sync) {
        col.log[r] = lp[r];
        col.hdr[r] = hp[r];
        col.lop[r] = lopP[r];
        st.op[r] = opP[r];
        st.checkpoint[r] = imax(st.checkpoint[r], ckptP[r]);
        st.commit[r] = imax(st.commit[r], ckptP[r]);
        st.adopted_op[r] = opP[r];
        st.durable_op[r] = opP[r];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    opP[r] = pick<R>(st.op, prim[r]);
    lp[r] = pick<R>(col.log, prim[r]);
    lopP[r] = pick<R>(col.lop, prim[r]);
  }
  prefix(lp, lopP, opP);

  // Body fetch.
  const int fetch_chunk = imax(1, S / 8);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (is_backup[r] && vbit(f.link, r) && first_bad[r] > st.op[r] &&
        st.durable_op[r] < st.op[r])
      st.durable_op[r] =
          imin(st.op[r], imax(st.durable_op[r], st.commit[r]) + fetch_chunk);

  // 9. Commit at a replication quorum of acks.
  {
    int k_op[R], ack_count[R];
    bool ack[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      k_op[r] = pick<R>(st.commit, prim[r]) + 1;
      ack[r] = alive[r] && st.log_view[r] == perceived[r] && connP[r] &&
               st.op[r] >= k_op[r];
      if (bug != BUG_NO_TRUNCATE)
        ack[r] = ack[r] && prefix_ok[r] >= k_op[r] && st.durable_op[r] >= k_op[r];
      ack_count[r] = 0;
    }
#pragma unroll
    for (int p = 0; p < R; ++p)
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (ack[r] && prim[r] == p) ack_count[p] += 1;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k_self = st.commit[r] + 1;
      if (has && s == k_self % S) {
        sh->e_k[r] = col.log[r];
        sh->e_k_op[r] = col.lop[r];
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k_self = st.commit[r] + 1;
      const uint32_t e_k = sh->e_k[r];
      bool entry_valid = sh->e_k_op[r] == k_self && e_k != 0;
      if (bug != BUG_CORRUPT_SERVE) entry_valid = entry_valid && e_k != VOPR_CORRUPT;
      if (acting[r] && k_self <= st.op[r] && ack_count[r] >= q_repl && entry_valid)
        st.commit[r] = k_self;
    }
  }

  // 10. Commit heartbeat (the primary's commit after step 9).
  {
    int hb[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int cP = pick<R>(st.commit, prim[r]);
      hb[r] = bug == BUG_NO_TRUNCATE ? cP
                                     : imin(imin(cP, prefix_ok[r]), st.durable_op[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (is_backup[r] && vbit(f.link, r) && connP[r])
        st.commit[r] = imax(st.commit[r], hb[r]);
  }

  // 11. Checkpoint advance.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int new_ckpt = (st.commit[r] / ckpt_interval) * ckpt_interval;
    if (alive[r] && st.commit[r] - st.checkpoint[r] >= ckpt_interval)
      st.checkpoint[r] = imax(st.checkpoint[r], new_ckpt);
  }

  // 12. View change.
  {
    bool svc[R], inst[R], participant[R][R];
    int donor[R], new_view[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool dead_prim = alive[r] && (!aliveP[r] || !connP[r]);
      svc[r] = dead_prim && vbit(f.vc, r);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int cnt = 0;
#pragma unroll
      for (int d = 0; d < R; ++d) {
        participant[r][d] = alive[d] && conn[r][d] && perceived[r] == perceived[d] && svc[d];
        const bool suspect = st.op[d] < st.adopted_op[d];
        if (participant[r][d] && (bug == BUG_AMPUTATE_VOUCH || !suspect)) cnt += 1;
      }
      const bool fire = svc[r] && cnt >= q_view;
      new_view[r] = perceived[r] + 1;
      inst[r] = fire && new_view[r] % R == r;
      // argmax of rank over donors, the first maximum.
      int64_t best = 0;
      donor[r] = 0;
#pragma unroll
      for (int d = 0; d < R; ++d) {
        const bool suspect = st.op[d] < st.adopted_op[d];
        const bool clean = participant[r][d] && (bug == BUG_AMPUTATE_VOUCH || !suspect);
        const int64_t penalty = clean ? 0 : (1ll << 60);
        int64_t rank = (int64_t)st.op[d] - penalty;
        if (bug != BUG_CANONICAL_BY_OP)
          rank += (int64_t)st.log_view[d] * (int64_t)(max_ops + S);
        if (d == 0 || rank > best) {
          best = rank;
          donor[r] = d;
        }
      }
    }
    uint32_t nlog[R], nhdr[R];
    int nlop[R], nop[R], ncommit[R], nckpt[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int d = donor[r];
      nlog[r] = inst[r] ? pick<R>(col.log, d) : col.log[r];
      nhdr[r] = inst[r] ? pick<R>(col.hdr, d) : col.hdr[r];
      nlop[r] = inst[r] ? pick<R>(col.lop, d) : col.lop[r];
      nop[r] = inst[r] ? pick<R>(st.op, d) : st.op[r];
      ncommit[r] = inst[r] ? imax(st.commit[r], pick<R>(st.commit, d)) : st.commit[r];
      nckpt[r] = inst[r] ? imax(st.checkpoint[r], pick<R>(st.checkpoint, d))
                         : st.checkpoint[r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      col.log[r] = nlog[r];
      col.hdr[r] = nhdr[r];
      col.lop[r] = nlop[r];
      st.op[r] = nop[r];
      st.commit[r] = ncommit[r];
      st.checkpoint[r] = nckpt[r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // As the reference: op[donor] after this step's install of op.
      if (inst[r]) {
        st.log_view[r] = new_view[r];
        st.adopted_op[r] = pick<R>(st.op, donor[r]);
        st.durable_op[r] = st.adopted_op[r];
      }
    }
#pragma unroll
    for (int d = 0; d < R; ++d) {
      bool bumped = inst[d];
#pragma unroll
      for (int r = 0; r < R; ++r) bumped = bumped || (inst[r] && participant[r][d]);
      if (bumped && alive[d]) st.view[d] = imax(st.view[d], new_view[d]);
    }
  }

  // 13. Safety oracle: the canonical commit list, first writer wins; the
  // max of a step's proposals for an op compares as u32.  Every op a model
  // run reaches is below max_ops - 1; the bound only keeps a foreign state
  // (K28's input) from indexing past the list.
  bool committed[R];
  uint32_t old[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int lo = col.lop[r];
    committed[r] = has && lo > commit0[r] && lo <= st.commit[r] && lo >= 1 &&
                   lo < max_ops &&
                   (bug == BUG_CORRUPT_SERVE || col.log[r] != VOPR_CORRUPT);
    old[r] = committed[r] ? canon[lo] : 1u;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (committed[r] && old[r] == 0) atomicMax(&canon[col.lop[r]], col.log[r]);
  __syncthreads();
  bool bad = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int lo = col.lop[r];
    if (committed[r] && canon[lo] != col.log[r]) bad = true;
    if (has && lo >= 1 && lo <= st.commit[r] && lo < max_ops &&
        col.log[r] != VOPR_CORRUPT) {
      const uint32_t want = canon[lo];
      if (want != 0 && want != col.log[r]) bad = true;
    }
  }
  if (__syncthreads_or(bad)) st.violated = true;
}

// ---------------------------------------------------------------------------
// Loading and storing cluster c of a batch.
// ---------------------------------------------------------------------------

template <int R>
static __device__ void vopr_load(const VoprStatePtrs& p, int64_t c, int s,
                                 int S, VoprReplicas<R>& st, VoprColumn<R>& col) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    st.status[r] = p.rep[0][c * R + r];
    st.view[r] = p.rep[1][c * R + r];
    st.log_view[r] = p.rep[2][c * R + r];
    st.op[r] = p.rep[3][c * R + r];
    st.commit[r] = p.rep[4][c * R + r];
    st.checkpoint[r] = p.rep[5][c * R + r];
    st.adopted_op[r] = p.rep[6][c * R + r];
    st.durable_op[r] = p.rep[7][c * R + r];
    st.side[r] = p.side[c * R + r];
    const bool has = s < S;
    const int64_t e = (c * R + r) * (int64_t)S + s;
    col.log[r] = has ? p.log[e] : 0u;
    col.hdr[r] = has ? p.log_hdr[e] : 0u;
    col.lop[r] = has ? p.log_op[e] : 0;
  }
  st.part_active = p.part_active[c] != 0;
  st.violated = p.violated[c] != 0;
}

template <int R>
static __device__ void vopr_store(const VoprStatePtrs& p, int64_t c, int s,
                                  int S, const VoprReplicas<R>& st,
                                  const VoprColumn<R>& col) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (s < S) {
      const int64_t e = (c * R + r) * (int64_t)S + s;
      p.log[e] = col.log[r];
      p.log_hdr[e] = col.hdr[r];
      p.log_op[e] = col.lop[r];
    }
    if (threadIdx.x == 0) {
      p.rep[0][c * R + r] = st.status[r];
      p.rep[1][c * R + r] = st.view[r];
      p.rep[2][c * R + r] = st.log_view[r];
      p.rep[3][c * R + r] = st.op[r];
      p.rep[4][c * R + r] = st.commit[r];
      p.rep[5][c * R + r] = st.checkpoint[r];
      p.rep[6][c * R + r] = st.adopted_op[r];
      p.rep[7][c * R + r] = st.durable_op[r];
      p.side[c * R + r] = st.side[r];
    }
  }
  if (threadIdx.x == 0) {
    p.part_active[c] = st.part_active ? 1 : 0;
    p.violated[c] = st.violated ? 1 : 0;
  }
}

// A slot value outside 0..S-1 as -1 (no slot equals it).
static __device__ __forceinline__ int vopr_slot(int64_t v, int S) {
  return (v >= 0 && v < S) ? (int)v : -1;
}

// Faults of cluster c from K27's layout (K28's input).
template <int R>
static __device__ VoprFaults vopr_faults_load(const VoprFaultPtrs& p,
                                              int64_t c, int S) {
  const uint8_t* b[F_COUNT];
#pragma unroll
  for (int k = 0; k < F_COUNT; ++k) b[k] = static_cast<const uint8_t*>(p.f[k]);
  const int64_t* sdc_slot = static_cast<const int64_t*>(p.f[F_SDC_SLOT]);
  const int64_t* corrupt_slot = static_cast<const int64_t*>(p.f[F_CORRUPT_SLOT]);
  const int32_t* part_side = static_cast<const int32_t*>(p.f[F_PART_SIDE]);
  VoprFaults f;
  f.sdc = f.crash = f.restart = f.corrupt_gate = f.amputate = 0;
  f.append = f.link = f.vc = f.sync = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t i = c * R + r;
    const uint32_t bit = 1u << r;
    if (b[F_SDC][i]) f.sdc |= bit;
    if (b[F_CRASH][i]) f.crash |= bit;
    if (b[F_RESTART][i]) f.restart |= bit;
    if (b[F_CORRUPT_GATE][i]) f.corrupt_gate |= bit;
    if (b[F_AMPUTATE][i]) f.amputate |= bit;
    if (b[F_APPEND][i]) f.append |= bit;
    if (b[F_LINK][i]) f.link |= bit;
    if (b[F_VC][i]) f.vc |= bit;
    if (b[F_SYNC][i]) f.sync |= bit;
    f.sdc_slot[r] = vopr_slot(sdc_slot[i], S);
    f.corrupt_slot[r] = vopr_slot(corrupt_slot[i], S);
    f.part_side[r] = part_side[i];
  }
  f.repart = b[F_REPART][c] != 0;
  const int64_t mode = static_cast<const int64_t*>(p.f[F_PART_MODE])[c];
  const int64_t lone = static_cast<const int64_t*>(p.f[F_PART_LONE])[c];
  f.part_mode = mode < 0 ? -1 : (mode > 3 ? 3 : (int)mode);
  f.part_lone = (lone >= 0 && lone < R) ? (int)lone : -1;
  return f;
}

// K27's output for key c.
template <int R>
static __device__ void vopr_faults_store(const VoprFaultPtrs& p, int64_t c,
                                         const VoprFaults& f) {
  uint8_t* b[F_COUNT];
#pragma unroll
  for (int k = 0; k < F_COUNT; ++k)
    b[k] = static_cast<uint8_t*>(const_cast<void*>(p.f[k]));
  int64_t* sdc_slot = reinterpret_cast<int64_t*>(b[F_SDC_SLOT]);
  int64_t* corrupt_slot = reinterpret_cast<int64_t*>(b[F_CORRUPT_SLOT]);
  int32_t* part_side = reinterpret_cast<int32_t*>(b[F_PART_SIDE]);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t i = c * R + r;
    b[F_SDC][i] = vbit(f.sdc, r);
    b[F_CRASH][i] = vbit(f.crash, r);
    b[F_RESTART][i] = vbit(f.restart, r);
    b[F_CORRUPT_GATE][i] = vbit(f.corrupt_gate, r);
    b[F_AMPUTATE][i] = vbit(f.amputate, r);
    b[F_APPEND][i] = vbit(f.append, r);
    b[F_LINK][i] = vbit(f.link, r);
    b[F_VC][i] = vbit(f.vc, r);
    b[F_SYNC][i] = vbit(f.sync, r);
    sdc_slot[i] = f.sdc_slot[r];
    corrupt_slot[i] = f.corrupt_slot[r];
    part_side[i] = f.part_side[r];
  }
  b[F_REPART][c] = f.repart ? 1 : 0;
  reinterpret_cast<int64_t*>(b[F_PART_MODE])[c] = f.part_mode;
  reinterpret_cast<int64_t*>(b[F_PART_LONE])[c] = f.part_lone;
}
