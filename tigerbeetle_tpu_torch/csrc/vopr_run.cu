// K29 vopr_run: whole schedules, one block per cluster, every step on the
// chip.
//
// Replaces tigerbeetle_tpu/sim/vopr_tpu.py:702 _one_cluster_fn, :724 run
// and :741 run_sharded (+ :737, the cluster keys): block c derives its key
// as split(PRNGKey(seed), n)[base + c] (a split's key does not depend on
// n), starts from make_state, then runs n_steps of
//   key, sub = split(key); faults = draw_faults(sub); state = step(state)
// with vopr.cuh's vopr_draw (K27's device function) and vopr_step (K28's).
// The state lives in registers (the replica scalars and the thread's slot
// column) for the whole run; the canonical commit list, which grows with
// the run (max_ops = n_steps + 2), lives in shared memory up to
// VOPR_SHARED_MAX_OPS ops and in device memory beyond (a zeroed (n,
// max_ops) buffer from the wrapper; a 20,000-step run of 4,096 clusters
// needs 328 MB).  Out: each cluster's violation flag, and on request the
// final state in sim/vopr_tpu.py's ClusterState layout.
//
// The draws run ahead of the steps, VOPR_CHUNK steps at a time.  Warp 0
// walks the key chain, key_{t+1} = split(key_t)[0], one hash a step; lane
// j keeps key_{t+j}, draws step t + j from split(key_{t+j})[1] and writes
// it into a ring of VoprFaults in shared memory; one barrier, then the
// block runs the chunk's steps, step t + j reading ring[j].  Every draw is
// the reference's, in its order; each is made once, by one lane.
//
// What bounds it on the H100: integer operations, n x n_steps x (about 80
// a threefry hash x (32 + 14R) hashes + the step's R^2 S scan and R S
// element phases), against 132 SMs x 64 INT32 lanes x 1.98 GHz; nothing
// but the flags leaves the chip.  The design runs one block of S threads a
// cluster, thousands resident at once, so the card is filled by clusters
// while each step's chain of barriers (vopr.cuh) sets a block's latency;
// the draws, a lane a step, cost a warp about 1 + (31 + 14R) / 32 hashes a
// step.  What a step issues is then the step's own code (a few thousand
// instructions a warp at R = 3), so resident warps set the rate: a
// one-warp cluster (S <= 32) of R >= 2 launches with at most 128
// registers a thread (16 clusters on a SM; unbounded, the compiler takes
// 169 at R = 3 and 8 fit), and fewer registers spill and lose more than
// the warps gain (PERF.md §6).  R = 1 keeps the unbounded kernel: under
// the bound the compiler takes 80 registers in place of 40, 24 clusters
// fit a SM in place of 32, and a run is 0.9-1.5 % slower (PERF.md §6, R9).
#include "vopr.cuh"

#define VOPR_CHUNK 32
#define VOPR_WARP_BLOCKS 16

template <int R>
static __device__ __forceinline__ void vopr_run_body(
    TfKey seed, uint64_t base, int S, int n_steps, int bug, VoprDrawConsts dc,
    uint8_t* __restrict__ violated, VoprStatePtrs out, int want_state,
    uint32_t* canon_global) {
  extern __shared__ uint32_t vopr_canon_smem[];
  __shared__ VoprShared sh;
  __shared__ VoprFaults ring[VOPR_CHUNK];
  const int64_t c = blockIdx.x;
  const int s = threadIdx.x;
  const int max_ops = n_steps + 2;
  uint32_t* canon = canon_global ? canon_global + c * (int64_t)max_ops
                                 : vopr_canon_smem;
  if (!canon_global)
    for (int i = threadIdx.x; i < max_ops; i += blockDim.x) canon[i] = 0;
  VoprReplicas<R> st = {};
  VoprColumn<R> col = {};
  TfKey key = tf_split(seed, base + (uint64_t)c);  // warp 0's chain
  for (int t = 0; t < n_steps; t += VOPR_CHUNK) {
    const int len = imin(VOPR_CHUNK, n_steps - t);
    // Every thread read the ring's last chunk before the closing barrier
    // of that chunk's last step, so warp 0 may overwrite it now.
    if (threadIdx.x < VOPR_CHUNK) {
      TfKey mine = key;
      for (int j = 0; j < len; ++j) {
        if (j == threadIdx.x) mine = key;
        key = tf_split(key, 0);
      }
      if (threadIdx.x < len)
        ring[threadIdx.x] = vopr_draw<R>(tf_split(mine, 1), dc);
    }
    __syncthreads();
    for (int j = 0; j < len; ++j)
      vopr_step<R>(st, col, s, S, max_ops, bug, ring[j], canon, &sh);
  }
  if (threadIdx.x == 0) violated[c] = st.violated ? 1 : 0;
  if (want_state) {
    vopr_store<R>(out, c, s, S, st, col);
    if (!canon_global)
      for (int i = threadIdx.x; i < max_ops; i += blockDim.x)
        out.canonical[c * (int64_t)max_ops + i] = canon[i];
  }
}

#define VOPR_RUN_PARAMS                                                    \
  TfKey seed, uint64_t base, int S, int n_steps, int bug, VoprDrawConsts dc, \
      uint8_t* __restrict__ violated, VoprStatePtrs out, int want_state,     \
      uint32_t* canon_global
#define VOPR_RUN_ARGS \
  seed, base, S, n_steps, bug, dc, violated, out, want_state, canon_global

template <int R>
__global__ void __launch_bounds__(VOPR_MAX_S)
    vopr_run_kernel(VOPR_RUN_PARAMS) {
  vopr_run_body<R>(VOPR_RUN_ARGS);
}

// A one-warp cluster (S <= 32), R >= 2: at most 65,536 / (32 x
// VOPR_WARP_BLOCKS) = 128 registers a thread.
template <int R>
__global__ void __launch_bounds__(32, VOPR_WARP_BLOCKS)
    vopr_run_warp_kernel(VOPR_RUN_PARAMS) {
  vopr_run_body<R>(VOPR_RUN_ARGS);
}

typedef void (*VoprRunKernel)(TfKey, uint64_t, int, int, int, VoprDrawConsts,
                              uint8_t*, VoprStatePtrs, int, uint32_t*);

template <int R>
static VoprRunKernel run_kernel_r(int S) {
  if constexpr (R > 1)
    if (S <= 32) return vopr_run_warp_kernel<R>;
  return vopr_run_kernel<R>;
}

static VoprRunKernel run_kernel(int R, int S) {
  switch (R) {
    case 1: return run_kernel_r<1>(S);
    case 2: return run_kernel_r<2>(S);
    case 3: return run_kernel_r<3>(S);
    case 4: return run_kernel_r<4>(S);
    case 5: return run_kernel_r<5>(S);
    default: return run_kernel_r<6>(S);
  }
}

static int run_threads(int S) { return (S + 31) / 32 * 32; }

static size_t run_smem(int n_steps, bool canon_global) {
  return canon_global ? 0 : (size_t)(n_steps + 2) * sizeof(uint32_t);
}

extern "C" int tb_vopr_run(uint32_t k0, uint32_t k1, uint64_t base, int64_t n,
                           int n_steps, int R, int S, const uint64_t* consts,
                           int bug, void* violated, void* const* state_out,
                           void* canon_global, void* stream) {
  if (n < 0 || n > 0x7FFFFFFF || n_steps < 0 || n_steps > 0x7FFFFFF0 ||
      R < 1 || R > VOPR_MAX_R || S < 1 || S > VOPR_MAX_S || bug < BUG_NONE ||
      bug > BUG_SCRUB_OFF)
    return (int)cudaErrorInvalidValue;
  if (n_steps + 2 > VOPR_SHARED_MAX_OPS && canon_global == nullptr)
    return (int)cudaErrorInvalidValue;
  VoprDrawConsts dc;
  if (!vopr_draw_consts(consts, R, S, dc)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  VoprStatePtrs out = {};
  if (state_out) {
    for (int k = 0; k < 8; ++k) out.rep[k] = static_cast<int32_t*>(state_out[k]);
    out.log = static_cast<uint32_t*>(state_out[S_LOG]);
    out.log_hdr = static_cast<uint32_t*>(state_out[S_LOG_HDR]);
    out.log_op = static_cast<int32_t*>(state_out[S_LOG_OP]);
    out.part_active = static_cast<uint8_t*>(state_out[S_PART_ACTIVE]);
    out.side = static_cast<int32_t*>(state_out[S_SIDE]);
    out.canonical = static_cast<uint32_t*>(state_out[S_CANONICAL]);
    out.violated = static_cast<uint8_t*>(state_out[S_VIOLATED]);
  }
  uint32_t* cg = static_cast<uint32_t*>(canon_global);
  run_kernel(R, S)<<<(unsigned)n, run_threads(S), run_smem(n_steps, cg),
                  static_cast<cudaStream_t>(stream)>>>(
      TfKey{k0, k1}, base, S, n_steps, bug, dc, static_cast<uint8_t*>(violated),
      out, state_out != nullptr, cg);
  return (int)cudaGetLastError();
}

// What the compiler and the card make of a launch's kernel: out[0]
// registers a thread, out[1] local memory a thread in bytes (spills and
// stack), out[2] static shared memory, out[3] threads a block, out[4]
// dynamic shared memory, out[5] blocks resident on one SM.
extern "C" int tb_vopr_run_info(int R, int S, int n_steps, int canon_global,
                                int* out) {
  if (R < 1 || R > VOPR_MAX_R || S < 1 || S > VOPR_MAX_S || n_steps < 0)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, (const void*)run_kernel(R, S));
  if (err != cudaSuccess) return (int)err;
  const int threads = run_threads(S);
  const size_t smem = run_smem(n_steps, canon_global != 0);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, (const void*)run_kernel(R, S), threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = threads;
  out[4] = (int)smem;
  out[5] = blocks;
  return 0;
}
