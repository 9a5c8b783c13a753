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
// What bounds it on the H100: integer operations, n x n_steps x (about 80
// a threefry hash x (32 + 14R) hashes + the step's R^2 S scan and R S
// element phases), against 132 SMs x 64 INT32 lanes x 1.98 GHz; nothing
// but the flags leaves the chip.  The design runs one block of S threads a
// cluster, thousands resident at once, so the card is filled by clusters
// while each step's chain of barriers (vopr.cuh) sets a block's latency.
#include "vopr.cuh"

template <int R>
__global__ void __launch_bounds__(VOPR_MAX_S)
    vopr_run_kernel(TfKey seed, uint64_t base, int S, int n_steps, int bug,
                    VoprProbs probs, uint8_t* __restrict__ violated,
                    VoprStatePtrs out, int want_state,
                    uint32_t* canon_global) {
  extern __shared__ uint32_t vopr_canon_smem[];
  __shared__ VoprShared sh;
  const int64_t c = blockIdx.x;
  const int s = threadIdx.x;
  const int max_ops = n_steps + 2;
  uint32_t* canon = canon_global ? canon_global + c * (int64_t)max_ops
                                 : vopr_canon_smem;
  if (!canon_global)
    for (int i = threadIdx.x; i < max_ops; i += blockDim.x) canon[i] = 0;
  __syncthreads();
  VoprReplicas<R> st = {};
  VoprColumn<R> col = {};
  TfKey key = tf_split(seed, base + (uint64_t)c);
  for (int t = 0; t < n_steps; ++t) {
    const TfKey sub = tf_split(key, 1);
    key = tf_split(key, 0);
    const VoprFaults f = vopr_draw<R>(sub, S, probs);
    vopr_step<R>(st, col, s, S, max_ops, bug, f, canon, &sh);
  }
  if (threadIdx.x == 0) violated[c] = st.violated ? 1 : 0;
  if (want_state) {
    vopr_store<R>(out, c, s, S, st, col);
    if (!canon_global)
      for (int i = threadIdx.x; i < max_ops; i += blockDim.x)
        out.canonical[c * (int64_t)max_ops + i] = canon[i];
  }
}

extern "C" int tb_vopr_run(uint32_t k0, uint32_t k1, uint64_t base, int64_t n,
                           int n_steps, int R, int S, const double* probs,
                           int bug, void* violated, void* const* state_out,
                           void* canon_global, void* stream) {
  if (n < 0 || n > 0x7FFFFFFF || n_steps < 0 || n_steps > 0x7FFFFFF0 ||
      R < 1 || R > VOPR_MAX_R || S < 1 || S > VOPR_MAX_S || bug < BUG_NONE ||
      bug > BUG_SCRUB_OFF)
    return (int)cudaErrorInvalidValue;
  const int max_ops = n_steps + 2;
  if (max_ops > VOPR_SHARED_MAX_OPS && canon_global == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  VoprProbs p;
  for (int k = 0; k < P_COUNT; ++k) p.p[k] = probs[k];
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
  const int want = state_out != nullptr;
  uint32_t* cg = static_cast<uint32_t*>(canon_global);
  const size_t smem = cg ? 0 : (size_t)max_ops * sizeof(uint32_t);
  const int threads = (S + 31) / 32 * 32;
  const unsigned blocks = (unsigned)n;
  const TfKey seed{k0, k1};
  uint8_t* v = static_cast<uint8_t*>(violated);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: vopr_run_kernel<1><<<blocks, threads, smem, st>>>(seed, base, S, n_steps, bug, p, v, out, want, cg); break;
    case 2: vopr_run_kernel<2><<<blocks, threads, smem, st>>>(seed, base, S, n_steps, bug, p, v, out, want, cg); break;
    case 3: vopr_run_kernel<3><<<blocks, threads, smem, st>>>(seed, base, S, n_steps, bug, p, v, out, want, cg); break;
    case 4: vopr_run_kernel<4><<<blocks, threads, smem, st>>>(seed, base, S, n_steps, bug, p, v, out, want, cg); break;
    case 5: vopr_run_kernel<5><<<blocks, threads, smem, st>>>(seed, base, S, n_steps, bug, p, v, out, want, cg); break;
    default: vopr_run_kernel<6><<<blocks, threads, smem, st>>>(seed, base, S, n_steps, bug, p, v, out, want, cg); break;
  }
  return (int)cudaGetLastError();
}
