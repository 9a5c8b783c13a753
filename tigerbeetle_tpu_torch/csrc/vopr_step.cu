// K28 vopr_step: one step of a batch of clusters on a given state under
// given faults (the step-locked route of tools/vopr_crossval.py).
//
// Replaces tigerbeetle_tpu/sim/vopr_tpu.py:217 step, vmapped over clusters
// as at :738.  One block per cluster, one thread per ring slot
// (csrc/vopr.cuh says why; its vopr_step is the step K29 runs too).  The
// state goes from `in` to `out` (the reference's functional update):
// every thread loads the cluster's replica scalars and its slot column,
// the block copies the canonical list to `out` and runs the oracle on it
// there, in device memory.
//
// What bounds it on the H100: the bytes of the states read and written
// (9R + 3RS + max_ops words and two flags a cluster, each way) at the
// sizes of a step-locked run; the integer operations (vopr.cuh) are the
// other term.  The design reads and writes each state word once, the ring
// columns coalesced across a warp's slots.
#include "vopr.cuh"

template <int R>
__global__ void __launch_bounds__(VOPR_MAX_S)
    vopr_step_kernel(int S, int max_ops, int bug, VoprStatePtrs in,
                     VoprStatePtrs out, VoprFaultPtrs faults) {
  __shared__ VoprShared sh;
  const int64_t c = blockIdx.x;
  const int s = threadIdx.x;
  VoprReplicas<R> st;
  VoprColumn<R> col;
  vopr_load<R>(in, c, s, S, st, col);
  uint32_t* canon = out.canonical + c * (int64_t)max_ops;
  const uint32_t* canon_in = in.canonical + c * (int64_t)max_ops;
  for (int i = threadIdx.x; i < max_ops; i += blockDim.x) canon[i] = canon_in[i];
  __syncthreads();
  const VoprFaults f = vopr_faults_load<R>(faults, c, S);
  vopr_step<R>(st, col, s, S, max_ops, bug, f, canon, &sh);
  vopr_store<R>(out, c, s, S, st, col);
}

static VoprStatePtrs state_ptrs(void* const* p) {
  VoprStatePtrs s;
  for (int k = 0; k < 8; ++k) s.rep[k] = static_cast<int32_t*>(p[k]);
  s.log = static_cast<uint32_t*>(p[S_LOG]);
  s.log_hdr = static_cast<uint32_t*>(p[S_LOG_HDR]);
  s.log_op = static_cast<int32_t*>(p[S_LOG_OP]);
  s.part_active = static_cast<uint8_t*>(p[S_PART_ACTIVE]);
  s.side = static_cast<int32_t*>(p[S_SIDE]);
  s.canonical = static_cast<uint32_t*>(p[S_CANONICAL]);
  s.violated = static_cast<uint8_t*>(p[S_VIOLATED]);
  return s;
}

extern "C" int tb_vopr_step(int64_t n, int R, int S, int max_ops, int bug,
                            void* const* state_in, void* const* state_out,
                            void* const* faults, void* stream) {
  if (n < 0 || n > 0x7FFFFFFF || R < 1 || R > VOPR_MAX_R || S < 1 ||
      S > VOPR_MAX_S || max_ops < 1 || bug < BUG_NONE || bug > BUG_SCRUB_OFF)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const VoprStatePtrs in = state_ptrs(state_in), out = state_ptrs(state_out);
  VoprFaultPtrs f;
  for (int k = 0; k < F_COUNT; ++k) f.f[k] = faults[k];
  const int threads = (S + 31) / 32 * 32;
  const unsigned blocks = (unsigned)n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: vopr_step_kernel<1><<<blocks, threads, 0, st>>>(S, max_ops, bug, in, out, f); break;
    case 2: vopr_step_kernel<2><<<blocks, threads, 0, st>>>(S, max_ops, bug, in, out, f); break;
    case 3: vopr_step_kernel<3><<<blocks, threads, 0, st>>>(S, max_ops, bug, in, out, f); break;
    case 4: vopr_step_kernel<4><<<blocks, threads, 0, st>>>(S, max_ops, bug, in, out, f); break;
    case 5: vopr_step_kernel<5><<<blocks, threads, 0, st>>>(S, max_ops, bug, in, out, f); break;
    default: vopr_step_kernel<6><<<blocks, threads, 0, st>>>(S, max_ops, bug, in, out, f); break;
  }
  return (int)cudaGetLastError();
}
