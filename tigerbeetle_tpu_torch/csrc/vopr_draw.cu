// K27 vopr_draw: one step's fault and schedule draws for a batch of keys.
//
// Replaces tigerbeetle_tpu/sim/vopr_tpu.py:160 draw_faults (vmapped over
// keys): split(key, 10), split(k_part, 4), fold_in(key, 0x5DC) and its
// split, then the reference's ten (R,) Bernoulli draws, the two (R,)
// randint slots, the repartition gate, the partition mode and the lone
// replica, each bit for bit as JAX's threefry draws them (csrc/threefry.cuh;
// the device function is vopr.cuh's vopr_draw, which K29 calls too).
//
// One thread per key, the draws' constants from the launch (integers:
// threefry.cuh).  What bounds it on the H100: integer operations,
// about 80 a threefry hash times 30 + 14R hashes a key, against 132 SMs x
// 64 INT32 lanes x 1.98 GHz; the bytes (8 in, 30R + 17 out a key) are a
// tenth of that.  The design keeps a key's hashes in one thread's registers
// and writes each output array once, coalesced across keys.
#include "vopr.cuh"

template <int R>
__global__ void vopr_draw_kernel(const uint32_t* __restrict__ keys, int64_t n,
                                 VoprDrawConsts dc, VoprFaultPtrs out) {
  const int64_t c = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (c >= n) return;
  const TfKey k{keys[2 * c], keys[2 * c + 1]};
  vopr_faults_store<R>(out, c, vopr_draw<R>(k, dc));
}

extern "C" int tb_vopr_draw(const void* keys, int64_t n, int R, int S,
                            const uint64_t* consts, void* const* out,
                            void* stream) {
  if (n < 0 || R < 1 || R > VOPR_MAX_R || S < 1 || S > VOPR_MAX_S)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  VoprDrawConsts dc;
  if (!vopr_draw_consts(consts, R, S, dc)) return (int)cudaErrorInvalidValue;
  VoprFaultPtrs o;
  for (int k = 0; k < F_COUNT; ++k) o.f[k] = out[k];
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const uint32_t* kk = static_cast<const uint32_t*>(keys);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: vopr_draw_kernel<1><<<blocks, threads, 0, st>>>(kk, n, dc, o); break;
    case 2: vopr_draw_kernel<2><<<blocks, threads, 0, st>>>(kk, n, dc, o); break;
    case 3: vopr_draw_kernel<3><<<blocks, threads, 0, st>>>(kk, n, dc, o); break;
    case 4: vopr_draw_kernel<4><<<blocks, threads, 0, st>>>(kk, n, dc, o); break;
    case 5: vopr_draw_kernel<5><<<blocks, threads, 0, st>>>(kk, n, dc, o); break;
    default: vopr_draw_kernel<6><<<blocks, threads, 0, st>>>(kk, n, dc, o); break;
  }
  return (int)cudaGetLastError();
}
