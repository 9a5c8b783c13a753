// K24 group_step, K25 group_finish, K26 group_words: the grouped commit's
// own per-step work, so that one captured CUDA graph of GROUP_K fast-path
// steps serves every run.
//
// Replaces tigerbeetle_tpu/machine.py:78 `_group_fast_dispatch_impl` (the
// lax.scan of create_transfers_impl over GROUP_K stacked batches) in the
// part that create_transfers_impl does not do: reading step j's count and
// timestamp from the stacked u64[GROUP_K] words (a padding step has count
// 0), and :104's probe-overflow flag widened into a fresh u32 of the run.
// The scan's body is the fast path's kernels K1-K4 through their
// device-word forms and preallocated scratch (csrc/probe.cu, validate.cu,
// insert.cu, balance.cu).
//
// group_step (step j of a run):
//   valid[i]   = i < counts[j]                 (state_machine.py _valid)
//   ts[i]      = timestamps[j] - counts[j] + i + 1   (_timestamps, wrapping)
//   pending[i] = flags[j][i] & TF_PENDING
//   run_ovf    = (j == 0 ? 0 : run_ovf) | table probe_overflow
// A step whose count is 0 masks every lane: its probes find nothing, its
// ladder accepts nothing, so K4 and K2 leave every ledger array untouched.
// group_finish ORs the table's flag into run_ovf once more after the last
// step's insert.  The table's flag is sticky, so run_ovf equals it at the end
// of the run; it lives in a buffer of the run's own (copied out of the graph
// after the replay), which the next replay does not touch.
//
// group_words (the bench twin's graph; replaces bench.py:2245, multi's batch
// index b0 + i, and :2229, its timestamp): the k steps' batch indexes,
// counts and timestamps from a device base word, which then advances by k,
// so that consecutive replays commit consecutive batches with no host write
// between.
//
// What bounds it on the H100: nothing of its own; one pass over the lanes
// (8 B flags read, 1 + 8 + 1 B written per lane), far below the launch
// overhead it saves by making the run one graph.
#include "common.cuh"

__global__ void group_step_kernel(const uint64_t* __restrict__ counts,
                                  const uint64_t* __restrict__ timestamps,
                                  int j, int64_t n,
                                  const uint32_t* __restrict__ flags,
                                  uint8_t* __restrict__ valid,
                                  uint64_t* __restrict__ ts,
                                  uint8_t* __restrict__ pending,
                                  const uint8_t* __restrict__ table_ovf,
                                  int* __restrict__ run_ovf) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const uint64_t cnt = counts[j], bts = timestamps[j];
  if (i < n) {
    valid[i] = (uint64_t)i < cnt ? 1 : 0;
    ts[i] = bts - cnt + (uint64_t)i + 1;
    pending[i] = (flags[i] & 2u) ? 1 : 0;
  }
  if (i == 0) *run_ovf = (j == 0 ? 0 : *run_ovf) | (*table_ovf ? 1 : 0);
}

__global__ void group_finish_kernel(const uint8_t* __restrict__ table_ovf,
                                    int* __restrict__ run_ovf) {
  if (threadIdx.x == 0) *run_ovf |= (*table_ovf ? 1 : 0);
}

__global__ void group_words_kernel(ull* __restrict__ base, int k, ull count,
                                   ull ts0, ull* __restrict__ bidx,
                                   ull* __restrict__ counts,
                                   ull* __restrict__ timestamps) {
  if (threadIdx.x != 0) return;
  const ull b0 = *base;
  for (int j = 0; j < k; ++j) {
    bidx[j] = b0 + (ull)j;
    counts[j] = count;
    timestamps[j] = ts0 + (b0 + (ull)j + 1) * count;
  }
  *base = b0 + (ull)k;
}

extern "C" int tb_group_step(const void* counts, const void* timestamps,
                             int j, int64_t n, const void* flags, void* valid,
                             void* ts, void* pending, const void* table_ovf,
                             void* run_ovf, void* stream) {
  if (j < 0 || n < 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t blocks = n > 0 ? (n + threads - 1) / threads : 1;
  group_step_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)counts, (const uint64_t*)timestamps, j, n,
      (const uint32_t*)flags, (uint8_t*)valid, (uint64_t*)ts,
      (uint8_t*)pending, (const uint8_t*)table_ovf, (int*)run_ovf);
  return (int)cudaGetLastError();
}

extern "C" int tb_group_finish(const void* table_ovf, void* run_ovf,
                               void* stream) {
  group_finish_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)table_ovf, (int*)run_ovf);
  return (int)cudaGetLastError();
}

extern "C" int tb_group_words(void* base, int k, uint64_t count, uint64_t ts0,
                              void* bidx, void* counts, void* timestamps,
                              void* stream) {
  if (k <= 0) return (int)cudaErrorInvalidValue;
  group_words_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (ull*)base, k, (ull)count, (ull)ts0, (ull*)bidx, (ull*)counts,
      (ull*)timestamps);
  return (int)cudaGetLastError();
}
