// K23 merkle_touch: refresh the touched leaf->root paths of a pad's heap,
// and (second entry) read one slot's proof path.
//
// Replaces tigerbeetle_tpu/ops/merkle.py:169 `_leaf_at` and :183 `touch_tree`
// (inside :213 `update_accounts_impl` and :231 `update_transfers_impl`), and
// :280 `gather_path`.  The caller probes the touched keys first (K1) and
// passes each lane's slot and found bit; missing keys (rejected lanes, zero
// padding, unresolved pendings) touch nothing.
//
// touch: every found lane rewrites its leaf, heap[C + slot], from the
// table's current row (the live-masked row fold, leaf.cuh), so repeated
// touches of a slot are idempotent; then, for each of the log2(C) levels,
// every found lane recombines its ancestor at that level:
// heap[p] = mix64(heap[2p], heap[2p+1]).  Lanes that share an ancestor write
// the same value.  A level must be complete before the next reads it, so
// the levels are separated by a barrier: __syncthreads when the lanes fit
// in one block of 1,024, else the cooperative grid barrier over one lane a
// thread (as many blocks as fit on the card at once, as K2's claim rounds
// do): a level then costs one L2 round trip and one grid barrier.  Heap
// words go through L2 (__ldcg, __stcg), coherent across SMs.
//
// path: one thread writes (leaf, `levels` siblings, root) of one slot.
//
// What bounds it on the H100: latency.  A batch touches a few thousand
// paths of log2(C) nodes (16 B read, 8 B written a node, at random), about
// 0.5-3 MB, but every level waits on a barrier; the launch and the 10-25
// barriers, not the bytes, set its time.
#include <cooperative_groups.h>

#include "leaf.cuh"

namespace cg = cooperative_groups;

#define TOUCH_THREADS 1024
#define TOUCH_LANES_PER_BLOCK 1024  // one lane a thread

struct TouchArgs {
  PadCols p;
  ull* heap;
  const int64_t* slot;
  const uint8_t* found;
  int64_t n;
  int levels;
};

__global__ void __launch_bounds__(TOUCH_THREADS, 1)
    merkle_touch_kernel(TouchArgs a) {
  const bool one_block = gridDim.x == 1;
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const ull cap = (ull)a.p.capacity;
  auto barrier = [&]() {
    if (one_block) {
      __syncthreads();
    } else {
      cg::this_grid().sync();
    }
  };
  for (int64_t i = tid; i < a.n; i += stride) {
    if (!a.found[i]) continue;
    const int64_t s = a.slot[i];
    __stcg(a.heap + cap + (ull)s, (ull)leaf_at(a.p, s));
  }
  for (int level = 1; level <= a.levels; ++level) {
    barrier();
    for (int64_t i = tid; i < a.n; i += stride) {
      if (!a.found[i]) continue;
      const ull node = (cap + (ull)a.slot[i]) >> level;
      const ull v = mix64(__ldcg(a.heap + 2 * node), __ldcg(a.heap + 2 * node + 1));
      __stcg(a.heap + node, v);
    }
  }
}

// `cols` as leaf.cuh's PadCols for `kind`; `heap` u64[2C]; `slot` i64[n] and
// `found` bool[n] from K1's probe of the touched keys.
extern "C" int tb_merkle_touch(int kind, const void* key_lo, const void* key_hi,
                               const void* const* cols, int64_t capacity,
                               void* heap, const void* slot, const void* found,
                               int64_t n, void* stream) {
  TouchArgs a;
  int err = pack_pad(&a.p, kind, key_lo, key_hi, cols, capacity);
  if (err) return err;
  if (n == 0) return 0;
  if (n > INT_MAX) return (int)cudaErrorInvalidValue;
  a.heap = (ull*)heap;
  a.slot = (const int64_t*)slot;
  a.found = (const uint8_t*)found;
  a.n = n;
  int levels = 0;
  while ((1ll << levels) < capacity) ++levels;
  a.levels = levels;
  // The grid's residency is a property of the card, asked once per device
  // (a touch runs every batch; the occupancy query costs microseconds).
  static int resident_by_dev[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident_by_dev[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, merkle_touch_kernel, TOUCH_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    resident_by_dev[dev] = sms * per_sm;
  }
  int64_t blocks = (n + TOUCH_LANES_PER_BLOCK - 1) / TOUCH_LANES_PER_BLOCK;
  const int64_t resident = resident_by_dev[dev];
  if (blocks > resident) blocks = resident;
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)merkle_touch_kernel,
                                  dim3((unsigned)blocks), dim3(TOUCH_THREADS),
                                  args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

__global__ void merkle_path_kernel(const ull* heap, ull cap, ull slot,
                                   int levels, ull* out) {
  ull idx = cap + slot;
  out[0] = heap[idx];
  for (int l = 0; l < levels; ++l) {
    out[1 + l] = heap[idx ^ 1];
    idx >>= 1;
  }
  out[levels + 1] = heap[1];
}

// `out`: u64[levels + 2] = (leaf, siblings bottom-up, root).
extern "C" int tb_merkle_path(const void* heap, int64_t capacity, int64_t slot,
                              int levels, void* out, void* stream) {
  if (slot < 0 || slot >= capacity || levels < 0)
    return (int)cudaErrorInvalidValue;
  merkle_path_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const ull*)heap, (ull)capacity, (ull)slot, levels, (ull*)out);
  return (int)cudaGetLastError();
}
