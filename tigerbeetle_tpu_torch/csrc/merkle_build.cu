// K22 merkle_build: a pad's Merkle heap (or its root alone) from the table.
//
// Replaces tigerbeetle_tpu/ops/merkle.py:106 `tree_from_leaves`, :118
// `root_from_leaves`, :125 `build_forest_impl` and :151 `verify_roots_impl`
// (the recomputed half), over :129 scrub.leaf_hashes (leaf.cuh).  The heap of
// a pad of C slots is u64[2C]: [unused, root, level 2 (2 nodes), ...,
// leaves (C)], node i = mix64(node 2i, node 2i+1), leaf of slot s at C + s.
//
// Each launch reduces one tile of up to 1,024 nodes a block in shared
// memory: a thread loads one node (the first launch computes it from the
// table: the live-masked row fold), then the block combines pairs level by
// level, writing every level it makes into the heap (heap mode) and its
// tile's top node to `tops`.  The next launch starts from the level the
// previous one ended at, so a pad of 2^25 slots takes three launches (10,
// 10 and 5 levels).  Root-only mode (`heap` null, the verify) never writes
// the heap: each launch reads the previous launch's tops and the last one
// writes the root to `root_out`.
//
// What bounds it on the H100: bytes.  Every slot's key pair (16 B) and the
// live rows' digested columns are read once; heap mode writes 2C u64 (16 B a
// slot); each node's mix64 is a few integer operations.
#include "leaf.cuh"

#define BUILD_TILE 1024

__global__ void __launch_bounds__(BUILD_TILE)
    merkle_level_kernel(PadCols p, const ull* __restrict__ in, ull* heap,
                        ull* tops, ull* root_out, int64_t n) {
  __shared__ ull s[BUILD_TILE];
  const int t = threadIdx.x;
  const int tile = blockDim.x;
  const int64_t i = blockIdx.x * (int64_t)tile + t;  // node index in level
  ull v;
  if (in == nullptr) {
    v = leaf_at(p, i);
    if (heap) heap[n + i] = v;
  } else {
    v = in[i];
  }
  s[t] = v;
  int64_t level_n = n;  // nodes in the level just made
  int64_t first = blockIdx.x * (int64_t)tile;  // this tile's first node there
  for (int w = tile >> 1; w >= 1; w >>= 1) {
    __syncthreads();
    ull a = 0, b = 0;
    if (t < w) {
      a = s[2 * t];
      b = s[2 * t + 1];
    }
    __syncthreads();
    level_n >>= 1;
    first >>= 1;
    if (t < w) {
      v = mix64(a, b);
      s[t] = v;
      if (heap) heap[level_n + first + t] = v;
    }
  }
  if (t == 0) {
    tops[blockIdx.x] = s[0];
    if (root_out && gridDim.x == 1) *root_out = s[0];
  }
}

// `cols` as leaf.cuh's PadCols for `kind`.  `heap` u64[2C] or null
// (root-only); `tops_a`, `tops_b` scratch of max(1, C / 1024) u64 each;
// `root_out` one u64 or null.
extern "C" int tb_merkle_build(int kind, const void* key_lo, const void* key_hi,
                               const void* const* cols, int64_t capacity,
                               void* heap, void* tops_a, void* tops_b,
                               void* root_out, void* stream) {
  PadCols p;
  int err = pack_pad(&p, kind, key_lo, key_hi, cols, capacity);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  ull* h = (ull*)heap;
  ull* tops[2] = {(ull*)tops_a, (ull*)tops_b};
  int64_t n = capacity;
  const ull* in = nullptr;
  for (int k = 0;; ++k) {
    const int64_t tile = n < BUILD_TILE ? n : BUILD_TILE;
    const int64_t blocks = n / tile;
    merkle_level_kernel<<<(unsigned)blocks, (unsigned)tile, 0, st>>>(
        p, in, h, tops[k & 1], (ull*)root_out, n);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (blocks == 1) break;
    n = blocks;
    in = h ? h + n : tops[k & 1];
  }
  return 0;
}
