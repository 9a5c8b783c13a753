// K18 evict_threshold and K19 evict_extract: the cold tier's eviction cut
// and the compaction of the evicted rows.
//
// K18 replaces tigerbeetle_tpu/ops/cold.py:391 `eviction_threshold`:
//
//   live = (key_lo | key_hi) != 0 & ~tombstone
//   ts   = live ? timestamp : UINT64_MAX
//   k    = min(count * num / den, C - 1)          (u64; count on the card)
//   T    = sort(ts)[k]
//
// as a radix select instead of a sort: eight passes over the 64-bit keys,
// most significant byte first.  Pass p histograms byte 7-p of the keys
// whose higher bytes equal the prefix chosen so far (a grid-wide 256-bin
// histogram: shared-memory bins per block, then one global atomicAdd per
// nonzero bin); the pass after it picks the byte whose running count passes
// k, subtracts the counts below it from k and appends it to the prefix.
// Every block of a pass makes that pick itself from the previous pass's
// histogram and state (a 256-thread block scan), and block 0 stores the
// state for the next pass, so nothing is read back to the host: the passes
// are nine launches queued on one stream (eight histograms and the last
// pick), and `count` is read on the card.  Pass 0 writes the keys to a
// scratch array that the later passes read (8 B a slot instead of 25).
//
// K19 replaces tigerbeetle_tpu/ops/cold.py:402 `extract_evicted` (and gives
// :426 `drop_evicted` its keep mask):
//
//   evict = live & (timestamp <= T);  keep = live & (timestamp > T)
//   the evicted rows, in slot order (argsort(~evict) is stable), compacted
//   into the first min(n, k) of k output lanes, zeros after n; n = sum(evict)
//
// in three launches: (A) per tile of 4,096 slots, the count of evicted
// slots (and the keep mask); (B) one block's exclusive scan of the tile
// counts, which also writes n; (C) per tile, the same flags again, placed by
// a block scan per row of 256 slots in slot order, each evicted row written
// at its rank (both keys and every column) when the rank is below k, then
// the lanes from n to k zeroed.  The order of evicted rows is the slot
// order, so the compaction equals the JAX gather byte for byte.
//
// What bounds them on the H100: bytes.  K18 reads 25 B a slot once and then
// 8 B a slot in each of the other seven passes; K19 reads 25 B a slot twice,
// gathers the evicted rows' columns and writes k output lanes of the keys
// and columns.  Both read the table with coalesced loads (neighbouring
// threads on neighbouring slots).
#include "common.cuh"

#define SEL_THREADS 256
#define SEL_PASSES 8
#define SEL_BINS 256
#define EX_THREADS 256
#define EX_ITEMS 16
#define EX_TILE (EX_THREADS * EX_ITEMS)

static __device__ __forceinline__ bool slot_live(const uint64_t* key_lo,
                                                 const uint64_t* key_hi,
                                                 const uint8_t* tomb,
                                                 int64_t s) {
  return (key_lo[s] | key_hi[s]) != 0 && tomb[s] == 0;
}

// ---------------------------------------------------------------------------
// K18: radix select
// ---------------------------------------------------------------------------

// state[2p], state[2p+1]: the prefix and the remaining k before pass p.
// Called by every thread of a SEL_THREADS block; returns (in `prefix`, `k`)
// the state before pass `p` (p >= 1), from the state before pass p-1 and
// that pass's histogram.
static __device__ void select_step(const ull* hist, const ull* state, int p,
                                   ull* prefix, ull* k) {
  __shared__ ull scan[SEL_BINS];
  __shared__ ull pick[2];
  const int q = p - 1;
  const ull prev_prefix = __ldcg(state + 2 * q);
  const ull prev_k = __ldcg(state + 2 * q + 1);
  const int b = threadIdx.x;
  const ull c = __ldcg(hist + q * SEL_BINS + b);
  scan[b] = c;
  __syncthreads();
  for (int off = 1; off < SEL_BINS; off <<= 1) {
    const ull add = b >= off ? scan[b - off] : 0;
    __syncthreads();
    scan[b] += add;
    __syncthreads();
  }
  const ull incl = scan[b];
  const ull excl = incl - c;
  if (excl <= prev_k && prev_k < incl) {
    const int shift = 56 - 8 * q;
    pick[0] = prev_prefix | ((ull)b << shift);
    pick[1] = prev_k - excl;
  }
  __syncthreads();
  *prefix = pick[0];
  *k = pick[1];
}

__global__ void __launch_bounds__(SEL_THREADS)
    select_hist_kernel(const uint64_t* key_lo, const uint64_t* key_hi,
                       const uint8_t* tomb, const uint64_t* ts, int64_t cap,
                       const ull* count, ull num, ull den, ull* keys,
                       ull* hist, ull* state, int p) {
  __shared__ unsigned int bins[SEL_BINS];
  ull prefix = 0, k = 0;
  if (p == 0) {
    k = (*count * num) / den;
    if (k > (ull)(cap - 1)) k = (ull)(cap - 1);
  } else {
    select_step(hist, state, p, &prefix, &k);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    state[2 * p] = prefix;
    state[2 * p + 1] = k;
  }
  bins[threadIdx.x] = 0;
  __syncthreads();
  const int shift = 56 - 8 * p;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t s = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; s < cap;
       s += stride) {
    ull v;
    if (p == 0) {
      v = slot_live(key_lo, key_hi, tomb, s) ? (ull)ts[s] : ~0ull;
      keys[s] = v;
    } else {
      v = keys[s];
      if ((v >> (shift + 8)) != (prefix >> (shift + 8))) continue;
    }
    atomicAdd(bins + ((v >> shift) & 0xFF), 1u);
  }
  __syncthreads();
  const unsigned int c = bins[threadIdx.x];
  if (c) atomicAdd(hist + p * SEL_BINS + threadIdx.x, (ull)c);
}

__global__ void __launch_bounds__(SEL_THREADS)
    select_final_kernel(const ull* hist, ull* state, ull* out) {
  ull prefix, k;
  select_step(hist, state, SEL_PASSES, &prefix, &k);
  if (threadIdx.x == 0) {
    state[2 * SEL_PASSES] = prefix;
    state[2 * SEL_PASSES + 1] = k;
    *out = prefix;
  }
}

// keys: u64[cap] scratch; hist: u64[8 * 256], zero on entry; state:
// u64[18]; out: u64[1].
extern "C" int tb_evict_threshold(const void* key_lo, const void* key_hi,
                                  const void* tomb, const void* ts,
                                  int64_t cap, const void* count, uint64_t num,
                                  uint64_t den, void* keys, void* hist,
                                  void* state, void* out, void* stream) {
  if (cap <= 0 || den == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int64_t blocks = (cap + SEL_THREADS * 16 - 1) / (SEL_THREADS * 16);
  if (blocks > 1056) blocks = 1056;
  for (int p = 0; p < SEL_PASSES; ++p) {
    select_hist_kernel<<<(unsigned)blocks, SEL_THREADS, 0, st>>>(
        (const uint64_t*)key_lo, (const uint64_t*)key_hi, (const uint8_t*)tomb,
        (const uint64_t*)ts, cap, (const ull*)count, num, den, (ull*)keys,
        (ull*)hist, (ull*)state, p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  select_final_kernel<<<1, SEL_THREADS, 0, st>>>((const ull*)hist, (ull*)state,
                                                 (ull*)out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K19: ordered compaction
// ---------------------------------------------------------------------------

struct ExtractArgs {
  const uint64_t* key_lo;
  const uint64_t* key_hi;
  const uint8_t* tomb;
  const uint64_t* ts;
  int64_t cap;
  const ull* thr;
  int64_t k;
  ull* tile_count;
  ull* tile_off;
  int64_t tiles;
  ull* n_out;
  uint64_t* out_lo;
  uint64_t* out_hi;
  ColList cols;  // src: the table's columns; dst: the k-lane outputs
  uint8_t* keep;
};

static __device__ __forceinline__ bool evicted(const ExtractArgs& a, int64_t s,
                                               ull thr, bool* keep) {
  if (s >= a.cap) {
    *keep = false;
    return false;
  }
  const bool live = slot_live(a.key_lo, a.key_hi, a.tomb, s);
  const bool e = live && (ull)a.ts[s] <= thr;
  *keep = live && !e;
  return e;
}

__global__ void __launch_bounds__(EX_THREADS) extract_count_kernel(ExtractArgs a) {
  const ull thr = *a.thr;
  const int64_t base = blockIdx.x * (int64_t)EX_TILE;
  ull total = 0;
  for (int j = 0; j < EX_ITEMS; ++j) {
    const int64_t s = base + (int64_t)j * EX_THREADS + threadIdx.x;
    bool keep;
    const bool e = evicted(a, s, thr, &keep);
    if (a.keep && s < a.cap) a.keep[s] = keep ? 1 : 0;
    total += (ull)__syncthreads_count(e);
  }
  if (threadIdx.x == 0) a.tile_count[blockIdx.x] = total;
}

__global__ void __launch_bounds__(1024) extract_scan_kernel(ExtractArgs a) {
  __shared__ ull scan[1024];
  __shared__ ull carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < a.tiles; base += 1024) {
    const int64_t t = base + threadIdx.x;
    const ull c = t < a.tiles ? a.tile_count[t] : 0;
    scan[threadIdx.x] = c;
    __syncthreads();
    for (int off = 1; off < 1024; off <<= 1) {
      const ull add = (int)threadIdx.x >= off ? scan[threadIdx.x - off] : 0;
      __syncthreads();
      scan[threadIdx.x] += add;
      __syncthreads();
    }
    if (t < a.tiles) a.tile_off[t] = carry + scan[threadIdx.x] - c;
    __syncthreads();
    if (threadIdx.x == 1023) carry += scan[1023];
    __syncthreads();
  }
  if (threadIdx.x == 0) *a.n_out = carry;
}

__global__ void __launch_bounds__(EX_THREADS) extract_write_kernel(ExtractArgs a) {
  __shared__ int warp_tot[EX_THREADS / 32];
  const ull thr = *a.thr;
  const int64_t base = blockIdx.x * (int64_t)EX_TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  ull running = a.tile_off[blockIdx.x];
  for (int j = 0; j < EX_ITEMS; ++j) {
    const int64_t s = base + (int64_t)j * EX_THREADS + threadIdx.x;
    bool keep;
    const bool e = evicted(a, s, thr, &keep);
    const unsigned ballot = __ballot_sync(0xffffffffu, e);
    if (lane == 0) warp_tot[warp] = __popc(ballot);
    __syncthreads();
    ull before = 0, total = 0;
    for (int w = 0; w < EX_THREADS / 32; ++w) {
      if (w < warp) before += warp_tot[w];
      total += warp_tot[w];
    }
    const ull pos = running + before + __popc(ballot & lt_mask);
    if (e && pos < (ull)a.k) {
      a.out_lo[pos] = a.key_lo[s];
      a.out_hi[pos] = a.key_hi[s];
      for (int c = 0; c < a.cols.n; ++c) {
        copy_elem(a.cols.dst[c], (int64_t)pos, a.cols.src[c], s,
                  a.cols.width[c]);
      }
    }
    running += total;
    __syncthreads();  // warp_tot is rewritten by the next row
  }
  // Zero the lanes from n to k.
  const ull n = *a.n_out;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < a.k;
       j += stride) {
    if ((ull)j < n) continue;
    a.out_lo[j] = 0;
    a.out_hi[j] = 0;
    for (int c = 0; c < a.cols.n; ++c) zero_elem(a.cols.dst[c], j, a.cols.width[c]);
  }
}

// tile_count, tile_off: u64[ceil(cap / 4096)]; n_out: u64[1]; out_lo,
// out_hi and dst[c]: k lanes; keep: bool[cap] or null.
extern "C" int tb_evict_extract(const void* key_lo, const void* key_hi,
                                const void* tomb, const void* ts, int64_t cap,
                                const void* thr, int64_t k, void* tile_count,
                                void* tile_off, void* n_out, void* out_lo,
                                void* out_hi, int ncols,
                                const void* const* src, void* const* dst,
                                const int* width, void* keep, void* stream) {
  if (cap <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  ExtractArgs a;
  int err = pack_cols(&a.cols, ncols, src, dst, width);
  if (err) return err;
  a.key_lo = (const uint64_t*)key_lo;
  a.key_hi = (const uint64_t*)key_hi;
  a.tomb = (const uint8_t*)tomb;
  a.ts = (const uint64_t*)ts;
  a.cap = cap;
  a.thr = (const ull*)thr;
  a.k = k;
  a.tile_count = (ull*)tile_count;
  a.tile_off = (ull*)tile_off;
  a.tiles = (cap + EX_TILE - 1) / EX_TILE;
  a.n_out = (ull*)n_out;
  a.out_lo = (uint64_t*)out_lo;
  a.out_hi = (uint64_t*)out_hi;
  a.keep = (uint8_t*)keep;
  cudaStream_t st = (cudaStream_t)stream;
  extract_count_kernel<<<(unsigned)a.tiles, EX_THREADS, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  extract_scan_kernel<<<1, 1024, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  extract_write_kernel<<<(unsigned)a.tiles, EX_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
