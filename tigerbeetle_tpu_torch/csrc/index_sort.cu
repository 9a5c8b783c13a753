// K13 run_sort: a stable sort of index entries by (acct_hi, acct_lo, ts).
//
// Replaces tigerbeetle_tpu/ops/index.py:49 `_sort_level` (jnp.lexsort, a
// stable sort) where `build_runs` (:54) and the scan builder's
// `_build_field_run` (ops/scan_builder.py:145) sort one batch's run, and the
// chunk pass of the full builds (`_full_build_side` :88, `_full_build_field`
// scan_builder.py:177, `_add_host_rows`), whose chunks K14 then merges.
// Entries past `n_in`, and entries whose `use` byte is 0, are sentinels (all
// five columns U64_MAX), as the JAX functions' jnp.where makes them.
//
// Design.  A chunk is sorted by one block, one entry a thread, held in
// registers as (key, position).  The position makes every element
// distinct, so the order is the stable one: equal keys keep their input
// order, as lexsort does.  Positions past the run (the last chunk's
// padding) sort after every entry.  The chunk runs a bitonic network: the
// compare-exchange strides within a warp (1-16) swap through
// __shfl_xor_sync, the wider ones through a shared buffer, two buffers in
// turn, one block barrier a step (the parent's network ended each of its
// 55 rounds with one).  A compare is one borrow chain over the seven 32-bit
// words of (key, position).
//
// A run of 1,025 to 8,192 entries (one batch, a side) is sorted whole in
// one launch by a thread-block cluster: chunks of 512, one block each (up to
// 16, a cluster size the H100 allows when asked), merged by rank in one
// step.  Each block writes its chunk's sorted keys into the job's output
// columns, at the chunk's own place; after a cluster barrier it reads the
// other chunks' keys from there (L2) into its shared memory, many loads in
// flight at once; a second barrier, and an entry's output position is its
// index in its own chunk, plus, for every earlier chunk, the count of keys
// there that are <= its key, plus, for every later chunk, the count of keys
// there that are < its key (binary searches, the chunks' interleaved).
// That is exactly the stable order.  Each block then writes its five
// columns once, at the final positions, the payload (tid_lo, tid_hi)
// gathered by source position.  No grid barrier, no device scratch.
// Longer arrays (the full builds), and any run when `fused` is 0 (then a
// multiple of 1,024 past 1,024 entries), leave sorted chunks of 1,024 for
// K14's rounds.
//
// What bounds it on the H100: neither bytes nor operations (each entry is
// read once and written once, 80 B).  The network moves 28 B an element a
// step through the shuffle unit or shared memory, which sets its time; a
// chunk of 512 a SM (45 steps) takes 6.7 us where 1,024 (55) took 13,
// while the ranks' shared-memory probes an SM stay about 8,192 x 10.  Two
// entries a thread, or eight, moved no less and hid less latency; the keys
// read through distributed shared memory in place of L2 took 11.7 us a
// block (the forms and clocks PERF.md §6 records).
#include <cooperative_groups.h>

#include "index_common.cuh"
#include "phase_clock.cuh"

namespace cg = cooperative_groups;

#define SORT_CHUNK 1024  // entries of a sorted chunk K14 merges
#define MERGE_CHUNK 512  // entries a block of a whole run's cluster sorts
#define SORT_RUN_MAX 8192
#define MERGE_OTHERS (SORT_RUN_MAX / MERGE_CHUNK - 1)  // a chunk's others

struct SortJobs {
  const uint64_t* in[2][5];
  uint64_t* out[2][5];
};

struct SortArgs {
  SortJobs jobs;
  const uint8_t* use;
  int64_t n_in, n_out;
  int chunks;  // chunks of one job (a whole run: the cluster's blocks)
};

struct SortEnt {
  uint64_t hi, lo, ts;
  uint32_t pos;  // index in the chunk
};

static __device__ __forceinline__ uint32_t lo32(uint64_t x) {
  return (uint32_t)x;
}
static __device__ __forceinline__ uint32_t hi32(uint64_t x) {
  return (uint32_t)(x >> 32);
}

// Whether a < b in (hi, lo, ts, pos) order: the borrow out of a - b over
// the seven words, least significant first.
static __device__ __forceinline__ bool ent_less(const SortEnt& a,
                                                const SortEnt& b) {
  uint32_t r;
  asm("{\n\t"
      ".reg .u32 t;\n\t"
      "sub.cc.u32 t, %1, %2;\n\t"
      "subc.cc.u32 t, %3, %4;\n\t"
      "subc.cc.u32 t, %5, %6;\n\t"
      "subc.cc.u32 t, %7, %8;\n\t"
      "subc.cc.u32 t, %9, %10;\n\t"
      "subc.cc.u32 t, %11, %12;\n\t"
      "subc.cc.u32 t, %13, %14;\n\t"
      "subc.u32 %0, 0, 0;\n\t"
      "}"
      : "=r"(r)
      : "r"(a.pos), "r"(b.pos), "r"(lo32(a.ts)), "r"(lo32(b.ts)),
        "r"(hi32(a.ts)), "r"(hi32(b.ts)), "r"(lo32(a.lo)), "r"(lo32(b.lo)),
        "r"(hi32(a.lo)), "r"(hi32(b.lo)), "r"(lo32(a.hi)), "r"(lo32(b.hi)),
        "r"(hi32(a.hi)), "r"(hi32(b.hi)));
  return r != 0;
}

// Whether (hi, lo, ts) sorts before e's key (`le`: or equals it): the
// borrow out of (hi, lo, ts) - e's key - le over the six words (the first
// subtraction, 0 - le, leaves le's borrow).
static __device__ __forceinline__ bool key_before(uint64_t hi, uint64_t lo,
                                                  uint64_t ts, const SortEnt& e,
                                                  uint32_t le) {
  uint32_t r;
  asm("{\n\t"
      ".reg .u32 t;\n\t"
      "sub.cc.u32 t, 0, %1;\n\t"
      "subc.cc.u32 t, %2, %3;\n\t"
      "subc.cc.u32 t, %4, %5;\n\t"
      "subc.cc.u32 t, %6, %7;\n\t"
      "subc.cc.u32 t, %8, %9;\n\t"
      "subc.cc.u32 t, %10, %11;\n\t"
      "subc.cc.u32 t, %12, %13;\n\t"
      "subc.u32 %0, 0, 0;\n\t"
      "}"
      : "=r"(r)
      : "r"(le), "r"(lo32(ts)), "r"(lo32(e.ts)), "r"(hi32(ts)),
        "r"(hi32(e.ts)), "r"(lo32(lo)), "r"(lo32(e.lo)), "r"(hi32(lo)),
        "r"(hi32(e.lo)), "r"(lo32(hi)), "r"(lo32(e.hi)), "r"(hi32(hi)),
        "r"(hi32(e.hi)));
  return r != 0;
}

static __device__ __forceinline__ SortEnt ent_shfl(const SortEnt& e, int m) {
  SortEnt o;
  o.hi = __shfl_xor_sync(0xffffffffu, e.hi, m);
  o.lo = __shfl_xor_sync(0xffffffffu, e.lo, m);
  o.ts = __shfl_xor_sync(0xffffffffu, e.ts, m);
  o.pos = __shfl_xor_sync(0xffffffffu, e.pos, m);
  return o;
}

// A chunk's sort buffer in shared memory (two of them, used in turn).
template <int C>
struct SortBuf {
  uint64_t hi[C], lo[C], ts[C];
  uint32_t pos[C];
};

// A chunk's sorted keys.
template <int C>
struct ChunkKeys {
  uint64_t hi[C], lo[C], ts[C];
};

// Entry `g` of job `job`, at position `t` of its chunk (a sentinel where
// not real).
static __device__ __forceinline__ SortEnt load_entry(const SortArgs& a, int job,
                                                     int64_t g, int t) {
  const uint64_t* const* in = a.jobs.in[job];
  const bool real = g < a.n_in && (a.use == nullptr || a.use[g]);
  SortEnt e;
  e.hi = real ? in[IX_ACCT_HI][g] : IX_SENT;
  e.lo = real ? in[IX_ACCT_LO][g] : IX_SENT;
  e.ts = real ? in[IX_TS][g] : IX_SENT;
  e.pos = (uint32_t)t;
  return e;
}

// The bitonic network over a chunk of C, element t in thread t.
template <int C>
static __device__ __forceinline__ void sort_chunk(SortEnt& e, SortBuf<C>* buf) {
  const int t = threadIdx.x;
  int turn = 0;
  for (int k = 2; k <= C; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      SortEnt o;
      if (j >= 32) {
        SortBuf<C>& b = buf[turn];
        turn ^= 1;
        b.hi[t] = e.hi;
        b.lo[t] = e.lo;
        b.ts[t] = e.ts;
        b.pos[t] = e.pos;
        __syncthreads();
        const int p = t ^ j;
        o.hi = b.hi[p];
        o.lo = b.lo[p];
        o.ts = b.ts[p];
        o.pos = b.pos[p];
      } else {
        o = ent_shfl(e, j);
      }
      // The lower element of an ascending pair (or the upper of a
      // descending one) keeps the smaller.
      const bool keep_min = ((t & j) == 0) == ((t & k) == 0);
      if (ent_less(o, e) == keep_min) e = o;
    }
  }
}

// Write entry `pos` of the job's input (a sentinel where not real) at `g`.
static __device__ __forceinline__ void write_entry(const SortArgs& a, int job,
                                                   int64_t g, const SortEnt& e,
                                                   int64_t pos) {
  const uint64_t* const* in = a.jobs.in[job];
  uint64_t* const* out = a.jobs.out[job];
  const bool real = pos < a.n_in && (a.use == nullptr || a.use[pos]);
  out[IX_ACCT_LO][g] = e.lo;
  out[IX_ACCT_HI][g] = e.hi;
  out[IX_TS][g] = e.ts;
  out[IX_TID_LO][g] = real ? in[IX_TID_LO][pos] : IX_SENT;
  out[IX_TID_HI][g] = real ? in[IX_TID_HI][pos] : IX_SENT;
}

// Sorted chunks of 1,024 (a run of at most 1,024 whole).  Both kernels'
// names begin run_sort: a profile finds K13's time by that name.
__global__ void __launch_bounds__(SORT_CHUNK, 1)
    run_sort_chunks_kernel(SortArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  PHASE_MARK(0);
  const int job = blockIdx.x / a.chunks;
  const int64_t base = (int64_t)(blockIdx.x % a.chunks) * SORT_CHUNK;
  const int t = threadIdx.x;
  SortEnt e = load_entry(a, job, base + t, t);
  sort_chunk<SORT_CHUNK>(e, reinterpret_cast<SortBuf<SORT_CHUNK>*>(smem));
  PHASE_MARK(1);
  // The chunk's padding (past n_out) sorts last: its first n_out - base
  // entries are the chunk's own.
  if (base + t < a.n_out) write_entry(a, job, base + t, e, base + e.pos);
  PHASE_MARK(4);
}

// A whole run of up to 8,192: one cluster a job, a block a chunk of 512.
__global__ void __launch_bounds__(MERGE_CHUNK, 1) run_sort_kernel(SortArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // The sort buffers, then (once the chunk is sorted) the copies of the
  // other chunks' keys in the same place.
  ChunkKeys<MERGE_CHUNK>* copies = reinterpret_cast<ChunkKeys<MERGE_CHUNK>*>(smem);
  PHASE_MARK(0);
  const int job = blockIdx.x / a.chunks;
  const int chunk = blockIdx.x % a.chunks;
  const int64_t base = (int64_t)chunk * MERGE_CHUNK;
  const int t = threadIdx.x;
  uint64_t* const* out = a.jobs.out[job];
  SortEnt e = load_entry(a, job, base + t, t);
  sort_chunk<MERGE_CHUNK>(e, reinterpret_cast<SortBuf<MERGE_CHUNK>*>(smem));
  PHASE_MARK(1);

  // The sorted keys meet in the output columns.
  cg::cluster_group cluster = cg::this_cluster();
  const int64_t n_own = a.n_out - base;  // the rest is padding, sorted last
  if (t < n_own) {
    out[IX_ACCT_HI][base + t] = e.hi;
    out[IX_ACCT_LO][base + t] = e.lo;
    out[IX_TS][base + t] = e.ts;
  }
  cluster.sync();  // every chunk sorted and written; the buffers are free
  PHASE_MARK(2);
  constexpr int kRound = 5;  // chunks whose loads are in flight at once
#pragma unroll
  for (int r0 = 0; r0 < MERGE_OTHERS; r0 += kRound) {
    // The loads (the other blocks wrote these words: __ldcg), then the
    // stores.
    uint64_t w[kRound][3];
#pragma unroll
    for (int i = 0; i < kRound; ++i) {
      const int r = r0 + i, d = r < chunk ? r : r + 1;
      const int64_t g = (int64_t)d * MERGE_CHUNK + t;
      const bool live = r < MERGE_OTHERS && d < a.chunks && g < a.n_out;
      w[i][0] = live ? __ldcg(&out[IX_ACCT_HI][g]) : IX_SENT;
      w[i][1] = live ? __ldcg(&out[IX_ACCT_LO][g]) : IX_SENT;
      w[i][2] = live ? __ldcg(&out[IX_TS][g]) : IX_SENT;
    }
#pragma unroll
    for (int i = 0; i < kRound; ++i) {
      const int r = r0 + i;
      if (r < MERGE_OTHERS && r + 1 < a.chunks) {
        copies[r].hi[t] = w[i][0];
        copies[r].lo[t] = w[i][1];
        copies[r].ts[t] = w[i][2];
      }
    }
  }
  // The copies are made, and no block reads the output columns again
  // before every block has passed here.
  cluster.sync();
  PHASE_MARK(3);

  if (t >= n_own) return;  // padding
  // Binary searches in the other chunks, one step of all of them at once.
  int n[MERGE_OTHERS], len[MERGE_OTHERS];
#pragma unroll
  for (int r = 0; r < MERGE_OTHERS; ++r) {
    const int d = r < chunk ? r : r + 1;
    const int64_t left = a.n_out - (int64_t)d * MERGE_CHUNK;
    n[r] = 0;
    len[r] = d >= a.chunks ? 0 : (left < MERGE_CHUNK ? (int)left : MERGE_CHUNK);
  }
#pragma unroll
  for (int step = MERGE_CHUNK; step > 0; step >>= 1) {
#pragma unroll
    for (int r = 0; r < MERGE_OTHERS; ++r) {
      const int p = n[r] + step - 1;
      // Earlier chunks (r < chunk): keys <= e's; later ones: keys < e's.
      if (p < len[r] && key_before(copies[r].hi[p], copies[r].lo[p],
                                   copies[r].ts[p], e, r < chunk))
        n[r] += step;
    }
  }
  int64_t rank = t;
#pragma unroll
  for (int r = 0; r < MERGE_OTHERS; ++r) rank += n[r];
  write_entry(a, job, rank, e, base + e.pos);
  PHASE_MARK(4);
}

PHASE_CLOCK_ENTRIES(tb_run_sort_phases)

// The launch a run of `n_out` entries takes: the kernel, its blocks'
// threads, the chunks a job, the cluster's blocks and the shared memory.
struct SortLaunch {
  void (*kernel)(SortArgs);
  int threads, chunks, cluster;
  size_t smem;
};

static int sort_launch(int64_t n_out, int fused, SortLaunch* l) {
  if (n_out < 1) return (int)cudaErrorInvalidValue;
  const bool whole = fused && n_out > SORT_CHUNK && n_out <= SORT_RUN_MAX;
  if (whole) {
    l->kernel = run_sort_kernel;
    l->threads = MERGE_CHUNK;
    l->chunks = (int)((n_out + MERGE_CHUNK - 1) / MERGE_CHUNK);
    l->cluster = l->chunks;
    const size_t bufs = 2 * sizeof(SortBuf<MERGE_CHUNK>);
    const size_t copies = (size_t)(l->chunks - 1) * sizeof(ChunkKeys<MERGE_CHUNK>);
    l->smem = bufs > copies ? bufs : copies;
  } else {
    if (n_out > SORT_CHUNK && n_out % SORT_CHUNK) return (int)cudaErrorInvalidValue;
    l->kernel = run_sort_chunks_kernel;
    l->threads = SORT_CHUNK;
    l->chunks = (int)((n_out + SORT_CHUNK - 1) / SORT_CHUNK);
    l->cluster = 1;
    l->smem = 2 * sizeof(SortBuf<SORT_CHUNK>);
  }
  // Once a process: the shared memory past 48 KB, and clusters past 8.
  static bool set = false;
  if (!set) {
    const int most = (int)(MERGE_OTHERS * sizeof(ChunkKeys<MERGE_CHUNK>));
    cudaError_t err = cudaFuncSetAttribute(
        run_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          run_sort_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          run_sort_chunks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)(2 * sizeof(SortBuf<SORT_CHUNK>)));
    if (err != cudaSuccess) return (int)err;
    set = true;
  }
  return 0;
}

static void sort_config(const SortLaunch& l, int jobs, void* stream,
                        cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(l.chunks * jobs));
  cfg->blockDim = dim3((unsigned)l.threads);
  cfg->dynamicSmemBytes = l.smem;
  cfg->stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)l.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// `in`: jobs x 5 column pointers of n_in entries; `out`: jobs x 5 of n_out
// (n_out >= n_in); `use` (n_in bytes) may be null.  A run of up to 8,192
// entries is sorted whole when `fused` (a cluster of one block a chunk of
// 512); a longer one, or any run when not `fused` (then a multiple of
// 1,024 past 1,024 entries), in sorted chunks of 1,024.  `sorted_run`
// receives the length of the sorted runs written.
extern "C" int tb_run_sort(const void* const* in, void* const* out, int jobs,
                           const void* use, int64_t n_in, int64_t n_out,
                           int fused, int64_t* sorted_run, void* stream) {
  if (jobs < 1 || jobs > 2 || n_in > n_out || n_out < 1)
    return (int)cudaErrorInvalidValue;
  SortLaunch l;
  int err = sort_launch(n_out, fused, &l);
  if (err) return err;
  SortArgs a;
  for (int j = 0; j < jobs; ++j) {
    for (int c = 0; c < 5; ++c) {
      a.jobs.in[j][c] = (const uint64_t*)in[5 * j + c];
      a.jobs.out[j][c] = (uint64_t*)out[5 * j + c];
    }
  }
  a.use = (const uint8_t*)use;
  a.n_in = n_in;
  a.n_out = n_out;
  a.chunks = l.chunks;
  *sorted_run = l.cluster > 1 || l.chunks == 1 ? n_out : SORT_CHUNK;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  sort_config(l, jobs, stream, &cfg, attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, l.kernel, a);
  // A refused launch leaves its error as the thread's last error too.
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// The launch a run of `n_out` entries takes: clusters of `cluster` blocks
// (1: no merge), `smem` bytes of shared memory a block, and how many such
// clusters the card holds at once (0: the launch cannot be scheduled).
extern "C" int tb_run_sort_info(int64_t n_out, int fused, int* cluster,
                                int* smem, int* max_clusters) {
  SortLaunch l;
  int err = sort_launch(n_out, fused, &l);
  if (err) return err;
  *cluster = l.cluster;
  *smem = (int)l.smem;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  sort_config(l, 1, nullptr, &cfg, attr);
  return (int)cudaOccupancyMaxActiveClusters(max_clusters, (void*)l.kernel,
                                             &cfg);
}
