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
// Design: each block loads a chunk of up to 1,024 entries' 24-byte keys and
// their positions into shared memory and runs a bitonic network on
// (key, position).  The position makes every element distinct, so the order
// is the stable one: equal keys keep their input order, as lexsort does.
// Positions past the run (padding up to a power of two) sort after every
// entry.  A run of up to 8,192 entries (one batch) is then finished in the
// same launch: the blocks (one per chunk, up to eight a side) meet at a
// cooperative grid barrier and merge pairs of sorted runs of 1,024, 2,048
// and 4,096 entries, 1,024 outputs a block, each block finding its tile's
// split by a merge-path binary search (`merge_split` of index_common.cuh,
// shared with K14) and each thread merging two outputs;
// the keys and positions ping-pong through a device scratch read with
// __ldcg (other blocks wrote it).  Longer arrays (the full builds) leave
// sorted chunks of 1,024 for K14's rounds.  The payload (tid_lo, tid_hi)
// is gathered by position when the last pass writes the run.
//
// What bounds it on the H100: neither bytes nor operations.  Each entry is
// read once and written once (80 B); the network's 55 compare-exchange
// rounds of a 1,024 chunk and the three merge rounds each end in a barrier,
// so a run is latency-bound on 8 SMs a side.
#include <cooperative_groups.h>

#include "index_common.cuh"

namespace cg = cooperative_groups;

#define SORT_CHUNK 1024
#define SORT_RUN_MAX 8192

struct SortJobs {
  const uint64_t* in[2][5];
  uint64_t* out[2][5];
};

struct SortArgs {
  SortJobs jobs;
  const uint8_t* use;
  int64_t n_in, n_out;
  int chunk;           // entries a block sorts (a power of two <= 1,024)
  int blocks_per_job;  // chunks of one job
  int merge;           // 1: merge the chunks into one run in this launch
  uint64_t* scratch;   // merge: [job][buffer][hi, lo, ts, pos][run] words
  int64_t run;         // merge: the padded run length (a power of two)
};

static __device__ __forceinline__ bool key4_less(uint64_t ahi, uint64_t alo,
                                                 uint64_t ats, uint64_t apos,
                                                 uint64_t bhi, uint64_t blo,
                                                 uint64_t bts, uint64_t bpos) {
  if (ahi != bhi) return ahi < bhi;
  if (alo != blo) return alo < blo;
  if (ats != bts) return ats < bts;
  return apos < bpos;
}

// Write entry `pos` of the job's input (a sentinel where not real) at `g`.
static __device__ __forceinline__ void write_entry(const SortArgs& a, int job,
                                                   int64_t g, uint64_t hi,
                                                   uint64_t lo, uint64_t ts,
                                                   int64_t pos) {
  const uint64_t* const* in = a.jobs.in[job];
  uint64_t* const* out = a.jobs.out[job];
  const bool real = pos < a.n_in && (a.use == nullptr || a.use[pos]);
  out[IX_ACCT_LO][g] = lo;
  out[IX_ACCT_HI][g] = hi;
  out[IX_TS][g] = ts;
  out[IX_TID_LO][g] = real ? in[IX_TID_LO][pos] : IX_SENT;
  out[IX_TID_HI][g] = real ? in[IX_TID_HI][pos] : IX_SENT;
}

__global__ void __launch_bounds__(SORT_CHUNK / 2)
    run_sort_kernel(SortArgs a) {
  __shared__ uint64_t s_hi[SORT_CHUNK], s_lo[SORT_CHUNK], s_ts[SORT_CHUNK];
  __shared__ uint16_t s_ix[SORT_CHUNK];
  __shared__ int64_t split[2];
  const int job = blockIdx.x / a.blocks_per_job;
  const int block = blockIdx.x % a.blocks_per_job;
  const int chunk = a.chunk;
  const int64_t base = (int64_t)block * chunk;
  const uint64_t* const* in = a.jobs.in[job];

  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    const int64_t g = base + i;
    const bool real = g < a.n_in && (a.use == nullptr || a.use[g]);
    s_hi[i] = real ? in[IX_ACCT_HI][g] : IX_SENT;
    s_lo[i] = real ? in[IX_ACCT_LO][g] : IX_SENT;
    s_ts[i] = real ? in[IX_TS][g] : IX_SENT;
    s_ix[i] = (uint16_t)i;
  }
  __syncthreads();
  const int half = chunk >> 1;
  for (int k = 2; k <= chunk; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int x = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int y = x + j;
        const bool ascending = (x & k) == 0;
        const bool greater = key4_less(s_hi[y], s_lo[y], s_ts[y], s_ix[y],
                                       s_hi[x], s_lo[x], s_ts[x], s_ix[x]);
        if (greater == ascending) {
          uint64_t v = s_hi[x]; s_hi[x] = s_hi[y]; s_hi[y] = v;
          v = s_lo[x]; s_lo[x] = s_lo[y]; s_lo[y] = v;
          v = s_ts[x]; s_ts[x] = s_ts[y]; s_ts[y] = v;
          const uint16_t w = s_ix[x]; s_ix[x] = s_ix[y]; s_ix[y] = w;
        }
      }
      __syncthreads();
    }
  }

  if (!a.merge || a.run <= chunk) {
    // Padding positions (past n_out) hold the largest (key, position)
    // pairs, so the first n_out - base sorted entries are the chunk's own.
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
      const int64_t g = base + i;
      if (g < a.n_out) write_entry(a, job, g, s_hi[i], s_lo[i], s_ts[i],
                                   base + s_ix[i]);
    }
    return;
  }

  // Merge the chunks of this job into one run of `a.run` entries.
  const int64_t n = a.run;
  uint64_t* buf[2][4];
  for (int b = 0; b < 2; ++b)
    for (int f = 0; f < 4; ++f) buf[b][f] = a.scratch + ((job * 2 + b) * 4 + f) * n;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    buf[0][0][base + i] = s_hi[i];
    buf[0][1][base + i] = s_lo[i];
    buf[0][2][base + i] = s_ts[i];
    buf[0][3][base + i] = (uint64_t)(base + s_ix[i]);
  }
  int cur = 0;
  for (int64_t len = chunk; len < n; len <<= 1) {
    cg::this_grid().sync();
    uint64_t* const* src = buf[cur];
    uint64_t* const* dst = buf[cur ^ 1];
    const int64_t pair = base / (2 * len);
    const int64_t a0 = pair * 2 * len, b0 = a0 + len;
    const int64_t d0 = base - a0, d1 = d0 + chunk;
    if (threadIdx.x < 2)
      split[threadIdx.x] = merge_split<int64_t>(
          len, len, threadIdx.x ? d1 : d0, [&](int64_t i, int64_t j) {
            const int64_t ai = a0 + i, bi = b0 + j;
            return key4_less(__ldcg(&src[0][bi]), __ldcg(&src[1][bi]),
                             __ldcg(&src[2][bi]), __ldcg(&src[3][bi]),
                             __ldcg(&src[0][ai]), __ldcg(&src[1][ai]),
                             __ldcg(&src[2][ai]), __ldcg(&src[3][ai]));
          });
    __syncthreads();
    const int64_t i0 = split[0], j0 = d0 - split[0];
    const int na = (int)(split[1] - i0), nb = (int)((d1 - split[1]) - j0);
    for (int e = threadIdx.x; e < na + nb; e += blockDim.x) {
      const int64_t g = e < na ? a0 + i0 + e : b0 + j0 + (e - na);
      s_hi[e] = __ldcg(&src[0][g]);
      s_lo[e] = __ldcg(&src[1][g]);
      s_ts[e] = __ldcg(&src[2][g]);
      s_ix[e] = (uint16_t)__ldcg(&src[3][g]);
    }
    __syncthreads();
    const bool last = 2 * len >= n;
    const int per = chunk / blockDim.x;
    const int ld = threadIdx.x * per;
    const int lo = merge_split<int>(na, nb, ld, [&](int i, int j) {
      return key4_less(s_hi[na + j], s_lo[na + j], s_ts[na + j], s_ix[na + j],
                       s_hi[i], s_lo[i], s_ts[i], s_ix[i]);
    });
    int ia = lo, ib = ld - lo;
    for (int it = 0; it < per; ++it) {
      const bool take_a =
          ib >= nb || (ia < na && key4_less(s_hi[ia], s_lo[ia], s_ts[ia],
                                            s_ix[ia], s_hi[na + ib],
                                            s_lo[na + ib], s_ts[na + ib],
                                            s_ix[na + ib]));
      const int si = take_a ? ia : na + ib;
      const int64_t g = base + ld + it;
      if (last) {
        if (g < a.n_out)
          write_entry(a, job, g, s_hi[si], s_lo[si], s_ts[si], s_ix[si]);
      } else {
        dst[0][g] = s_hi[si];
        dst[1][g] = s_lo[si];
        dst[2][g] = s_ts[si];
        dst[3][g] = s_ix[si];
      }
      if (take_a) ++ia; else ++ib;
    }
    __syncthreads();  // the staged tile is reused by the next round
    cur ^= 1;
  }
}

// `in`: jobs x 5 column pointers of n_in entries; `out`: jobs x 5 of n_out
// (n_out >= n_in); `use` (n_in bytes) may be null.  A run of up to 8,192
// entries is sorted whole (`scratch`: jobs x 8 x run u64, run the power of
// two >= n_out); a longer one, or any run when `scratch` is null (then a
// multiple of 1,024 past 1,024 entries), in sorted chunks of 1,024.  `sorted_run` receives the length of
// the sorted runs written.
extern "C" int tb_run_sort(const void* const* in, void* const* out, int jobs,
                           const void* use, int64_t n_in, int64_t n_out,
                           void* scratch, int64_t* sorted_run, void* stream) {
  if (jobs < 1 || jobs > 2 || n_in > n_out || n_out < 1)
    return (int)cudaErrorInvalidValue;
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
  int64_t run = 2;
  while (run < n_out) run <<= 1;
  a.chunk = (int)(run < SORT_CHUNK ? run : SORT_CHUNK);
  a.merge = scratch != nullptr && n_out <= SORT_RUN_MAX && run > a.chunk;
  a.run = run;
  a.scratch = (uint64_t*)scratch;
  if (!a.merge && n_out > a.chunk && n_out % a.chunk)
    return (int)cudaErrorInvalidValue;
  const int64_t per_job = a.merge ? run / a.chunk
                                  : (n_out + a.chunk - 1) / a.chunk;
  a.blocks_per_job = (int)per_job;
  const int64_t blocks = per_job * jobs;
  const int threads = a.chunk / 2;
  *sorted_run = a.merge || n_out <= a.chunk ? n_out : a.chunk;
  if (a.merge) {
    void* args[] = {&a};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        (const void*)run_sort_kernel, dim3((unsigned)blocks), dim3(threads),
        args, 0, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  } else {
    run_sort_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
