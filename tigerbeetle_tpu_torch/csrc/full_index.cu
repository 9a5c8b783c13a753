// K9 full_index: the batch's id groups and the in-batch pending join of the
// general transfer kernel.
//
// Replaces tigerbeetle_tpu/ops/transfer_full.py:199 `_build_id_index` (a
// lexsort of the ids, run ids, `any_dup`) and the pending join built on
// :212 `_search128` (:725-731 `pj_hit`/`pj_group`).
//
// The JAX function sorts the ids to group equal ones; only the grouping is
// used, so here each group is labelled by its lowest lane (the port's plain
// version labels it the same way, and the two are compared array for
// array).  Lanes are grouped through a batch-local open-addressing table:
// the first lane to claim a slot (atomicCAS on its word) keys it, and an
// atomicMin on the slot's lead gives the group's lowest lane, so no output
// depends on which lane claimed.  Id 0 (padding, and invalid events) is a
// key like any other: its group never wins (such lanes are never ok), but a
// pending_id of 0 does join it, as the JAX search does.  `any_dup` is set
// by a lane with a nonzero id that is not its group's lowest.  The pending
// join looks each lane's pending_id up in the same table.
//
// Design: one cooperative launch over the card, one lane a thread (blocks
// of 128; 64 blocks for 8,192 lanes).  (0) the table is cleared, grid
// barrier; (1) each lane claims its id's slot and puts its lane into the
// slot's lead (atomicMin), grid barrier; (2) each lane reads its lead and
// looks its pending_id up.  What another block wrote in the launch is read
// with __ldcg.  A slot's word is the claimant's lane beside 32 bits of its
// id's hash, so a probe passes another id's slot without loading that id
// (only a hash match compares the ids), and the table has at least 4n
// slots: a lane waits on its probe chain, and the slowest lane holds every
// block at the barrier (on an H100 80GB HBM3 at 700 W, at 2n slots the
// insert phase took 12.9 us of a 15.4 us kernel, at 4n 4.8, with the hash
// bits 4.1).  Neither a clear by cudaMemsetAsync (one barrier fewer, one
// graph node more: slower) nor the whole id kept in the slot paid.  The
// parent was one block of 1,024 threads, eight lanes a thread: each phase
// a chain of L2 atomics and dependent loads from one SM.
//
// What bounds it on the H100: latency (a few dependent L2 round trips a
// phase and the grid barriers); the bytes it must move (ids and pending ids
// in, four lane arrays out, about 0.4 MB at 8,192 lanes) take about 0.1 us.
#include <cooperative_groups.h>

#include "full_common.cuh"
#include "phase_clock.cuh"

namespace cg = cooperative_groups;

#define K9_THREADS 128
#define K9_EMPTY 0xFFFFFFFFFFFFFFFFull  // a slot's word: no claimant

struct K9Args {
  const uint64_t* id_lo;
  const uint64_t* id_hi;
  const uint64_t* pend_lo;
  const uint64_t* pend_hi;
  int n, slots;
  unsigned long long* word;  // slots x (hash >> 32 << 32 | claimant lane)
  unsigned* lead;            // slots x the group's lowest lane
  int64_t* group;
  uint8_t* any_dup;
  uint8_t* pj_hit;
  int64_t* pj_group;
};

__global__ void __launch_bounds__(K9_THREADS) full_index_kernel(K9Args a) {
  PHASE_MARK(0);
  cg::grid_group grid = cg::this_grid();
  const int i = blockIdx.x * K9_THREADS + threadIdx.x;
  const int n = a.n;
  const uint64_t mask = (uint64_t)(a.slots - 1);
  // 0. The table, empty.
  for (int j = i; j < a.slots; j += gridDim.x * K9_THREADS) {
    a.word[j] = K9_EMPTY;
    a.lead[j] = 0xFFFFFFFFu;
  }
  grid.sync();
  PHASE_MARK(1);

  // 1. Each lane's id into the table, the lane into its group's lead.
  if (i == 0) *a.any_dup = 0;
  uint64_t lo = 0, hi = 0, plo = 0, phi = 0;
  int h = 0;
  if (i < n) {
    lo = a.id_lo[i];
    hi = a.id_hi[i];
    plo = a.pend_lo[i];
    phi = a.pend_hi[i];
    const uint64_t x = mix64(lo, hi);
    const unsigned tag = (unsigned)(x >> 32);
    const unsigned long long mine = (unsigned long long)tag << 32 | (unsigned)i;
    h = (int)(x & mask);
    for (;;) {
      const unsigned long long prev = atomicCAS(a.word + h, K9_EMPTY, mine);
      if (prev == K9_EMPTY) break;
      if ((unsigned)(prev >> 32) == tag) {
        const unsigned other = (unsigned)prev;
        if (a.id_lo[other] == lo && a.id_hi[other] == hi) break;
      }
      h = (int)((h + 1) & mask);
    }
    atomicMin(a.lead + h, (unsigned)i);
  }
  grid.sync();
  PHASE_MARK(2);

  // 2. Each lane's lead, and its pending_id's group.
  if (i < n) {
    const unsigned lead = __ldcg(a.lead + h);
    a.group[i] = lead;
    if (lead != (unsigned)i && (lo | hi) != 0) *a.any_dup = 1;
    const uint64_t x = mix64(plo, phi);
    const unsigned tag = (unsigned)(x >> 32);
    int g = (int)(x & mask);
    unsigned found = 0xFFFFFFFFu;
    for (;;) {
      const unsigned long long w = __ldcg(a.word + g);
      const unsigned l = __ldcg(a.lead + g);
      if (w == K9_EMPTY) break;
      if ((unsigned)(w >> 32) == tag && a.id_lo[(unsigned)w] == plo &&
          a.id_hi[(unsigned)w] == phi) {
        found = l;
        break;
      }
      g = (int)((g + 1) & mask);
    }
    a.pj_hit[i] = found != 0xFFFFFFFFu;
    a.pj_group[i] = found != 0xFFFFFFFFu ? (int64_t)found : 0;
  }
  PHASE_MARK(3);
}

PHASE_CLOCK_ENTRIES(tb_full_index_phases)

// `scratch`: 12 bytes a slot (`slots`, a power of two >= 4n: the words,
// then the leads).
extern "C" int tb_full_index(const void* id_lo, const void* id_hi,
                             const void* pend_lo, const void* pend_hi,
                             int64_t n, void* scratch, int64_t slots,
                             void* group, void* any_dup, void* pj_hit,
                             void* pj_group, void* stream) {
  if (n <= 0 || n > FULL_MAX_LEGS / 2 || slots < 4 * n ||
      (slots & (slots - 1)))
    return (int)cudaErrorInvalidValue;
  unsigned long long* word = (unsigned long long*)scratch;
  K9Args a{(const uint64_t*)id_lo, (const uint64_t*)id_hi,
           (const uint64_t*)pend_lo, (const uint64_t*)pend_hi, (int)n,
           (int)slots, word, (unsigned*)(word + slots), (int64_t*)group,
           (uint8_t*)any_dup, (uint8_t*)pj_hit, (int64_t*)pj_group};
  void* args[] = {&a};
  const unsigned blocks = (unsigned)((n + K9_THREADS - 1) / K9_THREADS);
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)full_index_kernel, dim3(blocks), dim3(K9_THREADS), args,
      0, (cudaStream_t)stream);
  // A refused launch leaves its error as the thread's last error too:
  // clear it, so that the next kernel's check does not report it.
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// What the compiler and the card make of the launch for n lanes: out[0]
// registers a thread, out[1] local memory a thread in bytes (spills and
// stack), out[2] threads a block, out[3] blocks, out[4] blocks resident on
// one SM.
extern "C" int tb_full_index_info(int64_t n, int* out) {
  if (n <= 0 || n > FULL_MAX_LEGS / 2) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, (const void*)full_index_kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, (const void*)full_index_kernel, K9_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = K9_THREADS;
  out[3] = (int)((n + K9_THREADS - 1) / K9_THREADS);
  out[4] = per_sm;
  return 0;
}
