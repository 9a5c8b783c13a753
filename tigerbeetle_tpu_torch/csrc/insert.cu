// K2 insert: the batched hash-table insert, placement slot for slot equal to
// the JAX claim protocol.
//
// Replaces tigerbeetle_tpu/ops/hash_table.py:114 `claim_slots` + :286
// `write_rows` + :317 `insert` (and serves :359 `grow`, whose lanes are every
// slot of the old table), with u128.py:118 `mix64`.
//
// The protocol is round-synchronous.  In round t every unplaced masked lane
// probes home+t; it contends only if that slot was free (key 0, no
// tombstone) at the START of the round; among the contenders for one slot
// the lowest lane wins (contenders always share a home); losers advance.
// The batch stops when every lane is placed, or, leaving the rest unplaced
// with `probe_overflow` set, once the next round would reach max_probe.  A
// first-come atomicCAS claim does not reproduce this, so each round has two
// phases separated by a grid-wide barrier:
//   A  every contender does atomicMin(claim[cur], lane);
//   B  the lane that finds its own index in claim[cur] takes the slot and
//      writes the key there (which makes the slot occupied for later
//      rounds); each loser resets the claim word of the slot it probes next,
//      in the other of two claim buffers, so no claim buffer needs clearing
//      and none is read while it is reset.
// Phase B also counts the lanes still unplaced into one of three counters
// (the round's, cleared two rounds ahead), and after the barrier every
// thread reads the same count, so all threads leave the loop together.
//
// The kernel is one cooperative launch: a batch of 8,192 lanes runs in one
// block of 1,024 threads with __syncthreads as the barrier; a large insert
// (`grow`, up to millions of lanes) runs on as many blocks as fit on the card
// at once and uses the cooperative grid barrier.  Values other blocks wrote
// are read with __ldcg (L2, coherent across SMs).  Then the placed lanes
// write their columns, clear the tombstone bit and add to `count`.
//
// The general transfer kernel claims first and writes only if its batch
// commits (transfer_full.py:1355-1405), with no host read between: the
// claim entry (`tb_claim`) runs the same rounds, leaving the claimed slots
// holding their keys as the round protocol's occupancy marks, and ORs a
// flag bit into a device word on overflow instead of the table's flag; the
// write entry (`tb_write_claimed`) then, per placed lane, either writes the
// row (the gate word is 0 and the lane is in the write mask) or clears the
// mark back to key 0 (those slots were free: key 0, no tombstone), so a
// batch that does not commit leaves every table array as it was.
//
// What bounds it on the H100: latency of the rounds, not bytes.  Round 0
// places most lanes; the rounds after it touch only the cluster tails, yet
// every round pays two barriers and a pass over the lanes.  Compacting the
// unplaced lanes (the JAX code's narrow window) is later work.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define INSERT_THREADS 1024
#define INSERT_LANES_PER_BLOCK 8192

struct InsertArgs {
  uint64_t* tkey_lo;
  uint64_t* tkey_hi;
  uint8_t* tomb;
  uint64_t mask;
  int hash_shift;
  int64_t max_probe;
  const uint64_t* key_lo;
  const uint64_t* key_hi;
  const uint8_t* insert_mask;
  int64_t n;
  int64_t* claimed;
  int* claim0;
  int* claim1;
  int* cnt;  // three round counters, zero on entry
  ull* count;
  uint8_t* probe_overflow;
  ColList rows;
  int claim_only;  // leave marks, skip the row writes, flag into flag_word
  int* flag_word;
  int flag_bit;
  cudaStream_t stream;
};

static __device__ __forceinline__ uint64_t lane_home(const InsertArgs& a,
                                                     int64_t i) {
  return (mix64(a.key_lo[i], a.key_hi[i]) >> a.hash_shift) & a.mask;
}

static __device__ __forceinline__ bool slot_free(const InsertArgs& a,
                                                 uint64_t s) {
  return __ldcg(reinterpret_cast<const ull*>(a.tkey_lo) + s) == 0 &&
         __ldcg(reinterpret_cast<const ull*>(a.tkey_hi) + s) == 0 &&
         a.tomb[s] == 0;
}

__global__ void __launch_bounds__(INSERT_THREADS, 1)
    insert_kernel(InsertArgs a) {
  __shared__ int red[32];
  __shared__ ull red64[32];
  const bool one_block = gridDim.x == 1;
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t cap = (int64_t)a.mask + 1;
  auto barrier = [&]() {
    if (one_block) {
      __syncthreads();
    } else {
      cg::this_grid().sync();
    }
  };

  int local = 0;
  for (int64_t i = tid; i < a.n; i += stride) {
    a.claimed[i] = cap;
    if (a.insert_mask[i]) {
      __stcg(a.claim0 + lane_home(a, i), INT_MAX);
      ++local;
    }
  }
  int s = block_sum(local, red);
  if (threadIdx.x == 0 && s) atomicAdd(a.cnt + 2, s);
  barrier();

  for (int64_t t = 0;; ++t) {
    const int remaining = __ldcg(a.cnt + (t + 2) % 3);
    if (remaining == 0) break;
    if (t >= a.max_probe) {
      if (tid == 0) {
        if (a.claim_only) {
          atomicOr(a.flag_word, a.flag_bit);
        } else {
          *a.probe_overflow = 1;
        }
      }
      break;
    }
    int* claim = (t & 1) ? a.claim1 : a.claim0;
    int* next = (t & 1) ? a.claim0 : a.claim1;
    // Phase A: contend for the slot if it is free at the start of the round.
    for (int64_t i = tid; i < a.n; i += stride) {
      if (a.insert_mask[i] && a.claimed[i] == cap) {
        const uint64_t cur = (lane_home(a, i) + (uint64_t)t) & a.mask;
        if (slot_free(a, cur)) atomicMin(claim + cur, (int)i);
      }
    }
    barrier();
    // Phase B: winners take their slot; losers prepare the next round.
    local = 0;
    for (int64_t i = tid; i < a.n; i += stride) {
      if (a.insert_mask[i] && a.claimed[i] == cap) {
        const uint64_t cur = (lane_home(a, i) + (uint64_t)t) & a.mask;
        if (__ldcg(claim + cur) == (int)i) {
          a.claimed[i] = (int64_t)cur;
          __stcg(reinterpret_cast<ull*>(a.tkey_lo) + cur, (ull)a.key_lo[i]);
          __stcg(reinterpret_cast<ull*>(a.tkey_hi) + cur, (ull)a.key_hi[i]);
        } else {
          __stcg(next + ((cur + 1) & a.mask), INT_MAX);
          ++local;
        }
      }
    }
    s = block_sum(local, red);
    if (threadIdx.x == 0 && s) atomicAdd(a.cnt + t % 3, s);
    if (tid == 0) atomicExch(a.cnt + (t + 1) % 3, 0);
    barrier();
  }

  if (a.claim_only) return;
  // write_rows: columns and tombstone at the placed slots, and the count.
  ull placed = 0;
  for (int64_t i = tid; i < a.n; i += stride) {
    const int64_t c = a.claimed[i];
    if (c < cap) {
      a.tomb[c] = 0;
      for (int k = 0; k < a.rows.n; ++k) {
        copy_elem(a.rows.dst[k], c, a.rows.src[k], i, a.rows.width[k]);
      }
      ++placed;
    }
  }
  const ull total = block_sum(placed, red64);
  if (threadIdx.x == 0 && total) atomicAdd(a.count, total);
}

// A batch of at most INSERT_LANES_PER_BLOCK lanes (every fast-path batch)
// runs as an ordinary one-block launch, with __syncthreads as its barrier:
// stream capture takes it whatever the CUDA version's support for captured
// cooperative launches, and it skips the occupancy queries.  A larger one
// (`grow`) is a cooperative launch on as many blocks as are resident.
static int launch_insert(InsertArgs& a) {
  if (a.n == 0) return 0;
  if (a.n > INT_MAX) return (int)cudaErrorInvalidValue;
  if (a.n <= INSERT_LANES_PER_BLOCK) {
    insert_kernel<<<1, INSERT_THREADS, 0, a.stream>>>(a);
    return (int)cudaGetLastError();
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, insert_kernel,
                                                      INSERT_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  int64_t blocks = (a.n + INSERT_LANES_PER_BLOCK - 1) / INSERT_LANES_PER_BLOCK;
  const int64_t resident = (int64_t)sms * per_sm;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)insert_kernel, dim3((unsigned)blocks),
                                  dim3(INSERT_THREADS), args, 0, a.stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

static void fill_args(InsertArgs* a, void* tkey_lo, void* tkey_hi, void* tomb,
                      int64_t capacity, int hash_shift, int64_t max_probe,
                      const void* key_lo, const void* key_hi,
                      const void* insert_mask, int64_t n, void* claimed,
                      void* claim0, void* claim1, void* cnt, void* stream) {
  a->tkey_lo = (uint64_t*)tkey_lo;
  a->tkey_hi = (uint64_t*)tkey_hi;
  a->tomb = (uint8_t*)tomb;
  a->mask = (uint64_t)(capacity - 1);
  a->hash_shift = hash_shift;
  a->max_probe = max_probe;
  a->key_lo = (const uint64_t*)key_lo;
  a->key_hi = (const uint64_t*)key_hi;
  a->insert_mask = (const uint8_t*)insert_mask;
  a->n = n;
  a->claimed = (int64_t*)claimed;
  a->claim0 = (int*)claim0;
  a->claim1 = (int*)claim1;
  a->cnt = (int*)cnt;
  a->stream = (cudaStream_t)stream;
}

extern "C" int tb_insert(void* tkey_lo, void* tkey_hi, void* tomb,
                         int64_t capacity, int hash_shift, int64_t max_probe,
                         const void* key_lo, const void* key_hi,
                         const void* insert_mask, int64_t n, void* claimed,
                         void* claim0, void* claim1, void* cnt, void* count,
                         void* probe_overflow, int ncols,
                         const void* const* src, void* const* dst,
                         const int* width, void* stream) {
  InsertArgs a;
  int err = pack_cols(&a.rows, ncols, src, dst, width);
  if (err) return err;
  fill_args(&a, tkey_lo, tkey_hi, tomb, capacity, hash_shift, max_probe, key_lo,
            key_hi, insert_mask, n, claimed, claim0, claim1, cnt, stream);
  a.count = (ull*)count;
  a.probe_overflow = (uint8_t*)probe_overflow;
  a.claim_only = 0;
  a.flag_word = nullptr;
  a.flag_bit = 0;
  return launch_insert(a);
}

extern "C" int tb_claim(void* tkey_lo, void* tkey_hi, const void* tomb,
                        int64_t capacity, int hash_shift, int64_t max_probe,
                        const void* key_lo, const void* key_hi,
                        const void* insert_mask, int64_t n, void* claimed,
                        void* claim0, void* claim1, void* cnt, void* flag_word,
                        int flag_bit, void* stream) {
  InsertArgs a;
  a.rows.n = 0;
  fill_args(&a, tkey_lo, tkey_hi, const_cast<void*>(tomb), capacity, hash_shift,
            max_probe, key_lo, key_hi, insert_mask, n, claimed, claim0, claim1,
            cnt, stream);
  a.count = nullptr;
  a.probe_overflow = nullptr;
  a.claim_only = 1;
  a.flag_word = (int*)flag_word;
  a.flag_bit = flag_bit;
  return launch_insert(a);
}

// Per lane with a claimed slot: write the row (keys, tombstone cleared,
// columns, the count) where the gate is open (null or 0) and the lane is in
// the write mask; otherwise, with `revert`, clear the claim's mark.
__global__ void write_claimed_kernel(uint64_t* tkey_lo, uint64_t* tkey_hi,
                                     uint8_t* tomb, int64_t cap,
                                     const uint64_t* key_lo,
                                     const uint64_t* key_hi,
                                     const int64_t* claimed,
                                     const uint8_t* write_mask, int64_t n,
                                     const int* gate, int revert, ColList rows,
                                     ull* count) {
  __shared__ ull red64[32];
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  ull placed = 0;
  if (i < n) {
    const int64_t c = claimed[i];
    if (c < cap) {
      const bool open = gate == nullptr || *gate == 0;
      if (open && write_mask[i]) {
        tkey_lo[c] = key_lo[i];
        tkey_hi[c] = key_hi[i];
        tomb[c] = 0;
        for (int k = 0; k < rows.n; ++k) {
          copy_elem(rows.dst[k], c, rows.src[k], i, rows.width[k]);
        }
        placed = 1;
      } else if (revert) {
        tkey_lo[c] = 0;
        tkey_hi[c] = 0;
      }
    }
  }
  const ull total = block_sum(placed, red64);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

extern "C" int tb_write_claimed(void* tkey_lo, void* tkey_hi, void* tomb,
                                int64_t capacity, const void* key_lo,
                                const void* key_hi, const void* claimed,
                                const void* write_mask, int64_t n,
                                const void* gate, int revert, void* count,
                                int ncols, const void* const* src,
                                void* const* dst, const int* width,
                                void* stream) {
  ColList rows;
  int err = pack_cols(&rows, ncols, src, dst, width);
  if (err) return err;
  if (n == 0) return 0;
  const int threads = 256;
  write_claimed_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                         (cudaStream_t)stream>>>(
      (uint64_t*)tkey_lo, (uint64_t*)tkey_hi, (uint8_t*)tomb, capacity,
      (const uint64_t*)key_lo, (const uint64_t*)key_hi, (const int64_t*)claimed,
      (const uint8_t*)write_mask, n, (const int*)gate, revert, rows,
      (ull*)count);
  return (int)cudaGetLastError();
}
