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
// with `probe_overflow` set, once the next round would reach max_probe.
//
// A batch of at most SPLIT_MAX_N lanes (every commit batch) takes the split
// form, three ordinary launches and no scratch the size of the table:
//   1. the pre-pass, a warp a lane over the whole card: the lane's home and
//      its window, one bit for each of the CLAIM_WINDOW slots from the home
//      on, set where the slot is occupied before the batch (claimed[] is
//      set to C here);
//   2. the resolver, one block, a thread eight lanes: the lanes grouped by
//      home in shared memory (a hash of homes; the lane that inserts a home
//      walks its group; a group of several gets its members in lane order),
//      then the rounds over GROUPS: a group's slot in round t is free if
//      its window bit is clear and the batch has not claimed it in an
//      earlier round (a set of claimed slots in shared memory); then the
//      group's next member takes it.  Two groups never probe one slot in
//      the same round (their homes differ), so a round needs no contention.
//      Round 0 runs over every group; the groups left go to a list in
//      shared memory, which each later round rewrites with those still
//      left (three barriers a round), so a round costs what its walkers
//      do, not the batch.  Claims and homes enter their hashes by a plain
//      store, checked after a barrier (atomicCAS only where another key
//      took the entry: one SM's shared atomics are slow), and no loop over
//      a thread's lanes is unrolled (the code fits the instruction cache).
//      A group reads its next window from the table every CLAIM_WINDOW
//      rounds, so max_probe holds whatever the cluster length;
//   3. the row writes (or, in the claim entry, the marks), a thread a
//      column of a lane over the whole card (`write_cols_kernel`).
// What bounds it on the H100: latency.  The pre-pass is two dependent
// reads (the key, then the window: 17 B a slot, 544 B a lane); the
// resolver is one SM: its setup (one read of its lanes, seven barriers)
// and three barriers a round (the deepest lane's offset + 1 rounds; most
// groups leave in round 0), a warp's sync a round once at most 32 groups
// are left; the writes are one scattered store a thread.
//
// A larger insert (`grow`, and the cold tier's rebuild, millions of lanes)
// takes the round form: round 0 over every lane in two ordinary launches
// (contend for the home with atomicMin on the slot's word; then the winner
// takes it and every other masked lane joins a list of walkers), then one
// cooperative launch over the card's resident blocks whose rounds walk
// only the walkers left, two grid barriers a round, and whose block 0
// finishes the last TAIL_MAX walkers alone.  Into a fresh table (`fill`:
// `grow` and the rebuild) it reads no slot, and the rows are then written
// whole, every slot in order.  What bounds it: round 0's random atomics
// and reads, one a masked lane, then the rounds' latency; the fill's
// bytes (every slot written once).
//
// The general transfer kernel claims first and writes only if its batch
// commits (transfer_full.py:1355-1405), with no host read between: the
// claim entry (`tb_claim`) leaves each claimed slot holding its key as a
// mark and ORs a flag bit into a device word on overflow instead of the
// table's flag; the write entry (`tb_write_claimed`) then, per placed lane,
// either writes the row (the gate word is 0 and the lane is in the write
// mask) or clears the mark back to key 0 (those slots were free: key 0, no
// tombstone), so a batch that does not commit leaves every table array as
// it was.
#include <cooperative_groups.h>

#include "common.cuh"
#include "phase_clock.cuh"

namespace cg = cooperative_groups;

#define CLAIM_WINDOW 32
#define SPLIT_MAX_N 8192
#define RESOLVE_THREADS 1024
#define RESOLVE_PER_THREAD (SPLIT_MAX_N / RESOLVE_THREADS)
#define PREPASS_THREADS 256
#define WRITE_THREADS 256
#define NO_LANE 0xFFFFFFFFFFFFFFFFull

static __device__ __forceinline__ bool occupied(const ull* tkey_lo,
                                                const ull* tkey_hi,
                                                const uint8_t* tomb,
                                                uint64_t s) {
  return ((tkey_lo[s] | tkey_hi[s]) != 0) | (tomb[s] != 0);
}

// -- 1. the pre-pass ---------------------------------------------------------

__global__ void __launch_bounds__(PREPASS_THREADS)
    claim_prepass_kernel(const ull* tkey_lo, const ull* tkey_hi,
                         const uint8_t* tomb, uint64_t mask, int hash_shift,
                         const ull* key_lo, const ull* key_hi,
                         const uint8_t* insert_mask, int n, int* home,
                         unsigned* window, int64_t* claimed) {
  const int i = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;  // whole warps
  if (lane == 0) claimed[i] = (int64_t)(mask + 1);
  if (!insert_mask[i]) {
    if (lane == 0) home[i] = -1;
    return;
  }
  const uint64_t h = (mix64(key_lo[i], key_hi[i]) >> hash_shift) & mask;
  const bool occ = occupied(tkey_lo, tkey_hi, tomb, (h + lane) & mask);
  const unsigned bits = __ballot_sync(0xffffffffu, occ);
  if (lane == 0) {
    home[i] = (int)h;
    window[i] = bits;
  }
}

// -- 2. the resolver ----------------------------------------------------------

struct ResolveArgs {
  const ull* tkey_lo;
  const ull* tkey_hi;
  const uint8_t* tomb;
  uint64_t mask;
  int64_t max_probe;
  const int* home;
  const unsigned* window;
  int n;
  int hbits;  // log2 of the shared hash's size, which is at least 2n
  int64_t* claimed;
  uint8_t* probe_overflow;  // insert entry
  int* flag_word;           // claim entry
  int flag_bit;
};

// hk int[hsize]; lhome, lwin, link and meta u32[n]; memb and list u16[n].
static size_t resolve_smem(int n, int hbits) {
  return ((size_t)4 << hbits) + (size_t)n * 20;
}

static __device__ __forceinline__ unsigned hash_slot(int key, int hbits) {
  return ((unsigned)key * 0x9E3779B1u) >> (32 - hbits);
}

// Where this thread writes its `c` entries of a shared list that `*count`
// sizes: one shared atomic a warp.  Every thread of the warp must call it.
static __device__ __forceinline__ int warp_alloc(int c, int* count) {
  const int lane = threadIdx.x & 31;
  int incl = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  int base = 0;
  if (lane == 31 && incl) base = atomicAdd(count, incl);
  return __shfl_sync(0xffffffffu, base, 31) + incl - c;
}

// Whether the claimed set (open addressing in hk, -1 empty) holds slot
// `key`; else the empty entry where it would go.
static __device__ __forceinline__ bool set_find(const int* hk, int hbits,
                                                int key, unsigned* at) {
  const unsigned m = (1u << hbits) - 1;
  unsigned h = hash_slot(key, hbits);
  for (;;) {
    const int v = hk[h];
    if (v == key) return true;
    if (v == -1) break;
    h = (h + 1) & m;
  }
  *at = h;
  return false;
}

// Adds slot `key` to the claimed set from entry `h` on.  No other group
// claims `key` in the same round (their homes differ) and the set never
// empties an entry, so a find and this insert are consistent.  A round's
// claims first try a plain store at the empty entry their find ended on
// (hk[at] == -1, then hk[at] = key); after the barrier each is found or
// added here: a plain store that another claim overwrote is redone.
static __device__ __forceinline__ void set_add(int* hk, int hbits, int key,
                                               unsigned h) {
  const unsigned m = (1u << hbits) - 1;
  while (atomicCAS(hk + h, -1, key) != -1) h = (h + 1) & m;
}

// The window of the CLAIM_WINDOW slots from `start` on, read from the table.
static __device__ __noinline__ unsigned window_at(const ull* tkey_lo,
                                                  const ull* tkey_hi,
                                                  const uint8_t* tomb,
                                                  uint64_t mask,
                                                  uint64_t start) {
  unsigned bits = 0;
#pragma unroll 8
  for (int k = 0; k < CLAIM_WINDOW; ++k) {
    bits |= (unsigned)occupied(tkey_lo, tkey_hi, tomb, (start + k) & mask)
            << k;
  }
  return bits;
}

__global__ void __launch_bounds__(RESOLVE_THREADS, 1)
    claim_resolve_kernel(ResolveArgs a) {
  extern __shared__ int smem[];
  __shared__ int cursor, nlist[3];
  const int hsize = 1 << a.hbits, n = a.n, tid = threadIdx.x;
  const int T = blockDim.x;
  const unsigned hmask = (unsigned)hsize - 1;
  // hk: the homes' hash (an entry holds the lane that inserted the home:
  // it walks the group and its index names it), then the claimed set.
  // Per lane i: lhome[i], lwin[i] (its window; a walker's is read again
  // every CLAIM_WINDOW rounds), link[i] (its walker | its position in the
  // group << 16: arrival, then rank; a walker's own entry then counts the
  // members it has placed).  Per walker c: meta[c] (the other members,
  // then the start of the members in memb | their count << 16).  list:
  // the walkers left after a round.
  int* hk = smem;
  int* lhome = hk + hsize;
  unsigned* lwin = reinterpret_cast<unsigned*>(lhome + n);
  unsigned* link = lwin + n;
  unsigned* meta = link + n;
  uint16_t* memb = reinterpret_cast<uint16_t*>(meta + n);
  uint16_t* list = memb + n;

  // A thread's lanes are i = tid + j*T, j < RESOLVE_PER_THREAD; the loops
  // over them are not unrolled, so that the kernel's code fits the SM's
  // instruction cache (a form with every loop unrolled eight times ran
  // about 140 KB of code, and its warps stalled on instruction fetches).
  // Per-lane state lives in shared memory; a thread keeps masks of j.
  {
    int h[RESOLVE_PER_THREAD];  // every read in flight at once
    unsigned w[RESOLVE_PER_THREAD];
#pragma unroll
    for (int j = 0; j < RESOLVE_PER_THREAD; ++j) {
      const int i = tid + j * T;
      h[j] = i < n ? a.home[i] : -1;
      w[j] = i < n ? a.window[i] : 0u;
    }
#pragma unroll
    for (int j = 0; j < RESOLVE_PER_THREAD; ++j) {
      const int i = tid + j * T;
      if (i >= n) break;
      lhome[i] = h[j];
      lwin[i] = w[j];
      meta[i] = 0;
    }
  }
#pragma unroll 1
  for (int s = tid; s < hsize; s += T) hk[s] = -1;
  if (tid == 0) cursor = nlist[0] = nlist[1] = nlist[2] = 0;
  __syncthreads();
  // The homes' hash.  Shared atomics are slow on one SM, so a lane first
  // stores itself at its home's entry if that is empty, a plain store;
  // after the barrier the entry's lane names the group if it has the same
  // home, and a lane that lost the entry to another home probes on with
  // atomicCAS (the lanes of one home all see the same entry and take the
  // same path).  Nearly every group is one lane: only a group's other
  // members count themselves in.
#pragma unroll 1
  for (int i = tid; i < n; i += T) {
    const int h = lhome[i];
    if (h < 0) continue;
    const unsigned e = hash_slot(h, a.hbits);
    if (hk[e] == -1) hk[e] = i;
  }
  __syncthreads();
  unsigned creator = 0;  // bit j: lane tid + j*T walks its group
#pragma unroll 1
  for (int i = tid, j = 0; i < n; i += T, ++j) {
    const int h = lhome[i];
    if (h < 0) continue;
    unsigned s = hash_slot(h, a.hbits);
    int prev = hk[s];
    while (prev != i && lhome[prev] != h) {
      s = (s + 1) & hmask;
      prev = atomicCAS(hk + s, -1, i);
      if (prev == -1) prev = i;
    }
    if (prev == i) {
      creator |= 1u << j;
      link[i] = (unsigned)i;
    } else {
      link[i] = (unsigned)prev | ((1u + atomicAdd(meta + prev, 1u)) << 16);
    }
  }
  __syncthreads();
  // A group of several members gets a range of memb, a warp's at once
  // (every thread takes the same steps, so the warps' shuffles are whole).
#pragma unroll 1
  for (int base = 0, j = 0; base < n; base += T, ++j) {
    const int i = base + tid;
    const int cnt = (creator >> j) & 1u ? 1 + (int)meta[i] : 0;
    int off = 0;
    if (__any_sync(0xffffffffu, cnt > 1))  // rare: skip the shared atomic
      off = warp_alloc(cnt > 1 ? cnt : 0, &cursor);
    if (cnt) meta[i] = (cnt > 1 ? (unsigned)off : 0u) | ((unsigned)cnt << 16);
  }
  __syncthreads();
  // Groups of several: members in arrival order, then each ranked by the
  // count of its group's lower lanes and put in lane order.
#pragma unroll 1
  for (int i = tid; i < n; i += T) {
    if (lhome[i] < 0) continue;
    const unsigned l = link[i], m = meta[l & 0xffff];
    if ((m >> 16) > 1) memb[(m & 0xffff) + (l >> 16)] = (uint16_t)i;
  }
#pragma unroll 1
  for (int s = tid; s < hsize; s += T) hk[s] = -1;  // the claimed set
  __syncthreads();
#pragma unroll 1
  for (int i = tid; i < n; i += T) {
    if (lhome[i] < 0) continue;
    const unsigned l = link[i], m = meta[l & 0xffff];
    const int cnt = (int)(m >> 16), st = (int)(m & 0xffff);
    if (cnt < 2) continue;
    int r = 0;
    for (int p = st; p < st + cnt; ++p) r += memb[p] < i;
    link[i] = (l & 0xffff) | ((unsigned)r << 16);
  }
  __syncthreads();
#pragma unroll 1
  for (int i = tid; i < n; i += T) {
    if (lhome[i] < 0) continue;
    const unsigned l = link[i], m = meta[l & 0xffff];
    if ((m >> 16) > 1) memb[(m & 0xffff) + (l >> 16)] = (uint16_t)i;
  }
  const int groups = __syncthreads_or(creator != 0);
  bool overflow = false;
  int left = 0;
  if (groups && a.max_probe <= 0) {
    overflow = true;
  } else if (groups) {
    // Round 0: every group probes its home, which no claim of the batch
    // holds yet.  A claim enters the set by a plain store at its entry if
    // that is empty, checked after the barrier (set_add where another
    // claim took the entry), as in every round.
    unsigned keep = 0, pend = 0;
#pragma unroll 1
    for (int c = tid, j = 0; c < n; c += T, ++j) {
      if (!((creator >> j) & 1u)) continue;
      const int h = lhome[c];
      const unsigned m = meta[c];
      const int cnt = (int)(m >> 16);
      unsigned placed = 0;
      if (!(lwin[c] & 1u)) {
        const unsigned e = hash_slot(h, a.hbits);
        if (hk[e] == -1) hk[e] = h;
        pend |= 1u << j;
        a.claimed[cnt > 1 ? memb[m & 0xffff] : c] = (int64_t)h;
        placed = 1;
      }
      link[c] = (unsigned)c | (placed << 16);
      if ((int)placed < cnt) keep |= 1u << j;
    }
    __syncthreads();
#pragma unroll 1
    for (int c = tid, j = 0; c < n; c += T, ++j) {
      if (!((pend >> j) & 1u)) continue;
      unsigned at;
      if (!set_find(hk, a.hbits, lhome[c], &at))
        set_add(hk, a.hbits, lhome[c], at);
    }
    int off = warp_alloc(__popc(keep), nlist);
#pragma unroll 1
    for (int c = tid, j = 0; c < n; c += T, ++j) {
      if ((keep >> j) & 1u) list[off++] = (uint16_t)c;
    }
    __syncthreads();
    left = nlist[0];
  }
  // Rounds 1, 2, ...: the walkers left, from the list, which is rewritten
  // with those still left (nlist[t % 3] counts them; the counter of the
  // round after is cleared, its last reader two barriers behind).  Once
  // at most 32 are left, warp 0 walks them alone (the narrow phase below).
  int t = 1;
  for (; left > 32; ++t) {
    if (t >= a.max_probe) {
      overflow = true;
      break;
    }
    const int wbit = t & (CLAIM_WINDOW - 1);
    const int cur = t % 3;
    unsigned keep = 0, pend = 0;
#pragma unroll 1
    for (int idx = tid, j = 0; idx < left; idx += T, ++j) {
      const int c = list[idx];
      const uint64_t s = ((uint64_t)lhome[c] + (uint64_t)t) & a.mask;
      unsigned w = lwin[c];
      if (wbit == 0) {
        w = window_at(a.tkey_lo, a.tkey_hi, a.tomb, a.mask, s);
        lwin[c] = w;
      }
      unsigned at;
      if (((w >> wbit) & 1u) || set_find(hk, a.hbits, (int)s, &at)) {
        keep |= 1u << j;
        continue;
      }
      if (hk[at] == -1) hk[at] = (int)s;  // checked after the barrier
      pend |= 1u << j;
      const unsigned m = meta[c];
      const int cnt = (int)(m >> 16);
      if (cnt == 1) {
        a.claimed[c] = (int64_t)s;
      } else {
        const int p = (int)(link[c] >> 16);
        a.claimed[memb[(m & 0xffff) + p]] = (int64_t)s;
        link[c] = (unsigned)c | ((unsigned)(p + 1) << 16);
        if (p + 1 < cnt) keep |= 1u << j;
      }
    }
    __syncthreads();  // the round's plain inserts are done
    uint16_t ent[RESOLVE_PER_THREAD];
#pragma unroll
    for (int j = 0; j < RESOLVE_PER_THREAD; ++j) {
      const int idx = tid + j * T;
      ent[j] = (keep >> j) & 1u ? list[idx] : 0;
    }
#pragma unroll 1
    for (int idx = tid, j = 0; idx < left; idx += T, ++j) {
      if (!((pend >> j) & 1u)) continue;
      const int c = list[idx];
      const int s = (int)(((uint64_t)lhome[c] + (uint64_t)t) & a.mask);
      unsigned at;
      if (!set_find(hk, a.hbits, s, &at)) set_add(hk, a.hbits, s, at);
    }
    __syncthreads();  // every read of the list is done
    if ((tid & ~31) < left) {  // a warp with walkers this round
      int off = warp_alloc(__popc(keep), nlist + cur);
#pragma unroll
      for (int j = 0; j < RESOLVE_PER_THREAD; ++j) {
        if ((keep >> j) & 1u) list[off++] = ent[j];
      }
    }
    if (tid == 0) nlist[(cur + 1) % 3] = 0;
    __syncthreads();
    left = nlist[cur];
  }
  // The narrow phase: a walker a lane of warp 0, a __syncwarp a round (a
  // round of the whole block costs about 2 us in barriers and empty warps).
  // Within a round the claims go straight to set_add: there are few.
  if (left > 0 && !overflow) {
    if (tid >= 32) return;
    int c = tid < left ? list[tid] : -1;
    for (;; ++t) {
      if (!__any_sync(0xffffffffu, c >= 0)) break;
      if (t >= a.max_probe) {
        overflow = true;
        break;
      }
      const int wbit = t & (CLAIM_WINDOW - 1);
      if (c >= 0) {
        const uint64_t s = ((uint64_t)lhome[c] + (uint64_t)t) & a.mask;
        unsigned w = lwin[c];
        if (wbit == 0) {
          w = window_at(a.tkey_lo, a.tkey_hi, a.tomb, a.mask, s);
          lwin[c] = w;
        }
        unsigned at;
        if (!((w >> wbit) & 1u) && !set_find(hk, a.hbits, (int)s, &at)) {
          set_add(hk, a.hbits, (int)s, at);
          const unsigned m = meta[c];
          const int cnt = (int)(m >> 16);
          if (cnt == 1) {
            a.claimed[c] = (int64_t)s;
            c = -1;
          } else {
            const int p = (int)(link[c] >> 16);
            a.claimed[memb[(m & 0xffff) + p]] = (int64_t)s;
            link[c] = (unsigned)c | ((unsigned)(p + 1) << 16);
            if (p + 1 == cnt) c = -1;
          }
        }
      }
      __syncwarp();  // this round's claims are in the set for the next
    }
  }
  if (overflow && tid == 0) {
    if (a.flag_word) {
      atomicOr(a.flag_word, a.flag_bit);
    } else {
      *a.probe_overflow = 1;
    }
  }
}

// -- 3. the writes -----------------------------------------------------------

// Per lane with a claimed slot, in MODE_ROWS: where the gate is open (null
// or 0) and the lane is in the write mask, blockIdx.y 0 writes the keys,
// clears the tombstone and counts the row, and blockIdx.y k > 0 copies
// column k-1 (in a grid one block high, blockIdx.y 0 copies every column);
// otherwise, with `revert`, blockIdx.y 0 clears the claim's mark.  In
// MODE_MARKS (the claim entry) blockIdx.y 0 writes the keys alone.
enum WriteMode { MODE_ROWS = 0, MODE_MARKS = 1 };

__global__ void __launch_bounds__(WRITE_THREADS)
    write_cols_kernel(ull* tkey_lo, ull* tkey_hi, uint8_t* tomb, int64_t cap,
                      const ull* key_lo, const ull* key_hi,
                      const int64_t* claimed, const uint8_t* write_mask,
                      int64_t n, const int* gate, int revert, int mode,
                      ColList rows, ull* count) {
  __shared__ ull red64[32];
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int col = (int)blockIdx.y - 1;
  ull placed = 0;
  if (i < n) {
    const int64_t c = claimed[i];
    if (c < cap) {
      if (mode == MODE_MARKS) {
        tkey_lo[c] = key_lo[i];
        tkey_hi[c] = key_hi[i];
      } else if ((gate == nullptr || *gate == 0) && write_mask[i]) {
        if (col < 0) {
          tkey_lo[c] = key_lo[i];
          tkey_hi[c] = key_hi[i];
          tomb[c] = 0;
          placed = 1;
        }
        const int k0 = gridDim.y == 1 ? 0 : col;
        const int k1 = gridDim.y == 1 ? rows.n : col + 1;
        for (int k = k0 < 0 ? 0 : k0; k < k1; ++k) {
          copy_elem(rows.dst[k], c, rows.src[k], i, rows.width[k]);
        }
      } else if (revert && col < 0) {
        tkey_lo[c] = 0;
        tkey_hi[c] = 0;
      }
    }
  }
  if (mode == MODE_MARKS || col >= 0) return;  // the whole block
  const ull total = block_sum(placed, red64);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

// The rows of a fresh table (`grow`, the cold rebuild: the round form's
// `fill`), written whole in slot order: the round form's slot words name
// each slot's lane (NO_LANE: none), and a thread a slot writes every array
// at s, that lane's row or zeros, so a warp's stores cover whole sectors (a
// row written where its lane landed costs a partial sector an array, and
// the table then needs no zeros first); its loads, a grow's or rebuild's
// lanes in about the slots' order, go eight columns at once.
static __device__ __forceinline__ uint64_t load_elem(const void* src,
                                                     int64_t i, int width) {
  if (width == 8) return static_cast<const uint64_t*>(src)[i];
  if (width == 4) return static_cast<const uint32_t*>(src)[i];
  return static_cast<const uint8_t*>(src)[i];
}

static __device__ __forceinline__ void store_elem(void* dst, int64_t i,
                                                  uint64_t v, int width) {
  if (width == 8) {
    static_cast<uint64_t*>(dst)[i] = v;
  } else if (width == 4) {
    static_cast<uint32_t*>(dst)[i] = (uint32_t)v;
  } else {
    static_cast<uint8_t*>(dst)[i] = (uint8_t)v;
  }
}

#define FILL_GROUP 8

__global__ void __launch_bounds__(WRITE_THREADS)
    write_fill_kernel(ull* tkey_lo, ull* tkey_hi, uint8_t* tomb, int64_t cap,
                      const ull* key_lo, const ull* key_hi, const ull* word,
                      const __grid_constant__ ColList rows, ull* count) {
  __shared__ ull red64[32];
  PHASE_MARK(5);
  const int64_t s = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  ull placed = 0;
  if (s < cap) {
    const ull w = word[s];
    const bool has = w != NO_LANE;
    const unsigned i = (unsigned)w;
    tkey_lo[s] = has ? key_lo[i] : 0;
    tkey_hi[s] = has ? key_hi[i] : 0;
    tomb[s] = 0;
    placed = has;
    for (int g = 0; g < rows.n; g += FILL_GROUP) {
      uint64_t v[FILL_GROUP];
#pragma unroll
      for (int q = 0; q < FILL_GROUP; ++q) {
        const int k = g + q;
        v[q] = has && k < rows.n ? load_elem(rows.src[k], i, rows.width[k]) : 0;
      }
#pragma unroll
      for (int q = 0; q < FILL_GROUP; ++q) {
        const int k = g + q;
        if (k < rows.n) store_elem(rows.dst[k], s, v[q], rows.width[k]);
      }
    }
  }
  const ull total = block_sum(placed, red64);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

static int launch_writes(ull* tkey_lo, ull* tkey_hi, uint8_t* tomb,
                         int64_t cap, const ull* key_lo, const ull* key_hi,
                         const int64_t* claimed, const uint8_t* write_mask,
                         int64_t n, const int* gate, int revert, int mode,
                         const ColList& rows, ull* count, cudaStream_t stream,
                         const ull* word = nullptr) {
  if (word != nullptr) {  // a fresh table, written whole
    write_fill_kernel<<<(unsigned)((cap + WRITE_THREADS - 1) / WRITE_THREADS),
                        WRITE_THREADS, 0, stream>>>(
        tkey_lo, tkey_hi, tomb, cap, key_lo, key_hi, word, rows, count);
    return (int)cudaGetLastError();
  }
  // A batch: a block row a column, so the card holds every store in
  // flight.  More lanes fill the card alone; a row a column would read
  // `claimed` again for every column.
  const unsigned ys =
      mode == MODE_MARKS || n > SPLIT_MAX_N ? 1u : (unsigned)(1 + rows.n);
  const dim3 grid((unsigned)((n + WRITE_THREADS - 1) / WRITE_THREADS), ys);
  write_cols_kernel<<<grid, WRITE_THREADS, 0, stream>>>(
      tkey_lo, tkey_hi, tomb, cap, key_lo, key_hi, claimed, write_mask, n,
      gate, revert, mode, rows, count);
  return (int)cudaGetLastError();
}

// -- the split form's launches -------------------------------------------

struct Batch {
  ull* tkey_lo;
  ull* tkey_hi;
  uint8_t* tomb;
  int64_t cap;
  int hash_shift;
  int64_t max_probe;
  const ull* key_lo;
  const ull* key_hi;
  const uint8_t* insert_mask;
  int64_t n;
  int64_t* claimed;
  cudaStream_t stream;
};

static int opt_in_resolve() {
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 0 && dev < 64 && opted[dev]) return 0;
  int hbits = 1;
  while ((1 << hbits) < 2 * SPLIT_MAX_N) ++hbits;
  e = cudaFuncSetAttribute(claim_resolve_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)resolve_smem(SPLIT_MAX_N, hbits));
  if (e != cudaSuccess) return (int)e;
  if (dev >= 0 && dev < 64) opted[dev] = true;
  return 0;
}

// Launches 1 and 2; `pre` holds n home words, then n window words.
static int launch_claims(const Batch& b, void* pre, uint8_t* probe_overflow,
                         int* flag_word, int flag_bit) {
  if (b.n <= 0 || b.n > SPLIT_MAX_N || pre == nullptr ||
      b.cap > ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  int err = opt_in_resolve();
  if (err) return err;
  const int n = (int)b.n;
  int* home = (int*)pre;
  unsigned* window = (unsigned*)(home + n);
  const unsigned blocks =
      (unsigned)((n * 32 + PREPASS_THREADS - 1) / PREPASS_THREADS);
  claim_prepass_kernel<<<blocks, PREPASS_THREADS, 0, b.stream>>>(
      b.tkey_lo, b.tkey_hi, b.tomb, (uint64_t)(b.cap - 1), b.hash_shift,
      b.key_lo, b.key_hi, b.insert_mask, n, home, window, b.claimed);
  err = (int)cudaGetLastError();
  if (err) return err;
  ResolveArgs a;
  a.tkey_lo = b.tkey_lo;
  a.tkey_hi = b.tkey_hi;
  a.tomb = b.tomb;
  a.mask = (uint64_t)(b.cap - 1);
  a.max_probe = b.max_probe;
  a.home = home;
  a.window = window;
  a.n = n;
  a.hbits = 1;
  while ((1 << a.hbits) < 2 * n) ++a.hbits;
  a.claimed = b.claimed;
  a.probe_overflow = probe_overflow;
  a.flag_word = flag_word;
  a.flag_bit = flag_bit;
  claim_resolve_kernel<<<1, RESOLVE_THREADS, resolve_smem(n, a.hbits),
                         b.stream>>>(a);
  return (int)cudaGetLastError();
}

// -- the round form (more than SPLIT_MAX_N lanes) ----------------------------
//
// Contenders for one slot in round t share a home (slot home + t), and a
// slot's word (u64, all ones on entry) takes the lowest contender by
// atomicMin of (t << 32 | lane): a word an earlier round set is lower than
// any of round t's, so it stays, and the word's lane is the slot's winner
// for good.  Round 0 is two ordinary launches over the n lanes (contend;
// then take or join the walker list); the rest one cooperative launch
// over the card's resident blocks that walks only the lanes left, (lane,
// home) pairs in one of two lists, rewritten each round with those still
// left (a block's losers appended by one atomic), two grid barriers a
// round.  Once at most TAIL_MAX are left, block 0 finishes alone, the
// list in shared memory and a block barrier in place of each grid one.
// A lane contends only for a slot free at the round's start: in a table
// that holds rows it reads the slot's keys and tombstone (a winner marks
// its slot with its key); a fresh table (`fresh`: every slot empty, the
// insert's `fill`) needs no read, and its words end as the map of slots
// to lanes that the rows are written from.

#define PASS_THREADS 256
#define RESOLVE0_THREADS 1024
#define ROUNDS_THREADS 512
#define TAIL_MAX 2048

struct RoundArgs {
  ull* tkey_lo;
  ull* tkey_hi;
  const uint8_t* tomb;
  uint64_t mask;
  int hash_shift;
  int64_t max_probe;
  const ull* key_lo;
  const ull* key_hi;
  const uint8_t* insert_mask;
  int64_t n;
  int64_t* claimed;
  ull* word;   // [C]: (round << 32 | lane) of the slot's winner, or NO_LANE
  int2* list0;  // (lane, home) walkers, n each
  int2* list1;
  int* cnt;  // the two lists' lengths, zero on entry
  int fresh;
  uint8_t* probe_overflow;
  int* flag_word;
  int flag_bit;
};

static __device__ __forceinline__ int lane_home(const RoundArgs& a,
                                                int64_t i) {
  return (int)((mix64(a.key_lo[i], a.key_hi[i]) >> a.hash_shift) & a.mask);
}

// Free at the start of the round: the table's keys are written by winners
// of earlier rounds, in other blocks (read through L2).
static __device__ __forceinline__ bool slot_free(const RoundArgs& a,
                                                 uint64_t s) {
  return a.fresh || (__ldcg(a.tkey_lo + s) == 0 &&
                     __ldcg(a.tkey_hi + s) == 0 && a.tomb[s] == 0);
}

static __device__ __forceinline__ void contend(const RoundArgs& a, int i,
                                               uint64_t s, int64_t t) {
  if (slot_free(a, s))
    atomicMin(a.word + s, ((ull)t << 32) | (unsigned)i);
}

// Whether lane i won slot s in round t; the winner takes it: its claim,
// and (a table that holds rows) the key as the slot's mark.
static __device__ __forceinline__ bool won(const RoundArgs& a, int i,
                                           uint64_t s, int64_t t) {
  if (__ldcg(a.word + s) != (((ull)t << 32) | (unsigned)i)) return false;
  a.claimed[i] = (int64_t)s;
  if (!a.fresh) {
    __stcg(a.tkey_lo + s, a.key_lo[i]);
    __stcg(a.tkey_hi + s, a.key_hi[i]);
  }
  return true;
}

static __device__ __forceinline__ void set_overflow(const RoundArgs& a) {
  if (a.flag_word) {
    atomicOr(a.flag_word, a.flag_bit);
  } else {
    *a.probe_overflow = 1;
  }
}

// Appends `w` (where `lose`) to `list`, one device atomic a block (a
// warp's atomics on one counter queue behind each other at L2); every
// thread of the block calls it.  `s_cnt` is 33 ints of shared memory.
static __device__ __forceinline__ void block_append(bool lose, int2 w,
                                                    int2* list, int* count,
                                                    int* s_cnt) {
  const unsigned ball = __ballot_sync(0xffffffffu, lose);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_cnt[warp] = __popc(ball);
  __syncthreads();
  if (warp == 0) {
    const int nw = (int)(blockDim.x >> 5);
    const int c = lane < nw ? s_cnt[lane] : 0;
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    int base = 0;
    if (lane == 0 && total) base = atomicAdd(count, total);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (lane < nw) s_cnt[lane] = base + incl - c;
  }
  __syncthreads();
  if (lose) list[s_cnt[warp] + __popc(ball & ((1u << lane) - 1))] = w;
  __syncthreads();  // s_cnt is free for the next call
}

// Round 0, contend: every lane's claim is C; a masked lane whose home is
// free contends for it.
__global__ void __launch_bounds__(PASS_THREADS)
    claim_first_kernel(RoundArgs a) {
  PHASE_MARK(0);
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  a.claimed[i] = (int64_t)a.mask + 1;
  if (!a.insert_mask[i]) return;
  if (a.max_probe <= 0) {
    set_overflow(a);
    return;
  }
  const int h = lane_home(a, i);
  contend(a, (int)i, (uint64_t)h, 0);
}

// Round 0, resolve: the home's lowest contender takes it; every other
// masked lane joins the walkers of round 1.
__global__ void __launch_bounds__(RESOLVE0_THREADS)
    claim_second_kernel(RoundArgs a) {
  __shared__ int s_cnt[33];
  PHASE_MARK(1);
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  bool lose = false;
  int h = 0;
  if (i < a.n && a.max_probe > 0 && a.insert_mask[i]) {
    h = lane_home(a, i);
    lose = !won(a, (int)i, (uint64_t)h, 0);
  }
  block_append(lose, make_int2((int)i, h), a.list0, a.cnt, s_cnt);
}

// Rounds 1, 2, ...: round t reads the list (t - 1) & 1 and writes its
// losers to the other, whose length its thread 0 clears first (its last
// reader was round t - 1's start, two grid barriers back).
__global__ void __launch_bounds__(ROUNDS_THREADS)
    claim_rounds_kernel(RoundArgs a) {
  __shared__ int2 tail[2][TAIL_MAX];
  __shared__ int tail_len[2], s_cnt[33];
  PHASE_MARK(2);
  cg::grid_group grid = cg::this_grid();
  const int64_t gtid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t t = 1;
  for (;; ++t) {
    const int cur = (int)((t - 1) & 1);
    const int len = __ldcg(a.cnt + cur);
    if (len == 0) return;
    if (t >= a.max_probe) {
      if (gtid == 0) set_overflow(a);
      return;
    }
    if (len <= TAIL_MAX) break;
    const int2* from = cur ? a.list1 : a.list0;
    int2* to = cur ? a.list0 : a.list1;
    if (gtid == 0) atomicExch(a.cnt + (cur ^ 1), 0);
    for (int64_t e = gtid; e < len; e += stride) {
      const int2 w = __ldcg(from + e);
      contend(a, w.x, ((uint64_t)w.y + (uint64_t)t) & a.mask, t);
    }
    grid.sync();
    for (int64_t b0 = 0; b0 < len; b0 += stride) {
      const int64_t e = b0 + gtid;
      bool lose = false;
      int2 w = make_int2(0, 0);
      if (e < len) {
        w = __ldcg(from + e);
        lose = !won(a, w.x, ((uint64_t)w.y + (uint64_t)t) & a.mask, t);
      }
      block_append(lose, w, to, a.cnt + (cur ^ 1), s_cnt);
    }
    grid.sync();
  }
  // The tail: block 0 alone, the walkers in shared memory.
  if (blockIdx.x != 0) return;
  PHASE_MARK(3);
  int c = (int)((t - 1) & 1);
  {
    const int len = __ldcg(a.cnt + c);
    const int2* from = c ? a.list1 : a.list0;
    for (int e = threadIdx.x; e < len; e += blockDim.x)
      tail[0][e] = __ldcg(from + e);
    if (threadIdx.x == 0) tail_len[0] = len;
    c = 0;
  }
  __syncthreads();
  for (;; ++t) {
    const int len = tail_len[c];
    if (len == 0) break;
    if (t >= a.max_probe) {
      if (threadIdx.x == 0) set_overflow(a);
      break;
    }
    for (int e = threadIdx.x; e < len; e += blockDim.x) {
      const int2 w = tail[c][e];
      contend(a, w.x, ((uint64_t)w.y + (uint64_t)t) & a.mask, t);
    }
    if (threadIdx.x == 0) tail_len[c ^ 1] = 0;
    __syncthreads();
    for (int e = threadIdx.x; e < len; e += blockDim.x) {
      const int2 w = tail[c][e];
      if (!won(a, w.x, ((uint64_t)w.y + (uint64_t)t) & a.mask, t))
        tail[c ^ 1][atomicAdd(tail_len + (c ^ 1), 1)] = w;
    }
    __syncthreads();
    c ^= 1;
  }
  PHASE_MARK(4);
}

// The round form's claims (in a table that holds rows, its keys hold them
// as marks after it): two memsets, the two round-0 launches, the
// cooperative rounds.
static int launch_rounds(const Batch& b, void* word, void* lists, void* cnt,
                         int fresh, uint8_t* probe_overflow, int* flag_word,
                         int flag_bit) {
  if (b.n > INT_MAX || b.cap > ((int64_t)1 << 31) || word == nullptr ||
      lists == nullptr || cnt == nullptr)
    return (int)cudaErrorInvalidValue;
  RoundArgs a;
  a.tkey_lo = b.tkey_lo;
  a.tkey_hi = b.tkey_hi;
  a.tomb = b.tomb;
  a.mask = (uint64_t)(b.cap - 1);
  a.hash_shift = b.hash_shift;
  a.max_probe = b.max_probe;
  a.key_lo = b.key_lo;
  a.key_hi = b.key_hi;
  a.insert_mask = b.insert_mask;
  a.n = b.n;
  a.claimed = b.claimed;
  a.word = (ull*)word;
  a.list0 = (int2*)lists;
  a.list1 = (int2*)lists + b.n;
  a.cnt = (int*)cnt;
  a.fresh = fresh;
  a.probe_overflow = probe_overflow;
  a.flag_word = flag_word;
  a.flag_bit = flag_bit;
  cudaError_t e = cudaMemsetAsync(word, 0xFF, (size_t)b.cap * 8, b.stream);
  if (e == cudaSuccess) e = cudaMemsetAsync(cnt, 0, 2 * sizeof(int), b.stream);
  if (e != cudaSuccess) return (int)e;
  const unsigned pass_blocks =
      (unsigned)((b.n + PASS_THREADS - 1) / PASS_THREADS);
  claim_first_kernel<<<pass_blocks, PASS_THREADS, 0, b.stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  claim_second_kernel<<<(unsigned)((b.n + RESOLVE0_THREADS - 1) /
                                    RESOLVE0_THREADS),
                        RESOLVE0_THREADS, 0, b.stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, claim_rounds_kernel, ROUNDS_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  int64_t blocks = (b.n + ROUNDS_THREADS - 1) / ROUNDS_THREADS;
  const int64_t resident = (int64_t)sms * per_sm;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)claim_rounds_kernel,
                                  dim3((unsigned)blocks), dim3(ROUNDS_THREADS),
                                  args, 0, b.stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves its error behind
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// The launch the round form takes for n lanes: registers and local bytes
// a thread, threads a block, blocks a SM, blocks, TAIL_MAX.
extern "C" int tb_insert_rounds_info(int64_t n, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, claim_rounds_kernel, ROUNDS_THREADS, 0);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, claim_rounds_kernel);
  if (e != cudaSuccess) return (int)e;
  int64_t blocks = (n + ROUNDS_THREADS - 1) / ROUNDS_THREADS;
  if (blocks > (int64_t)sms * per_sm) blocks = (int64_t)sms * per_sm;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = ROUNDS_THREADS;
  out[3] = per_sm;
  out[4] = (int)blocks;
  out[5] = TAIL_MAX;
  return 0;
}

// -- entry points ------------------------------------------------------------

static Batch make_batch(void* tkey_lo, void* tkey_hi, const void* tomb,
                        int64_t capacity, int hash_shift, int64_t max_probe,
                        const void* key_lo, const void* key_hi,
                        const void* insert_mask, int64_t n, void* claimed,
                        void* stream) {
  Batch b;
  b.tkey_lo = (ull*)tkey_lo;
  b.tkey_hi = (ull*)tkey_hi;
  b.tomb = (uint8_t*)const_cast<void*>(tomb);
  b.cap = capacity;
  b.hash_shift = hash_shift;
  b.max_probe = max_probe;
  b.key_lo = (const ull*)key_lo;
  b.key_hi = (const ull*)key_hi;
  b.insert_mask = (const uint8_t*)insert_mask;
  b.n = n;
  b.claimed = (int64_t*)claimed;
  b.stream = (cudaStream_t)stream;
  return b;
}

// The split form when `pre` is given (n <= SPLIT_MAX_N), else the round
// form on claim/lists/cnt; then the rows.
extern "C" int tb_insert(void* tkey_lo, void* tkey_hi, void* tomb,
                         int64_t capacity, int hash_shift, int64_t max_probe,
                         const void* key_lo, const void* key_hi,
                         const void* insert_mask, int64_t n, void* claimed,
                         void* pre, void* claim, void* lists, void* cnt,
                         void* count, void* probe_overflow, int ncols,
                         const void* const* src, void* const* dst,
                         const int* width, int fill, void* stream) {
  ColList rows;
  int err = pack_cols(&rows, ncols, src, dst, width);
  if (err) return err;
  if (fill && pre) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Batch b = make_batch(tkey_lo, tkey_hi, tomb, capacity, hash_shift,
                             max_probe, key_lo, key_hi, insert_mask, n,
                             claimed, stream);
  err = pre ? launch_claims(b, pre, (uint8_t*)probe_overflow, nullptr, 0)
            : launch_rounds(b, claim, lists, cnt, fill,
                            (uint8_t*)probe_overflow, nullptr, 0);
  if (err) return err;
  // `fill`: the table is fresh (no array written yet); the round form
  // reads none of it and every slot is written, from its slot words.
  return launch_writes(b.tkey_lo, b.tkey_hi, b.tomb, b.cap, b.key_lo,
                       b.key_hi, b.claimed, b.insert_mask, n, nullptr, 0,
                       MODE_ROWS, rows, (ull*)count, b.stream,
                       fill ? (const ull*)claim : nullptr);
}

extern "C" int tb_claim(void* tkey_lo, void* tkey_hi, const void* tomb,
                        int64_t capacity, int hash_shift, int64_t max_probe,
                        const void* key_lo, const void* key_hi,
                        const void* insert_mask, int64_t n, void* claimed,
                        void* pre, void* claim, void* lists, void* cnt,
                        void* flag_word, int flag_bit, void* stream) {
  if (n == 0) return 0;
  const Batch b = make_batch(tkey_lo, tkey_hi, tomb, capacity, hash_shift,
                             max_probe, key_lo, key_hi, insert_mask, n,
                             claimed, stream);
  if (!pre) {  // the round kernel leaves the marks itself
    return launch_rounds(b, claim, lists, cnt, 0, nullptr, (int*)flag_word,
                         flag_bit);
  }
  int err = launch_claims(b, pre, nullptr, (int*)flag_word, flag_bit);
  if (err) return err;
  ColList none;
  none.n = 0;
  return launch_writes(b.tkey_lo, b.tkey_hi, b.tomb, b.cap, b.key_lo,
                       b.key_hi, b.claimed, nullptr, n, nullptr, 0, MODE_MARKS,
                       none, nullptr, b.stream);
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
  return launch_writes((ull*)tkey_lo, (ull*)tkey_hi, (uint8_t*)tomb, capacity,
                       (const ull*)key_lo, (const ull*)key_hi,
                       (const int64_t*)claimed, (const uint8_t*)write_mask, n,
                       (const int*)gate, revert, MODE_ROWS, rows, (ull*)count,
                       (cudaStream_t)stream);
}

PHASE_CLOCK_ENTRIES(tb_insert_phases)
