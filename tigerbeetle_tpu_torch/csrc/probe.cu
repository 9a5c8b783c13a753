// K1 probe: batched linear probes of the hash tables fused with their column
// gathers, up to PROBE_MAX_DESC lookups in one launch.
//
// Replaces tigerbeetle_tpu/ops/hash_table.py:70 `lookup` (a lax.while_loop
// over all lanes) with the column gather of :335 `gather_cols`, and the
// u128.py:118 `mix64` it hashes with.
//
// Semantics of one lookup (bit for bit the JAX function): home =
// (mix64(key) >> shift) & (C-1); a lane probes home, home+1, ... for at most
// max_probe steps; it is done on a slot holding its key and no tombstone
// (found) or on an empty slot with no tombstone (absent); a lane with key 0
// is done at once.  `found` is masked to lanes below `valid_count` (or the
// u64 device word `count_word`) and, when `lane_mask` is not null, to the
// lanes it sets; `slot` is the matching slot or 0; the gathered columns are
// zero where not found; the lookup's overflow byte is set when any lane is
// not done after max_probe steps.
//
// What bounds it on the H100: bytes at random addresses, and the dependent
// round trips of each lane (a probe step's keys, then its row).  The design:
//  - a batch's lookups share one launch: blockIdx.y picks a chain of
//    descriptors, and a thread runs its lane through the chain in order, so
//    a lookup whose keys are an earlier lookup's gathered columns (the
//    general path's pending accounts and posted row) reads them back from
//    its own stores.  The main path's three probes are one launch where
//    they were three probes, three fills and three compares;
//  - a probe round reads the aligned group of four slots that holds `cur`
//    (one 32-B sector of key_lo, one of key_hi, a 4-B word of tombstones)
//    and decides up to four slots in linear-probe order (the wrap at the
//    mask falls between groups; tombstones are skipped, never stopped at);
//  - a found lane loads every column of its row (up to 16 at once) before
//    it stores any, so a row costs one round trip, not one a column;
//  - blocks of 128 threads: a batch of 8,192 lanes and three lookups is
//    192 blocks over the 132 SMs.
// The overflow bytes are zeroed by one memset in the entry point, and only
// when the caller asks for them (the main path does not).
//
// The flag word (the general path's K17 step).  A launch may carry
// an int32 word beside its overflow bytes, zeroed by the same memset: a
// lookup ORs its `grow_bit` into it when a lane runs out of probes, and a
// lookup marked `cold` tests, on every lane under its mask, below its
// count, not found and not certified by `checked`, its own key against
// the cold tier's Bloom filter (replacing K17's separate launch over the
// same lanes, tigerbeetle_tpu/ops/transfer_full.py:638-659): BLOOM_HASHES
// = 4 bit positions double-hashed from mix64 (ops/cold.py:60
// `_bloom_positions`), all four set is a hit, and a hit ORs `cold_bit`.
// The four loads are issued together as soon as the probe says the lane is
// tested, and read only after the chain's last lookup, so the round trip
// overlaps the lookup's stores and the chain's later lookups (the
// pending's accounts and posted row).  (Issued before the probe, for every
// lane, they made the launch slower at the tiered shape: PERF.md §6.)
// Each warp ORs its lanes' bits together and makes one atomicOr.  The general kernel's
// FLAG_GROW_* and FLAG_COLD bits are then this word, on the card, with no
// launch of its own.  It is a compile-time variant (`FLAGS`): the main
// path's instance has no word and compiles as it did.
#include "common.cuh"
#include "phase_clock.cuh"

#define PROBE_MAX_DESC 8
#define PROBE_MAX_COLS 96
#define PROBE_THREADS 128
#define PROBE_BATCH_COLS 16  // a found lane's loads in flight at once
#define BLOOM_HASHES 4

#ifdef TB_PHASE_CLOCK
#define PROBE_BARRIER() __syncthreads()
#else
#define PROBE_BARRIER() \
  do {                  \
  } while (0)
#endif

struct ProbeDesc {
  const uint64_t* tkey_lo;
  const uint64_t* tkey_hi;
  const uint8_t* tomb;
  uint64_t mask;  // capacity - 1
  int hash_shift;
  int grouped;  // the table is read four slots a round (aligned, C >= 4)
  const uint64_t* key_lo;
  const uint64_t* key_hi;  // null: every key_hi is 0
  int64_t valid_count;
  const uint64_t* count_word;  // null: valid_count holds
  const uint8_t* lane_mask;    // null: every lane
  uint8_t* found;
  int64_t* slot;
  uint8_t* overflow;  // null: not asked for
  int col0, ncols;    // the lookup's columns in the pool
  int next;           // the next lookup of this chain, or -1
  int grow_bit;       // ORed into the flag word when a lane overflows
  int cold;           // the lanes test their key against the filter
};

struct ProbeArgs {
  int64_t n;
  int64_t max_probe;
  int head[PROBE_MAX_DESC];  // each chain's first lookup
  ProbeDesc d[PROBE_MAX_DESC];
  const void* src[PROBE_MAX_COLS];
  void* dst[PROBE_MAX_COLS];
  int width[PROBE_MAX_COLS];  // bytes: 1, 4 or 8
  // The flag word's launches only (FLAGS):
  const uint32_t* bloom;   // the filter's u32 words, or null
  uint64_t bloom_mask;     // its bit count - 1
  const uint8_t* checked;  // lanes certified not cold, or null
  int* flag_word;
  int cold_bit;
};

// A lane's filter test in flight: the four words loaded and the bit of
// each (five bits apiece in `bits`).  `armed` once issued; read by
// bloom_hit after the chain.
struct BloomTest {
  uint32_t w[BLOOM_HASHES];
  uint32_t bits;
  bool armed;
};

static __device__ __forceinline__ void bloom_issue(const ProbeArgs& A,
                                                   uint64_t lo, uint64_t hi,
                                                   BloomTest* bt) {
  const uint64_t h1 = mix64(lo, hi);
  const uint64_t h2 = mix64(hi ^ 0x9E3779B97F4A7C15ull, lo) | 1ull;
  bt->bits = 0;
#pragma unroll
  for (int j = 0; j < BLOOM_HASHES; ++j) {
    const uint64_t pos = (h1 + (uint64_t)j * h2) & A.bloom_mask;
    bt->w[j] = __ldg(A.bloom + (pos >> 5));
    bt->bits |= (uint32_t)(pos & 31) << (5 * j);
  }
  bt->armed = true;
}

static __device__ __forceinline__ bool bloom_hit(const BloomTest& bt) {
  if (!bt.armed) return false;
  uint32_t all = 1u;
#pragma unroll
  for (int j = 0; j < BLOOM_HASHES; ++j)
    all &= bt.w[j] >> ((bt.bits >> (5 * j)) & 31);
  return all & 1u;
}

static __device__ __forceinline__ uint64_t load_elem(const void* src,
                                                     int64_t i, int width) {
  if (width == 8) return static_cast<const uint64_t*>(src)[i];
  if (width == 4) return static_cast<const uint32_t*>(src)[i];
  return static_cast<const uint8_t*>(src)[i];
}

static __device__ __forceinline__ void store_elem(void* dst, int64_t i,
                                                  int width, uint64_t v) {
  if (width == 8) {
    static_cast<uint64_t*>(dst)[i] = v;
  } else if (width == 4) {
    static_cast<uint32_t*>(dst)[i] = (uint32_t)v;
  } else {
    static_cast<uint8_t*>(dst)[i] = (uint8_t)v;
  }
}

// One slot of a round: decides the lane when the slot is live.
static __device__ __forceinline__ void probe_slot(uint64_t a, uint64_t b,
                                                  bool tb, uint64_t lo,
                                                  uint64_t hi, uint64_t s,
                                                  bool* done, bool* found,
                                                  uint64_t* slot) {
  if (tb) return;
  if (a == lo && b == hi) {
    *found = true;
    *slot = s;
    *done = true;
  } else if (a == 0 && b == 0) {
    *done = true;
  }
}

// The probe of lane i against one table: (done, found, slot).
static __device__ void probe_lane(const ProbeDesc& D, int64_t max_probe,
                                  uint64_t lo, uint64_t hi, bool* done_out,
                                  bool* found_out, uint64_t* slot_out) {
  bool done = lo == 0 && hi == 0, found = false;
  uint64_t slot = 0;
  const uint64_t home = (mix64(lo, hi) >> D.hash_shift) & D.mask;
  int64_t t = 0;
  if (D.grouped) {
    uint64_t cur = home;
    while (!done && t < max_probe) {
      const uint64_t base = cur & ~3ull;
      const ulonglong2* plo = reinterpret_cast<const ulonglong2*>(D.tkey_lo + base);
      const ulonglong2* phi = reinterpret_cast<const ulonglong2*>(D.tkey_hi + base);
      const ulonglong2 l0 = plo[0], l1 = plo[1], h0 = phi[0], h1 = phi[1];
      const uint32_t tw = *reinterpret_cast<const uint32_t*>(D.tomb + base);
      const int off = (int)(cur & 3);
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        if (o >= off && !done && t < max_probe) {
          const uint64_t a = o == 0 ? l0.x : o == 1 ? l0.y : o == 2 ? l1.x : l1.y;
          const uint64_t b = o == 0 ? h0.x : o == 1 ? h0.y : o == 2 ? h1.x : h1.y;
          probe_slot(a, b, ((tw >> (8 * o)) & 0xFFu) != 0, lo, hi, base + o,
                     &done, &found, &slot);
          ++t;
        }
      }
      cur = (base + 4) & D.mask;
    }
  } else {
    for (; t < max_probe && !done; ++t) {
      const uint64_t cur = (home + (uint64_t)t) & D.mask;
      probe_slot(D.tkey_lo[cur], D.tkey_hi[cur], D.tomb[cur] != 0, lo, hi, cur,
                 &done, &found, &slot);
    }
  }
  *done_out = done;
  *found_out = found;
  *slot_out = slot;
}

// `act` is false only for the pad lanes of the clocked build, whose barriers
// need every thread: such a lane probes key 0 and stores nothing.  In the
// FLAGS variant it returns the lane's bits for the flag word and issues the
// filter test of a `cold` lookup into `bt` (the caller reads it).
template <bool FLAGS>
static __device__ int lookup_lane(const ProbeArgs& A, const ProbeDesc& D,
                                  int64_t i, bool act, BloomTest* bt) {
  const uint64_t lo = act ? D.key_lo[i] : 0;
  const uint64_t hi = act && D.key_hi ? D.key_hi[i] : 0;
  int bits = 0;
  bool done, found;
  uint64_t slot;
  probe_lane(D, A.max_probe, lo, hi, &done, &found, &slot);
  PROBE_BARRIER();
  PHASE_MARK(1);
  if (!act) i = 0;
  if (!done && D.overflow) *D.overflow = 1;
  const int64_t vc = D.count_word ? (int64_t)*D.count_word : D.valid_count;
  const bool in_mask = i < vc && (!D.lane_mask || D.lane_mask[i]);
  const bool f = found && in_mask;
  if constexpr (FLAGS) {
    if (!done) bits |= D.grow_bit;
    if (D.cold && act && in_mask && !found && !(A.checked && A.checked[i])) {
      if (bloom_hit(*bt)) bits |= A.cold_bit;
      bloom_issue(A, lo, hi, bt);
    }
  }
  if (act) {
    D.found[i] = f ? 1 : 0;
    D.slot[i] = (int64_t)slot;
  }
  const int end = D.col0 + D.ncols;
  for (int c0 = D.col0; c0 < end; c0 += PROBE_BATCH_COLS) {
    uint64_t v[PROBE_BATCH_COLS];
#pragma unroll
    for (int k = 0; k < PROBE_BATCH_COLS; ++k)
      v[k] = (f && c0 + k < end) ? load_elem(A.src[c0 + k], (int64_t)slot,
                                             A.width[c0 + k])
                                 : 0;
    PROBE_BARRIER();
    PHASE_MARK(2);
#pragma unroll
    for (int k = 0; k < PROBE_BATCH_COLS; ++k)
      if (act && c0 + k < end)
        store_elem(A.dst[c0 + k], i, A.width[c0 + k], v[k]);
  }
  PROBE_BARRIER();
  PHASE_MARK(3);
  return bits;
}

template <bool FLAGS>
__global__ void __launch_bounds__(PROBE_THREADS)
    probe_kernel(const __grid_constant__ ProbeArgs A) {
  PHASE_MARK(0);
  const int64_t i = blockIdx.x * (int64_t)PROBE_THREADS + threadIdx.x;
#ifdef TB_PHASE_CLOCK
  const unsigned live = 0xffffffffu;
#else
  // The warp's lanes below n: the flag word's reduction names only them,
  // since the others leave here.
  unsigned live = 0u;
  if constexpr (FLAGS) live = __ballot_sync(0xffffffffu, i < A.n);
  if (i >= A.n) return;
#endif
  BloomTest bt;
  bt.armed = false;
  int bits = 0;
  for (int k = A.head[blockIdx.y]; k >= 0; k = A.d[k].next)
    bits |= lookup_lane<FLAGS>(A, A.d[k], i, i < A.n, &bt);
  if constexpr (FLAGS) {
    if (bloom_hit(bt)) bits |= A.cold_bit;
    bits = (int)__reduce_or_sync(live, (unsigned)bits);
    if (bits && (threadIdx.x & 31) == __ffs(live) - 1) atomicOr(A.flag_word, bits);
  }
}

// One launch of `nd` lookups (ProbeDesc order of the wrapper's arrays) over
// `n` lanes each, in `nchains` chains: `next[k]` is the lookup run after k by
// the same thread (-1 ends a chain), `heads` the chains' first lookups.
// Per lookup k: its table (tkey_lo, tkey_hi, tomb, cap, hash_shift), its
// keys (key_hi[k] may be null: zeros), valid_count / count_word / lane_mask,
// its outputs (found, slot) and `ncols[k]` columns (src, dst, width) from
// the pooled arrays.  `overflow`, when not null, is u8[nd]: zeroed here
// (one memset), byte k set when a lane of lookup k ran out of probes.
// `flag_word`, when not null, is the int32 at byte 8 of `overflow` (which
// is then at least 12 bytes, all zeroed by the one memset) and takes the
// FLAGS variant: lookup k ORs `grow_bit[k]` into it on an overflow, and
// with `cold[k]` tests its lanes' keys against `bloom` (`bloom_bits` bits,
// a power of two, u32 words) and ORs `cold_bit` on a hit; `checked` (u8[n]
// or null) certifies lanes.
extern "C" int tb_probe(int nd, int nchains, const int* heads, const int* next,
                        const void* const* tkey_lo, const void* const* tkey_hi,
                        const void* const* tomb, const int64_t* cap,
                        const int* hash_shift, int64_t max_probe,
                        const void* const* key_lo, const void* const* key_hi,
                        int64_t n, const int64_t* valid_count,
                        const void* const* count_word,
                        const void* const* lane_mask, void* const* found,
                        void* const* slot, void* overflow, const int* ncols,
                        const void* const* src, void* const* dst,
                        const int* width, void* flag_word, const int* grow_bit,
                        const int* cold, const void* bloom, int64_t bloom_bits,
                        const void* checked, int cold_bit, void* stream) {
  if (nd <= 0 || nd > PROBE_MAX_DESC || nchains <= 0 || nchains > nd ||
      n < 0 || max_probe < 0)
    return (int)cudaErrorInvalidValue;
  const bool flags = flag_word != nullptr;
  if (flags && (overflow == nullptr || (char*)flag_word != (char*)overflow + 8))
    return (int)cudaErrorInvalidValue;
  if (flags && bloom &&
      (bloom_bits < 32 || (bloom_bits & (bloom_bits - 1))))
    return (int)cudaErrorInvalidValue;
  ProbeArgs A;
  A.n = n;
  A.max_probe = max_probe;
  A.bloom = (const uint32_t*)bloom;
  A.bloom_mask = (uint64_t)bloom_bits - 1;
  A.checked = (const uint8_t*)checked;
  A.flag_word = (int*)flag_word;
  A.cold_bit = cold_bit;
  int total = 0;
  for (int k = 0; k < nd; ++k) {
    ProbeDesc& D = A.d[k];
    if (cap[k] <= 0 || (cap[k] & (cap[k] - 1)) || next[k] >= nd ||
        (next[k] >= 0 && next[k] <= k) || ncols[k] < 0 ||
        total + ncols[k] > PROBE_MAX_COLS)
      return (int)cudaErrorInvalidValue;
    D.tkey_lo = (const uint64_t*)tkey_lo[k];
    D.tkey_hi = (const uint64_t*)tkey_hi[k];
    D.tomb = (const uint8_t*)tomb[k];
    D.mask = (uint64_t)(cap[k] - 1);
    D.hash_shift = hash_shift[k];
    D.grouped = cap[k] >= 4 && ((uintptr_t)tkey_lo[k] & 15) == 0 &&
                ((uintptr_t)tkey_hi[k] & 15) == 0 &&
                ((uintptr_t)tomb[k] & 3) == 0;
    D.key_lo = (const uint64_t*)key_lo[k];
    D.key_hi = (const uint64_t*)key_hi[k];
    D.valid_count = valid_count[k];
    D.count_word = (const uint64_t*)count_word[k];
    D.lane_mask = (const uint8_t*)lane_mask[k];
    D.found = (uint8_t*)found[k];
    D.slot = (int64_t*)slot[k];
    D.overflow = overflow ? (uint8_t*)overflow + k : nullptr;
    D.col0 = total;
    D.ncols = ncols[k];
    D.next = next[k];
    D.grow_bit = flags ? grow_bit[k] : 0;
    D.cold = flags && cold[k];
    if (D.cold && bloom == nullptr) return (int)cudaErrorInvalidValue;
    for (int c = total; c < total + ncols[k]; ++c) {
      if (width[c] != 1 && width[c] != 4 && width[c] != 8)
        return (int)cudaErrorInvalidValue;
      A.src[c] = src[c];
      A.dst[c] = dst[c];
      A.width[c] = width[c];
    }
    total += ncols[k];
  }
  for (int c = 0; c < nchains; ++c) {
    if (heads[c] < 0 || heads[c] >= nd) return (int)cudaErrorInvalidValue;
    A.head[c] = heads[c];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (overflow) {
    cudaError_t e = cudaMemsetAsync(overflow, 0, flags ? 12 : (size_t)nd, s);
    if (e != cudaSuccess) return (int)e;
  }
  if (n == 0) return 0;
  const dim3 grid((unsigned)((n + PROBE_THREADS - 1) / PROBE_THREADS),
                  (unsigned)nchains);
  if (flags)
    probe_kernel<true><<<grid, PROBE_THREADS, 0, s>>>(A);
  else
    probe_kernel<false><<<grid, PROBE_THREADS, 0, s>>>(A);
  return (int)cudaGetLastError();
}

// What the compiler made of K1: registers and local memory a thread,
// threads a block, blocks resident on one SM, the argument block's bytes;
// then the registers, local memory and resident blocks of the FLAGS
// variant.
extern "C" int tb_probe_info(int* out) {
  const void* fns[2] = {(const void*)probe_kernel<false>,
                        (const void*)probe_kernel<true>};
  for (int v = 0; v < 2; ++v) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, fns[v]);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fns[v],
                                                        PROBE_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    int* o = v == 0 ? out : out + 5;
    o[0] = fa.numRegs;
    o[1] = (int)fa.localSizeBytes;
    o[2] = v == 0 ? PROBE_THREADS : per_sm;
    if (v == 0) {
      o[3] = per_sm;
      o[4] = (int)sizeof(ProbeArgs);
    }
  }
  return 0;
}

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

PHASE_CLOCK_ENTRIES(tb_probe_phases)
