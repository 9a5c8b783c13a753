// The per-slot row fold shared by the scrub digest (K21) and the Merkle
// leaves (K22, K23): tigerbeetle_tpu/ops/scrub.py:108 `row_hash_accounts`,
// :118 `row_hash_transfers`, :124 `row_hash_posted`, masked to live slots as
// :129 `leaf_hashes` masks them (a slot whose key is 0 folds to 0).
#pragma once

#include "common.cuh"

// One ledger pad: its keys and the columns its row fold digests.
//   PAD_ACCOUNTS:  the four balance fields lo/hi in ledger order, timestamp
//                  (nine u64 columns);
//   PAD_TRANSFERS: amount lo, amount hi, timestamp (three u64 columns);
//   PAD_POSTED:    fulfillment (one u32 column, widened to u64).
enum { PAD_ACCOUNTS = 0, PAD_TRANSFERS = 1, PAD_POSTED = 2 };

struct PadCols {
  const uint64_t* key_lo;
  const uint64_t* key_hi;
  const void* col[9];
  int64_t capacity;
  int kind;
};

static inline int pad_ncols(int kind) {
  return kind == PAD_ACCOUNTS ? 9 : kind == PAD_TRANSFERS ? 3 : 1;
}

static inline int pack_pad(PadCols* p, int kind, const void* key_lo,
                           const void* key_hi, const void* const* cols,
                           int64_t capacity) {
  if (kind < PAD_ACCOUNTS || kind > PAD_POSTED) return (int)cudaErrorInvalidValue;
  if (capacity <= 0 || (capacity & (capacity - 1))) return (int)cudaErrorInvalidValue;
  p->key_lo = (const uint64_t*)key_lo;
  p->key_hi = (const uint64_t*)key_hi;
  for (int k = 0; k < 9; ++k) p->col[k] = k < pad_ncols(kind) ? cols[k] : nullptr;
  p->capacity = capacity;
  p->kind = kind;
  return 0;
}

static __device__ __forceinline__ uint64_t u64_at(const void* col, int64_t i) {
  return static_cast<const uint64_t*>(col)[i];
}

// The row fold of the live slot `i` holding key (lo, hi).
static __device__ __forceinline__ uint64_t row_hash(const PadCols& p,
                                                    int64_t i, uint64_t lo,
                                                    uint64_t hi) {
  uint64_t h = mix64(lo, hi);
  if (p.kind == PAD_ACCOUNTS) {
#pragma unroll
    for (int f = 0; f < 4; ++f)
      h = mix64(h ^ u64_at(p.col[2 * f], i), h ^ u64_at(p.col[2 * f + 1], i));
    return mix64(h, u64_at(p.col[8], i));
  }
  if (p.kind == PAD_TRANSFERS) {
    h = mix64(h ^ u64_at(p.col[0], i), h ^ u64_at(p.col[1], i));
    return mix64(h, u64_at(p.col[2], i));
  }
  return mix64(h, (uint64_t)static_cast<const uint32_t*>(p.col[0])[i]);
}

// The leaf value of slot `i`: its row fold, or 0 where the slot is empty.
static __device__ __forceinline__ uint64_t leaf_at(const PadCols& p,
                                                   int64_t i) {
  const uint64_t lo = p.key_lo[i], hi = p.key_hi[i];
  if (lo == 0 && hi == 0) return 0;
  return row_hash(p, i, lo, hi);
}
