// Shared pieces of the transfer-index kernels K13-K15.
//
// A run (one level of the index) is five u64 columns in the order of
// ops/index.py COLS: acct_lo, acct_hi, ts, tid_lo, tid_hi, sorted by the key
// (acct_hi, acct_lo, ts).  A sentinel entry is U64_MAX in all five columns.
#pragma once

#include "common.cuh"

enum { IX_ACCT_LO = 0, IX_ACCT_HI = 1, IX_TS = 2, IX_TID_LO = 3, IX_TID_HI = 4 };
#define IX_SENT 0xFFFFFFFFFFFFFFFFull

struct IxKey {
  uint64_t hi, lo, ts;
};

static __device__ __forceinline__ bool ix_less(const IxKey& a, const IxKey& b) {
  if (a.hi != b.hi) return a.hi < b.hi;
  if (a.lo != b.lo) return a.lo < b.lo;
  return a.ts < b.ts;
}

static __device__ __forceinline__ IxKey ix_load(const uint64_t* const* c,
                                                int64_t i) {
  return IxKey{c[IX_ACCT_HI][i], c[IX_ACCT_LO][i], c[IX_TS][i]};
}

// The merge-path split of diagonal d: how many of the first d outputs of
// the stable merge of sorted A (la entries) and B (lb) come from A, A first
// on equal keys.  `b_less_a(i, j)` is true when B[j] sorts strictly before
// A[i].  K14 takes its block and thread splits from it.
template <class Int, class BLessA>
static __device__ __forceinline__ Int merge_split(Int la, Int lb, Int d,
                                                  BLessA b_less_a) {
  Int lo = d - lb > 0 ? d - lb : 0;
  Int hi = d < la ? d : la;
  while (lo < hi) {
    const Int mid = (lo + hi) >> 1;
    if (!b_less_a(mid, d - 1 - mid))
      lo = mid + 1;  // A[mid] is among the first d outputs
    else
      hi = mid;
  }
  return lo;
}
