// K4 balance: exact u128 balance updates of every account an accepted
// transfer touches, in one launch.
//
// Replaces tigerbeetle_tpu/ops/state_machine.py:574 `balance_plan` (a sort of
// the 2N legs by account slot and a segment sum of 32-bit limbs) and :644
// `apply_balance_plan` (gather, u128 add, scatter at the group heads, i.e.
// hash_table.py:344 `scatter_cols`).
//
// Design: no sort and no scratch.  One thread per leg (2N legs: lane i's
// debit leg is leg i, its credit leg leg N + i).  An accepted leg adds its
// amount into the lo word of its balance field (debits_pending or
// debits_posted for the debit leg, credits_* for the credit leg) with one
// 64-bit atomicAdd; the old value it returns shows whether the add wrapped
// past 2^64, and each wrap adds 1 to the hi word.  Fast-path precondition P3
// (amount_hi == 0, balances bounded away from 2^128; the JAX code relies on
// it too) makes every term a u64, so the final (hi, lo) is the old balance
// plus the sum of the legs mod 2^128 whatever the order of the atomics:
// integer sums commute, and the number of wraps of the lo word is
// floor((lo + sum) / 2^64) in any order.  Those are the bytes balance_plan +
// apply_balance_plan give.
//
// Hot accounts: the lanes of a warp that hit the same word (same slot and
// field, found with __match_any_sync) sum their amounts first as a u128
// (a 64-bit sum with a carry count), and only the group's lowest lane
// issues the lo atomic and one hi atomic for the group's high part plus the
// wrap.  A warp whose legs all hit distinct words skips the sum.
//
// The slot-base form serves one shard of a sharded ledger
// (tigerbeetle_tpu/parallel/sharded.py:213-229): the slots are global
// (shard * C/n + local slot), and only the legs whose slot lies in
// [slot_base, slot_base + C) apply, at slot - slot_base of the shard's
// local columns (C their length); the single-device ledger passes base 0.
//
// What bounds it on the H100: bytes and the latency of atomics at random
// slots: 2N legs of 8-B slot + 8-B amount + 1-B flag reads, one atomic per
// accepted leg (two when it wraps) on the touched accounts' words.  Nothing
// scales with the accounts capacity C.
#include "common.cuh"

struct Balances {
  uint64_t* col[8];  // debits_pending lo/hi, debits_posted lo/hi,
                     // credits_pending lo/hi, credits_posted lo/hi
};

#define NO_WORD (~0ull)

__global__ void balance_kernel(const int64_t* __restrict__ dr_slot,
                               const int64_t* __restrict__ cr_slot,
                               const uint8_t* __restrict__ ok,
                               const uint64_t* __restrict__ amount,
                               const uint8_t* __restrict__ pending, int64_t n,
                               int64_t slot_base, uint64_t cap, Balances bal) {
  const int64_t leg = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const unsigned lane = threadIdx.x & 31;
  // Every lane of the warp takes part in the warp-wide steps below; a lane
  // with nothing to add carries the word NO_WORD.
  ull word = NO_WORD;
  ull a = 0;
  if (leg < 2 * n) {
    const bool debit = leg < n;
    const int64_t i = debit ? leg : leg - n;
    if (ok[i]) {
      const uint64_t slot =
          (uint64_t)((debit ? dr_slot[i] : cr_slot[i]) - slot_base);
      if (slot < cap) {  // else another shard's account
        // Field 0-3: debits_pending, debits_posted, credits_pending,
        // credits_posted.
        const int field = (debit ? 0 : 2) + (pending[i] ? 0 : 1);
        word = slot * 4 + (ull)field;
        a = amount[i];
      }
    }
  }
  const unsigned peers = __match_any_sync(0xffffffffu, word);
  ull sum_lo = a, sum_hi = 0;
  const bool alone = peers == (1u << lane);
  if (!__all_sync(0xffffffffu, alone || word == NO_WORD)) {
    sum_lo = 0;
    for (int k = 0; k < 32; ++k) {
      const ull v = __shfl_sync(0xffffffffu, a, k);
      if ((peers >> k) & 1u) {
        sum_lo += v;
        sum_hi += sum_lo < v ? 1 : 0;
      }
    }
  }
  if (word == NO_WORD || (int)lane != __ffs(peers) - 1) return;
  const uint64_t slot = word >> 2;
  const int field = (int)(word & 3);
  ull* lo = reinterpret_cast<ull*>(bal.col[2 * field]) + slot;
  ull* hi = reinterpret_cast<ull*>(bal.col[2 * field + 1]) + slot;
  const ull old = atomicAdd(lo, sum_lo);
  const ull carry = old + sum_lo < old ? 1 : 0;
  if (sum_hi + carry != 0) atomicAdd(hi, sum_hi + carry);
}

extern "C" int tb_balance(const void* dr_slot, const void* cr_slot,
                          const void* ok, const void* amount,
                          const void* pending, int64_t n, int64_t slot_base,
                          int64_t cap, void* const* balance_cols, void* stream) {
  if (n == 0) return 0;
  Balances bal;
  for (int k = 0; k < 8; ++k) bal.col[k] = (uint64_t*)balance_cols[k];
  const int threads = 256;
  balance_kernel<<<(unsigned)((2 * n + threads - 1) / threads), threads, 0,
                   (cudaStream_t)stream>>>(
      (const int64_t*)dr_slot, (const int64_t*)cr_slot, (const uint8_t*)ok,
      (const uint64_t*)amount, (const uint8_t*)pending, n, slot_base,
      (uint64_t)cap, bal);
  return (int)cudaGetLastError();
}
