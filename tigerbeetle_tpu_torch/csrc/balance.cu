// K4 balance: exact u128 balance updates of every account an accepted
// transfer touches.
//
// Replaces tigerbeetle_tpu/ops/state_machine.py:574 `balance_plan` (a sort of
// the 2N legs by account slot and a segment sum of 32-bit limbs) and :644
// `apply_balance_plan` (gather, u128 add, scatter at the group heads, i.e.
// hash_table.py:344 `scatter_cols`).
//
// Design: no sort.  Pass 1, one thread per accepted lane, adds the low and
// high 32-bit limbs of the amount into a per-slot scratch of 8 u64 words
// (four balance fields by two limbs) with integer atomicAdd, for the debit
// leg (debits_pending or debits_posted) and the credit leg (credits_*).
// Integer addition commutes, so the sums do not depend on the order of the
// atomics, and they are exact: at most 2 x 8190 terms below 2^32 each.
// Pass 2, one thread per leg, elects one leg per touched slot (atomicExch on
// a per-slot flag), recombines the limbs into a u128 delta exactly as
// balance_plan does and adds it to the old balance with carry.  Fast-path
// precondition P3 (amount_hi == 0, balances bounded away from 2^128) rules
// out overflow, as in the JAX code.
//
// The slot-base form serves one shard of a sharded ledger
// (tigerbeetle_tpu/parallel/sharded.py:213-229): the slots are global
// (shard * C/n + local slot), and only the legs whose slot lies in
// [slot_base, slot_base + C) apply, at slot - slot_base of the shard's
// local columns (C their length); the single-device ledger passes base 0.
//
// What bounds it on the H100: bytes and atomics at random slots: 2N legs
// of 8-B slot + 8-B amount reads, 4 atomics per leg into 64-B scratch rows,
// and one 64-B read-modify-write of the balances per touched account.
#include "common.cuh"

struct Balances {
  uint64_t* col[8];  // debits_pending lo/hi, debits_posted lo/hi,
                     // credits_pending lo/hi, credits_posted lo/hi
};

__global__ void balance_accumulate(const int64_t* __restrict__ dr_slot,
                                   const int64_t* __restrict__ cr_slot,
                                   const uint8_t* __restrict__ ok,
                                   const uint64_t* __restrict__ amount,
                                   const uint8_t* __restrict__ pending, int64_t n,
                                   int64_t slot_base, uint64_t cap,
                                   ull* __restrict__ limbs) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n || !ok[i]) return;
  const uint64_t a = amount[i];
  const ull a0 = a & 0xFFFFFFFFull, a1 = a >> 32;
  const int f_dr = pending[i] ? 0 : 1;  // debits_pending : debits_posted
  const int f_cr = pending[i] ? 2 : 3;  // credits_pending : credits_posted
  const uint64_t dr = (uint64_t)(dr_slot[i] - slot_base);
  if (dr < cap) {
    ull* d = limbs + dr * 8 + 2 * f_dr;
    atomicAdd(d, a0);
    atomicAdd(d + 1, a1);
  }
  const uint64_t cr = (uint64_t)(cr_slot[i] - slot_base);
  if (cr < cap) {
    ull* c = limbs + cr * 8 + 2 * f_cr;
    atomicAdd(c, a0);
    atomicAdd(c + 1, a1);
  }
}

__global__ void balance_apply(const int64_t* __restrict__ dr_slot,
                              const int64_t* __restrict__ cr_slot,
                              const uint8_t* __restrict__ ok, int64_t n,
                              int64_t slot_base, uint64_t cap,
                              const ull* __restrict__ limbs,
                              int* __restrict__ taken, Balances bal) {
  const int64_t leg = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (leg >= 2 * n) return;
  const int64_t lane = leg < n ? leg : leg - n;
  if (!ok[lane]) return;
  const uint64_t slot =
      (uint64_t)((leg < n ? dr_slot[lane] : cr_slot[lane]) - slot_base);
  if (slot >= cap) return;  // another shard's account
  if (atomicExch(taken + slot, 1) != 0) return;
  for (int f = 0; f < 4; ++f) {
    const uint64_t sa0 = limbs[slot * 8 + 2 * f], sa1 = limbs[slot * 8 + 2 * f + 1];
    const uint64_t low_part = (sa1 & 0xFFFFFFFFull) << 32;
    const uint64_t d_lo = sa0 + low_part;
    const uint64_t d_hi = (sa1 >> 32) + (d_lo < low_part ? 1 : 0);
    const uint64_t old_lo = bal.col[2 * f][slot], old_hi = bal.col[2 * f + 1][slot];
    const uint64_t new_lo = old_lo + d_lo;
    bal.col[2 * f][slot] = new_lo;
    bal.col[2 * f + 1][slot] = old_hi + d_hi + (new_lo < old_lo ? 1 : 0);
  }
}

// `limbs` (u64[C * 8]) and `taken` (int32[C]) must be zero on entry; C is
// `cap`, the length of the balance columns.
extern "C" int tb_balance(const void* dr_slot, const void* cr_slot,
                          const void* ok, const void* amount,
                          const void* pending, int64_t n, int64_t slot_base,
                          int64_t cap, void* limbs, void* taken,
                          void* const* balance_cols, void* stream) {
  if (n == 0) return 0;
  Balances bal;
  for (int k = 0; k < 8; ++k) bal.col[k] = (uint64_t*)balance_cols[k];
  const int threads = 256;
  balance_accumulate<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                       (cudaStream_t)stream>>>(
      (const int64_t*)dr_slot, (const int64_t*)cr_slot, (const uint8_t*)ok,
      (const uint64_t*)amount, (const uint8_t*)pending, n, slot_base,
      (uint64_t)cap, (ull*)limbs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  balance_apply<<<(unsigned)((2 * n + threads - 1) / threads), threads, 0,
                  (cudaStream_t)stream>>>(
      (const int64_t*)dr_slot, (const int64_t*)cr_slot, (const uint8_t*)ok, n,
      slot_base, (uint64_t)cap, (const ull*)limbs, (int*)taken, bal);
  return (int)cudaGetLastError();
}
