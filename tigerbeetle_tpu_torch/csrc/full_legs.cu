// K10 full_legs: exact running balances of all four account fields at every
// leg of a batch, and the apply's balance scatter.
//
// Replaces tigerbeetle_tpu/ops/transfer_full.py:266 `_leg_balances` (with
// :239 `_limbs_to_u128`) and the apply's account scatter at run tails,
// :1376-1386.
//
// Each event has a debit leg (2i) and a credit leg (2i+1).  Legs sorted by
// (account slot, leg position) put every account's legs together in event
// order, so sums of the legs' deltas within each slot run give each
// account's fields before (exclusive) and after (inclusive) every event.
// The six delta streams are the JAX function's: debits_pending added by a
// pending and released by a post or void (dp_add, dp_sub), debits_posted
// added by a regular transfer or a post (dpo_add), and the same three on
// the credit side; a leg's delta is 0 unless its lane was accepted by the
// previous Jacobi iterate (`ok`).  Per field, as in JAX:
//     added, ov = start + add;  val, neg = added - sub;  bad = ov | neg,
// at both the exclusive and the inclusive sums, and `arith_broken` is set
// when any live leg is bad.
//
// The JAX function splits each u64 delta into 16-bit parts and stacks a u32
// cumsum and cummax, for the TPU's vector memory; here the sums are exact
// unsigned __int128 segmented sums (a run of <= 2^14 u64 deltas stays
// under 2^78).  One block of 1,024 threads: the 2n keys are sorted in
// shared memory (bitonic, 128 KB for 16,384 legs), or copied from the
// sort cache when the legs' slots are those of the last sort (K12's, or
// the previous pass's: slots change between passes only through in-batch
// pending references); the six deltas of every sorted leg are computed
// once (the lane reads are the random ones); then each warp walks its own
// range of legs 32 at a time with warp-shuffle segmented scans, carried in
// from the warps before it, so every read and write is coalesced.
//
// In the Jacobi loop (full_pass.cu) the launch reads the loop's control
// words first and returns at once when the loop is over, so the host
// queues every pass without reading anything back.
//
// What bounds it on the H100: latency of the 105 sort steps and the seven
// block scans on one SM; the bytes (about 2.6 MB in and out at 8,192
// lanes) would take under 1 us at the card's 3.35 TB/s.
#include "full_common.cuh"

enum LegPtr {
  L_START,  // 8 leg-domain start balances: dp lo/hi, dpo, cp, cpo
  L_OK = L_START + 8, L_AMT, L_PAMT, L_DR_SLOT, L_CR_SLOT, L_DR_LIVE,
  L_CR_LIVE, L_PENDING, L_POST, L_POSTVOID,
  L_LEG_POS,
  L_VAL,  // 16 outputs: {dp, dpo, cp, cpo} x {pre, incl} x {lo, hi}
  L_S_SLOT = L_VAL + 16, L_S_LIVE, L_IS_LAST, L_ARITH,
  L_SCAN, L_HEAD,
  L_CTRL, L_PROVED, L_NEEDED,
  L_CACHE_KEYS, L_CACHE_SLOT, L_CACHE_OK,  // the sort cache, or null
  L_NPTRS
};

#define LP(T, k) (static_cast<T*>(const_cast<void*>(a.p[k])))

// The delta of stream s (0 dp_add, 1 dp_sub, 2 dpo_add, 3 cp_add, 4 cp_sub,
// 5 cpo_add) at leg L.
static __device__ __forceinline__ uint64_t leg_delta(const Ptrs& a, int s,
                                                     int L, bool has_pv) {
  const int i = L >> 1;
  const bool dr = (L & 1) == 0;
  if (!LP(const uint8_t, L_OK)[i]) return 0;
  const bool pend = LP(const uint8_t, L_PENDING)[i] != 0;
  const bool pv = LP(const uint8_t, L_POSTVOID)[i] != 0;
  const bool pst = LP(const uint8_t, L_POST)[i] != 0;
  const bool reg = !pend && !pv;
  const uint64_t amt = LP(const uint64_t, L_AMT)[i];
  const uint64_t pamt = LP(const uint64_t, L_PAMT)[i];
  switch (s) {
    case 0: return dr && pend ? amt : 0;
    case 1: return has_pv && dr && pv ? pamt : 0;
    case 2: return dr && (reg || pst) ? amt : 0;
    case 3: return !dr && pend ? amt : 0;
    case 4: return has_pv && !dr && pv ? pamt : 0;
    default: return !dr && (reg || pst) ? amt : 0;
  }
}

// A segmented sum: (a head was seen, the sum since the last head).
struct SegSum {
  u128 v;
  int head;
};
static __device__ __forceinline__ SegSum seg(u128 v, int head) {
  SegSum x;
  x.v = v;
  x.head = head;
  return x;
}
static __device__ __forceinline__ SegSum seg_op(SegSum a, SegSum b) {
  return seg(b.head ? b.v : a.v + b.v, a.head | b.head);
}
// Inclusive segmented scan across the warp (lane order), then the result
// carried in from `carry`; returns it and leaves lane 31's in `carry`.
static __device__ __forceinline__ SegSum warp_seg_scan(SegSum x,
                                                       SegSum* carry) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    SegSum t;
    t.v = shfl_up_any(x.v, off);
    t.head = shfl_up_any(x.head, off);
    if (lane >= off) x = seg_op(t, x);
  }
  x = seg_op(*carry, x);
  carry->v = ((u128)__shfl_sync(0xffffffffu, (unsigned long long)(x.v >> 64), 31)
              << 64) |
             __shfl_sync(0xffffffffu, (unsigned long long)x.v, 31);
  carry->head = __shfl_sync(0xffffffffu, x.head, 31);
  return x;
}

__global__ void __launch_bounds__(FULL_THREADS, 1)
    full_legs_kernel(Ptrs a, int n, int has_pv, uint64_t cap, int aux) {
  extern __shared__ uint64_t keys[];
  __shared__ SegSum wagg[6][32];
  const int* ctrl = LP(const int, L_CTRL);
  if (ctrl && !aux &&
      !full_should_run(ctrl, LP(const uint8_t, L_PROVED),
                       LP(const int, L_NEEDED)))
    return;
  const int n2 = 2 * n;
  const int T = blockDim.x, tid = threadIdx.x;
  uint8_t* arith = LP(uint8_t, L_ARITH);
  if (tid == 0) *arith = 0;
  sort_legs_cached(keys, n, LP(const int64_t, L_DR_SLOT),
                   LP(const uint8_t, L_DR_LIVE), LP(const int64_t, L_CR_SLOT),
                   LP(const uint8_t, L_CR_LIVE), cap, LP(uint64_t, L_CACHE_KEYS),
                   LP(uint64_t, L_CACHE_SLOT), LP(int, L_CACHE_OK));

  // 1. Per sorted leg (neighbouring threads on neighbouring legs): the
  //    slot outputs, the inverse permutation, the leg, and the six deltas
  //    (scratch: delta[s][j] in `scan`, the leg in `head`).
  uint64_t* delta = LP(uint64_t, L_SCAN);
  int* leg_of = LP(int, L_HEAD);
  for (int j = tid; j < n2; j += T) {
    const uint64_t key = keys[j];
    const uint64_t slot = key >> 15;
    const int L = (int)(key & 0x7FFF);
    LP(int64_t, L_S_SLOT)[j] = (int64_t)slot;
    LP(uint8_t, L_S_LIVE)[j] = slot < cap ? 1 : 0;
    LP(uint8_t, L_IS_LAST)[j] =
        (j == n2 - 1 || (keys[j + 1] >> 15) != slot) ? 1 : 0;
    LP(int64_t, L_LEG_POS)[L] = j;
    leg_of[j] = L;
    for (int s = 0; s < 6; ++s) delta[s * n2 + j] = leg_delta(a, s, L, has_pv);
  }
  __syncthreads();

  // 2. Segmented sums over slot runs in warp tiles: warp w owns a
  //    contiguous range of legs and walks it 32 legs at a time (lane l on
  //    leg base + l), so every read and write is coalesced.  Pass A finds
  //    each warp's carry-out per stream; each warp then combines the
  //    carries of the warps before it.
  const int lane = tid & 31, warp = tid >> 5, W = T >> 5;
  const int per = (((n2 + W - 1) / W) + 31) & ~31;
  const int base = warp * per;
  const int end = base + per < n2 ? base + per : n2;
  auto is_head = [&](int j) {
    return j == 0 || (keys[j] >> 15) != (keys[j - 1] >> 15);
  };
  for (int s = 0; s < 6; ++s) {
    SegSum carry = seg(0, 0);
    for (int b = base; b < end; b += 32) {
      const int j = b + lane;
      const bool in = j < end;
      warp_seg_scan(seg(in ? delta[s * n2 + j] : 0, in && is_head(j)), &carry);
    }
    if (lane == 0) wagg[s][warp] = carry;
  }
  __syncthreads();

  // 3. Per field: start + run sum of adds - run sum of subs, at the
  //    exclusive and the inclusive sums.
  bool bad_any = false;
  for (int f = 0; f < 4; ++f) {
    const int add_s = f == 0 ? 0 : f == 1 ? 2 : f == 2 ? 3 : 5;
    const int sub_s = (f == 0 ? 1 : f == 2 ? 4 : -1);
    const bool has_sub = sub_s >= 0 && has_pv;
    SegSum ca = seg(0, 0), cs = seg(0, 0);
    for (int w = 0; w < warp; ++w) {
      ca = seg_op(ca, wagg[add_s][w]);
      if (has_sub) cs = seg_op(cs, wagg[sub_s][w]);
    }
    for (int b = base; b < end; b += 32) {
      const int j = b + lane;
      const bool in = j < end;
      const int h = in && is_head(j);
      const uint64_t da = in ? delta[add_s * n2 + j] : 0;
      const u128 add_i = warp_seg_scan(seg(da, h), &ca).v;
      const u128 add_e = add_i - da;
      u128 sub_e = 0, sub_i = 0;
      if (has_sub) {
        const uint64_t ds = in ? delta[sub_s * n2 + j] : 0;
        sub_i = warp_seg_scan(seg(ds, h), &cs).v;
        sub_e = sub_i - ds;
      }
      if (!in) continue;
      const int L = leg_of[j];
      const u128 start =
          ((u128)LP(const uint64_t, L_START + 2 * f + 1)[L] << 64) |
          LP(const uint64_t, L_START + 2 * f)[L];
      const u128 added_e = start + add_e, added_i = start + add_i;
      const u128 pre = added_e - sub_e, incl = added_i - sub_i;
      const bool bad = added_e < start || added_e < sub_e || added_i < start ||
                       added_i < sub_e;
      if ((keys[j] >> 15) < cap && bad) bad_any = true;
      LP(uint64_t, L_VAL + 4 * f + 0)[j] = (uint64_t)pre;
      LP(uint64_t, L_VAL + 4 * f + 1)[j] = (uint64_t)(pre >> 64);
      LP(uint64_t, L_VAL + 4 * f + 2)[j] = (uint64_t)incl;
      LP(uint64_t, L_VAL + 4 * f + 3)[j] = (uint64_t)(incl >> 64);
    }
  }
  __syncthreads();  // the reset of *arith happened before any store below
  if (bad_any) *arith = 1;
}

extern "C" int tb_full_legs(const void* const* ptrs, int nptrs, int64_t n,
                            int has_pv, uint64_t cap, int aux, void* stream) {
  if (nptrs != L_NPTRS || n <= 0 || 2 * n > FULL_MAX_LEGS)
    return (int)cudaErrorInvalidValue;
  Ptrs a;
  int err = pack_ptrs(&a, nptrs, ptrs);
  if (err) return err;
  int p = 2;
  while (p < 2 * n) p <<= 1;
  const int bytes = 8 * p;
  static bool opted = false;
  if (!opted) {
    err = full_smem_opt_in(full_legs_kernel, 8 * FULL_MAX_LEGS);
    if (err) return err;
    opted = true;
  }
  full_legs_kernel<<<1, FULL_THREADS, bytes, (cudaStream_t)stream>>>(
      a, (int)n, has_pv, cap, aux);
  return (int)cudaGetLastError();
}

// The apply's balance scatter: where the batch commits (*gate == 0), the
// last live leg of each slot run writes its account's four inclusive
// fields (8 columns in ledger order).  Slots of run tails are unique.  In
// the slot-base form (one shard of a sharded ledger,
// tigerbeetle_tpu/parallel/sharded.py:439-450) the slots are global and a
// tail writes only when its slot lies in [slot_base, slot_base + cap), at
// slot - slot_base of the shard's columns; the single device passes base 0.
__global__ void full_legs_apply_kernel(const int* __restrict__ gate, int n2,
                                       const uint8_t* __restrict__ scat,
                                       const int64_t* __restrict__ s_slot,
                                       int64_t slot_base, uint64_t cap,
                                       Ptrs incl, Ptrs cols) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n2 || *gate != 0 || !scat[j]) return;
  const uint64_t slot = (uint64_t)(s_slot[j] - slot_base);
  if (slot >= cap) return;  // another shard's account
  for (int c = 0; c < 8; ++c) {
    static_cast<uint64_t*>(const_cast<void*>(cols.p[c]))[slot] =
        static_cast<const uint64_t*>(incl.p[c])[j];
  }
}

extern "C" int tb_full_legs_apply(const void* gate, int64_t n2,
                                  const void* scat, const void* s_slot,
                                  int64_t slot_base, int64_t cap,
                                  const void* const* incl,
                                  const void* const* cols, void* stream) {
  Ptrs v, c;
  int err = pack_ptrs(&v, 8, incl);
  if (!err) err = pack_ptrs(&c, 8, cols);
  if (err) return err;
  if (n2 <= 0) return 0;
  const int threads = 256;
  full_legs_apply_kernel<<<(unsigned)((n2 + threads - 1) / threads), threads, 0,
                           (cudaStream_t)stream>>>(
      (const int*)gate, (int)n2, (const uint8_t*)scat, (const int64_t*)s_slot,
      slot_base, (uint64_t)cap, v, c);
  return (int)cudaGetLastError();
}
