// K20 bench_gen: the flagship benchmark's batch, made on the card from the
// batch index alone.
//
// Replaces bench.py:2129 `mix_workload`, :2140 `gen_batch` and :2169
// `gen_two_phase` (traced inside bench.py's timed fori_loop), and
// tigerbeetle_tpu/utils/benchgen.py:22 `gen_plain` and :54 `gen_twop`, with
// u128.py:118 `mix64`.  Per lane, with gid = b * count + lane (the post half
// of a two-phase batch reuses its pending's gid):
//   h1 = mix64(gid, 0x1234), h2 = mix64(gid, 0x9876);
//   mode 0/1: debit = h1 mod n, credit = (debit + 1 + h2 mod (n-1)) mod n,
//             amount = 1 + ((h1 >> 32) & 0xFFFF);
//   mode 2:   debit = h1 mod n, credit = (debit + 3) mod n,
//             amount = 1 + (h1 & 0xFF).
// Mode 0 (plain): lanes below `count` are creates, ids first_tid + gid.
// Modes 1 and 2 (two-phase): lanes [0, half) are pending creates, lanes
// [half, 2*half) post the pending of lane (lane - half); ids first_tid +
// b * count + lane.  Creates carry ledger 1 and code 10 and the accounts
// 1 + index; every other column, and every column of an inactive lane, is
// written 0, so the whole transfer SoA is overwritten in place.  The modulo
// is native unsigned 64-bit, exact for every hash.
//
// What bounds it on the H100: the launch.  It writes 132 B per lane
// (fourteen u64 and five u32 columns, coalesced) and reads nothing; at
// 8,192 lanes that is 1 MB, a third of a microsecond at HBM rate, against
// a launch of a few microseconds.
#include "common.cuh"

#define GEN_U64 14  // id lo/hi, debit lo/hi, credit lo/hi, amount lo/hi,
                    // pending_id lo/hi, user_data_128 lo/hi, user_data_64,
                    // timestamp (utils/benchgen.py GEN_COLS_U64)
#define GEN_U32 5   // user_data_32, timeout, ledger, code, flags

struct GenCols {
  uint64_t* c64[GEN_U64];
  uint32_t* c32[GEN_U32];
};

__global__ void bench_gen_kernel(GenCols c, int mode, ull b,
                                 const ull* __restrict__ b_word, int64_t lanes,
                                 ull count, ull n, ull first_tid) {
  const int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  if (b_word) b = *b_word;  // the device-word entry (a captured graph)
  const ull l = (ull)lane;
  const ull base = b * count;
  const ull half = count / 2;
  bool active, is_post = false;
  ull gid;
  if (mode == 0) {
    gid = base + l;
    active = l < count;
  } else {
    is_post = l >= half;
    gid = base + (is_post ? l - half : l);
    active = l < 2 * half;
  }
  const ull h1 = mix64(gid, 0x1234ull);
  const ull dr = h1 % n;
  ull cr, amount;
  if (mode == 2) {
    cr = (dr + 3) % n;
    amount = 1 + (h1 & 0xFFull);
  } else {
    const ull h2 = mix64(gid, 0x9876ull);
    cr = (dr + 1 + h2 % (n - 1)) % n;
    amount = 1 + ((h1 >> 32) & 0xFFFFull);
  }
  const bool create = active && !is_post;
  const bool post = active && is_post;
  const ull v64[GEN_U64] = {
      active ? first_tid + base + l : 0,     // id_lo
      0,                                     // id_hi
      create ? dr + 1 : 0,                   // debit_account_id_lo
      0,                                     // debit_account_id_hi
      create ? cr + 1 : 0,                   // credit_account_id_lo
      0,                                     // credit_account_id_hi
      create ? amount : 0,                   // amount_lo
      0,                                     // amount_hi
      post ? first_tid + base + (l - half) : 0,  // pending_id_lo
      0, 0, 0, 0, 0,  // pending_id_hi, user_data_128 lo/hi, user_data_64,
                      // timestamp
  };
  uint32_t flags = 0;
  if (mode != 0 && active) flags = is_post ? 4u : 2u;  // TF_POST : TF_PENDING
  const uint32_t v32[GEN_U32] = {0, 0, create ? 1u : 0u, create ? 10u : 0u,
                                 flags};
#pragma unroll
  for (int k = 0; k < GEN_U64; ++k) c.c64[k][lane] = v64[k];
#pragma unroll
  for (int k = 0; k < GEN_U32; ++k) c.c32[k][lane] = v32[k];
}

// `cols`: the fourteen u64 columns, then the five u32 columns, each of
// `lanes` elements.  Requires 2 <= n and count <= lanes (the wrapper checks).
// When `b_word` is not null the batch index is read from that u64 device
// word when the kernel runs (the bench twin's captured graph), not from `b`.
extern "C" int tb_bench_gen(void* const* cols, int64_t lanes, int mode,
                            uint64_t b, const void* b_word, uint64_t count,
                            uint64_t n, uint64_t first_tid, void* stream) {
  if (mode < 0 || mode > 2 || n < 2) return (int)cudaErrorInvalidValue;
  GenCols c;
  for (int k = 0; k < GEN_U64; ++k) c.c64[k] = (uint64_t*)cols[k];
  for (int k = 0; k < GEN_U32; ++k) c.c32[k] = (uint32_t*)cols[GEN_U64 + k];
  if (lanes == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (lanes + threads - 1) / threads;
  bench_gen_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      c, mode, (ull)b, (const ull*)b_word, lanes, (ull)count, (ull)n,
      (ull)first_tid);
  return (int)cudaGetLastError();
}
