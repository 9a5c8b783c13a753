// The staging primitives of K6's sequencer (sequential.cu), and the
// cp.async copies of K10's and K12's chunk merge (full_common.cuh):
// mbarriers in shared memory, cp.async copies from device memory into
// shared memory, and L2 loads of words another thread of the block wrote.  Kept apart from the
// kernel so that each is one short piece of PTX that reads on its own.
#pragma once

#include "common.cuh"

// The block's dynamic shared memory.
static __device__ __forceinline__ unsigned char* seq_dyn_smem() {
  extern __shared__ __align__(16) unsigned char seq_smem[];
  return seq_smem;
}

static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

static __device__ __forceinline__ void mbar_init(uint64_t* bar,
                                                 uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Arrive (release at CTA scope: this thread's earlier writes, shared and
// global, are visible to a thread whose wait sees the phase complete).
static __device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(smem_addr(bar))
      : "memory");
}

static __device__ __forceinline__ bool mbar_test(uint64_t* bar,
                                                 uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait (acquire at CTA scope) for the phase of parity `parity` to
// complete, sleeping `sleep_ns` between tries (a waiter that is not on the
// critical path leaves the issue slots to the warps that are).  A wait of
// more than 2^35 SM cycles (over 17 s; a legitimate one lasts microseconds)
// is a protocol fault: trap, so that the launch fails instead of hanging
// the card.
static __device__ __forceinline__ void mbar_wait(uint64_t* bar,
                                                 uint32_t parity,
                                                 unsigned sleep_ns = 0) {
  if (mbar_test(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_test(bar, parity)) {
    if (sleep_ns) __nanosleep(sleep_ns);
    if (clock64() - start > (1ll << 35)) __trap();
  }
}

// 16 bytes from device memory into shared memory, asynchronously.
static __device__ __forceinline__ void cp_async16(void* smem_dst,
                                                  const void* gmem_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(smem_dst)),
               "l"(gmem_src)
               : "memory");
}

// Wait for this thread's cp.async copies.
static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Loads from L2 (not L1) of words the block's sequencer writes.
static __device__ __forceinline__ uint64_t ld_cg_u64(const uint64_t* p) {
  return __ldcg(reinterpret_cast<const unsigned long long*>(p));
}
static __device__ __forceinline__ uint64_t ld_cg_u8(const uint8_t* p) {
  uint16_t v;
  asm volatile("ld.global.cg.u8 %0, [%1];" : "=h"(v) : "l"(p));
  return v;
}
