// Phase marks for tools/phase_clock.py.  Built with -DTB_PHASE_CLOCK,
// thread 0 of each of the first PHASE_CLOCK_BLOCKS blocks stores
// %globaltimer at each PHASE_MARK(k) into a per-source device array, which
// PHASE_CLOCK_ENTRIES(name) reads and clears from the host through
// `name_read` / `name_clear`; otherwise the marks compile to nothing.
#pragma once

#include <cuda_runtime.h>

#define PHASE_CLOCK_BLOCKS 64
#define PHASE_CLOCK_MARKS 16

#ifdef TB_PHASE_CLOCK
static __device__ unsigned long long
    tb_phase_clock[PHASE_CLOCK_BLOCKS][PHASE_CLOCK_MARKS];
#define PHASE_MARK(k)                                                   \
  do {                                                                  \
    if (threadIdx.x == 0 && blockIdx.x < PHASE_CLOCK_BLOCKS) {          \
      unsigned long long t_;                                            \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));            \
      tb_phase_clock[blockIdx.x][k] = t_;                               \
    }                                                                   \
  } while (0)
#define PHASE_CLOCK_ENTRIES(name)                                       \
  extern "C" int name##_read(void* host) {                              \
    return (int)cudaMemcpyFromSymbol(host, tb_phase_clock,              \
                                     sizeof(tb_phase_clock));           \
  }                                                                     \
  extern "C" int name##_clear() {                                       \
    static unsigned long long zero[PHASE_CLOCK_BLOCKS][PHASE_CLOCK_MARKS]; \
    return (int)cudaMemcpyToSymbol(tb_phase_clock, zero, sizeof(zero)); \
  }
// Read and clear entries for a kernel's own clock array (a lane clock).
#define PHASE_CLOCK_ARRAY_ENTRIES(name, array)                          \
  extern "C" int name##_read(void* host) {                              \
    return (int)cudaMemcpyFromSymbol(host, array, sizeof(array));       \
  }                                                                     \
  extern "C" int name##_clear() {                                       \
    static unsigned long long zero[sizeof(array) / 8];                  \
    return (int)cudaMemcpyToSymbol(array, zero, sizeof(array));         \
  }
#else
#define PHASE_MARK(k) \
  do {                \
  } while (0)
#define PHASE_CLOCK_ENTRIES(name)
#endif
