// The rollback tombstone, shared by kernel K8 (tombstone.cu) and the undo-log
// rollbacks of K6 and K7 (sequential.cu): clear the key at `slot` and mark
// the slot a tombstone.  Probes walk past a tombstone and inserts never
// reuse it.  The caller adjusts the table's count.
#pragma once

#include "common.cuh"

static __device__ __forceinline__ void tombstone_slot(uint64_t* key_lo,
                                                      uint64_t* key_hi,
                                                      uint8_t* tomb,
                                                      uint64_t slot) {
  key_lo[slot] = 0;
  key_hi[slot] = 0;
  tomb[slot] = 1;
}
