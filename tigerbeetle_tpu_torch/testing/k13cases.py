"""Runs that set the traps of K13's cluster form (``csrc/index_sort.cu``:
a run of 1,025 to 8,192 entries cut into chunks of 512, each sorted, then
merged by rank across the chunks; shorter runs one chunk of 1,024), in
numpy: one entry, a chunk of 1,024 less one, that chunk, a run one longer,
a batch of 8,190 and of 8,192 lanes; random keys, equal keys across the
chunks' boundaries (ties keep their input order), and all sentinels; and
runs padded past their entries.  ``entries(n, mode)`` returns (five u64 columns, the use
mask).  The CPU tests hold the split form's plain version against the
JAX package on them, the card tests the kernel against its plain
version."""

from __future__ import annotations

import numpy as np

SIZES = (1, 1023, 1024, 1025, 8190, 8192)
MODES = ("random", "ties", "all_sentinel")
PADDED = ((1000, 1024), (5000, 8192), (8190, 8192))  # (entries, run)
U64M = np.uint64((1 << 64) - 1)


def entries(n: int, mode: str, seed: int = 0):
    rng = np.random.default_rng([n, MODES.index(mode), seed])
    cols = np.zeros((5, n), np.uint64)
    if mode == "ties":
        cols[0] = rng.integers(1, 4, n)
        cols[1] = rng.integers(0, 2, n)
        cols[2] = rng.integers(1, 5, n)
    else:
        cols[0] = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        cols[1] = rng.integers(0, 3, n)
        cols[2] = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    cols[3] = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    cols[4] = rng.integers(0, 4, n)
    cols[:, rng.random(n) < 0.03] = U64M  # real entries with the sentinel key
    use = rng.random(n) < (0.0 if mode == "all_sentinel" else 0.9)
    return cols, use
