"""EWAH (Enhanced Word-Aligned Hybrid) bitmap compression.

The reference compresses the grid FreeSet into every checkpoint with EWAH
(src/ewah.zig, 437 LoC; used by src/vsr/free_set.zig).  Here the analogous
dense bitmaps are the device tables' occupancy/tombstone lanes, which are
highly runnable (mostly-empty or mostly-full tables), plus any future
block-allocation maps.

Format (matching ewah.zig's layout choices):
- The bitmap is a sequence of u64 words (little-endian on disk).
- A *marker* word encodes: bit 0 = uniform-run bit value; bits 1..32 =
  run length in words (31 bits); bits 33..63 = count of literal words that
  follow (31 bits).
- Decoding emits ``run_length`` copies of the uniform word (all-zeros or
  all-ones) then the literal words verbatim.

Worst case (no runs) costs one marker per 2^31-1 literals — asymptotically
free; best case (uniform bitmap) is ~64 bits per 2^31 words.
"""

from __future__ import annotations

import numpy as np

_RUN_MAX = (1 << 31) - 1
_LIT_MAX = (1 << 31) - 1
_ALL_ONES = np.uint64(0xFFFF_FFFF_FFFF_FFFF)


def _marker(run_bit: int, run_len: int, lit_count: int) -> int:
    assert 0 <= run_len <= _RUN_MAX and 0 <= lit_count <= _LIT_MAX
    return run_bit | (run_len << 1) | (lit_count << 32)


def _unmarker(word: int):
    return word & 1, (word >> 1) & _RUN_MAX, (word >> 32) & _LIT_MAX


def encode(words: np.ndarray) -> np.ndarray:
    """Compress a u64 word array; returns a u64 array (markers+literals)."""
    words = np.ascontiguousarray(words, dtype=np.uint64)
    n = len(words)
    out: list[int] = []
    uniform = (words == 0) | (words == _ALL_ONES)
    i = 0
    while i < n:
        # Greedy run: consecutive uniform words with the same value.
        run_len = 0
        run_bit = 0
        if uniform[i]:
            run_bit = int(words[i] != 0)
            j = i
            while (
                j < n and uniform[j] and int(words[j] != 0) == run_bit
                and run_len < _RUN_MAX
            ):
                run_len += 1
                j += 1
            i = j
        # Literals until the next run of >= 2 uniform words (a single
        # uniform word is cheaper as a literal than as a fresh marker).
        lit_start = i
        while i < n:
            if uniform[i] and i + 1 < n and uniform[i + 1] and (
                words[i] == words[i + 1]
            ):
                break
            if i - lit_start == _LIT_MAX:
                break
            i += 1
        lits = words[lit_start:i]
        out.append(_marker(run_bit, run_len, len(lits)))
        out.extend(int(w) for w in lits)
    return np.array(out, dtype=np.uint64)


def decode(encoded: np.ndarray, expect_words: int) -> np.ndarray:
    """Decompress to exactly ``expect_words`` u64 words; raises ValueError
    on malformed input (truncated literals or wrong total)."""
    encoded = np.ascontiguousarray(encoded, dtype=np.uint64)
    out = np.zeros(expect_words, dtype=np.uint64)
    pos = 0
    i = 0
    n = len(encoded)
    while i < n:
        run_bit, run_len, lit_count = _unmarker(int(encoded[i]))
        i += 1
        if pos + run_len > expect_words:
            raise ValueError("EWAH run overflows bitmap")
        if run_bit:
            out[pos : pos + run_len] = _ALL_ONES
        pos += run_len
        if i + lit_count > n:
            raise ValueError("EWAH literals truncated")
        if pos + lit_count > expect_words:
            raise ValueError("EWAH literals overflow bitmap")
        out[pos : pos + lit_count] = encoded[i : i + lit_count]
        i += lit_count
        pos += lit_count
    if pos != expect_words:
        raise ValueError(f"EWAH decoded {pos} words, expected {expect_words}")
    return out


def encode_bits(bits: np.ndarray) -> tuple[np.ndarray, int]:
    """Compress a boolean array (bit i of word w = bits[64w+i], LSB first);
    returns (encoded u64 words, bit count)."""
    bits = np.ascontiguousarray(bits, dtype=bool)
    n = len(bits)
    packed = np.packbits(bits, bitorder="little")
    pad = (-len(packed)) % 8
    if pad:
        packed = np.concatenate([packed, np.zeros(pad, dtype=np.uint8)])
    words = packed.view("<u8").astype(np.uint64)
    return encode(words), n


def decode_bits(encoded: np.ndarray, bit_count: int) -> np.ndarray:
    """Inverse of encode_bits."""
    n_words = (bit_count + 63) // 64
    words = decode(encoded, n_words)
    raw = words.astype("<u8").view(np.uint8)
    bits = np.unpackbits(raw, bitorder="little")
    return bits[:bit_count].astype(bool)
