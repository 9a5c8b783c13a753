"""JAX's threefry-2x32 random numbers, bit for bit, in plain PyTorch.

The batched VOPR (``sim/vopr_tpu.py``) draws every fault from
``jax.random``; reproducing those draws exactly lets a seed and a cluster
index name the same schedule in both packages, so a violation the card finds
replays under JAX.  This module follows JAX 0.9.0's sources:

- ``jax/_src/prng.py:802`` ``threefry_seed``: ``PRNGKey(seed)`` is
  ``[seed >> 32, seed & 0xFFFFFFFF]``;
- ``:883`` ``_threefry2x32_lowering``: the 20-round hash with five key
  injections;
- ``:989`` ``iota_2x32_shape`` and ``:1156`` ``_threefry_split_foldlike``:
  key ``i`` of a split is ``threefry(key, (i >> 32, i & 0xFFFFFFFF))``, so
  ``split(k, 5) == split(k, 9)[:5]``;
- ``:1163`` ``_threefry_fold_in``: ``threefry(key, (0, data))``;
- ``:1184`` ``_threefry_random_bits_partitionable``: element ``i`` of a
  draw hashes the counter ``i`` as a split does; a 32-bit draw is
  ``bits1 ^ bits2``, a 64-bit draw ``bits1 << 32 | bits2``;
- ``jax/_src/random.py:435`` ``_uniform``, ``:581`` ``_randint`` and
  ``:1075`` ``_bernoulli``.

It assumes the two settings the JAX package runs with (checked by
``tests/test_torch_vopr.py``): ``jax_threefry_partitionable = True`` (JAX's
default since 0.5) and ``jax_enable_x64 = True`` (``tigerbeetle_tpu/__init__``
turns it on).  Under x64 ``bernoulli(key, p)`` with a Python-float ``p``
compares a **float64** uniform, made from 64 random bits, and ``randint``
without a dtype draws **int64**: two 64-bit draws a value, combined by the
multiply-and-mod rule of ``_randint``.

Keys are tensors of shape ``(..., 2)``, int32 or int64; each word is read
modulo 2^32.  Results carry u32 words as int64 values in ``[0, 2^32)``.
``csrc/threefry.cuh`` is the same generator as device functions.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple, Union

import torch

from .. import device as device_mod

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
Shape = Union[int, Sequence[int]]


def _words(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key has shape (..., 2), got {tuple(key.shape)}")
    k = key.to(torch.int64) & M32
    return k[..., 0], k[..., 1]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 hash of the counter words (x1, x2) under the key
    words (k1, k2); int64 tensors of u32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & M32
    b = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & M32
            b = ((b << r) & M32) | (b >> (32 - r))
            b = a ^ b
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & M32
    return a, b


def _counter_bits(key: torch.Tensor, shape: Tuple[int, ...], start: int = 0):
    """threefry of the counters start .. start + prod(shape) - 1 (as the
    split and random_bits iotas lay them), shape (*key.shape[:-1], *shape)."""
    k1, k2 = _words(key)
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(start, start + n, dtype=torch.int64, device=key.device)
    lead = k1.dim()
    view = (1,) * lead + tuple(shape)
    x1 = (idx >> 32).reshape(view)
    x2 = (idx & M32).reshape(view)
    exp = (...,) + (None,) * len(shape)
    return threefry2x32(k1[exp], k2[exp], x1, x2)


def seed_words(seed: int) -> Tuple[int, int]:
    """The two u32 words of ``PRNGKey(seed)``, as host ints."""
    s = int(seed) & ((1 << 64) - 1)
    return s >> 32, s & M32


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: an int64 tensor of shape (2,), on the
    card unless the caller names another device."""
    return torch.tensor(seed_words(seed), dtype=torch.int64,
                        device=device_mod.resolve(device))


def split(key: torch.Tensor, num: int = 2, start: int = 0) -> torch.Tensor:
    """``jax.random.split(key, start + num)[..., start:, :]``: shape
    (*key.shape[:-1], num, 2).  A key does not depend on how many were
    split, so ``start`` names a range of a larger split."""
    b1, b2 = _counter_bits(key, (num,), start)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a u32 ``data``."""
    if not 0 <= int(data) <= M32:
        raise ValueError("fold_in data is a u32")
    k1, k2 = _words(key)
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, zero, zero + int(data))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, bit_width: int, shape: Shape = ()):
    """``jax.random.bits`` at 32 bits (int64 values in [0, 2^32)) or as the
    (high, low) u32 words of a 64-bit draw."""
    b1, b2 = _counter_bits(key, _shape(shape))
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        return b1, b2
    raise ValueError("bit_width is 32 or 64")


@functools.lru_cache(maxsize=256)
def const(values: Tuple, dtype: torch.dtype, device: torch.device):
    """A constant tensor, made once per device (no host-to-device copy on
    a loop's every step, so the loop's launches can queue on the card)."""
    return torch.tensor(values, dtype=dtype, device=device)


def hash_keys(keys: torch.Tensor, counters: Sequence[int]) -> torch.Tensor:
    """Each of the K keys of ``keys`` (..., K, 2) hashed at its own counter:
    ``split(k, n)[c]`` (and ``fold_in(k, c)``) for every (k, c) at once, and
    the (bits1, bits2) words of element c of a draw from k.  (..., K, 2)."""
    k1, k2 = _words(keys)
    c = const(tuple(counters), torch.int64, keys.device)
    b1, b2 = threefry2x32(k1, k2, c >> 32, c & M32)
    return torch.stack([b1, b2], dim=-1)


def uniform_of_words(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The float64 uniform of a 64-bit draw's (high, low) u32 words: the
    top 52 bits as the mantissa, exactly ``m * 2**-52``."""
    return ((hi << 20) | (lo >> 12)).to(torch.float64) * (2.0 ** -52)


def uniform(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float64)`` on [0, 1)."""
    return uniform_of_words(*random_bits(key, 64, shape))


def bernoulli(key: torch.Tensor, p: float = 0.5, shape: Shape = ()):
    """``jax.random.bernoulli(key, p, shape)`` with a Python-float ``p``
    under x64: ``uniform(key, shape, float64) < p``."""
    return uniform(key, shape) < float(p)


def bernoulli_threshold(p: float) -> int:
    """The integer form of ``bernoulli``'s compare, for the kernels: with m
    the top 52 bits of a 64-bit draw, ``m * 2**-52 < p`` exactly when ``m <
    bernoulli_threshold(p)``, which is ``ceil(p * 2**52)`` clamped to [0,
    2**52] (``p * 2**52`` is exact in float64; a NaN ``p`` never hits)."""
    p = float(p)
    if not p > 0.0:
        return 0
    if p >= 1.0:
        return 1 << 52
    return math.ceil(p * 2.0 ** 52)


def span_consts(span: int) -> Tuple[int, int, int, int]:
    """The launch constants of a randint span d in [1, 2^16) for the
    kernels' division-free remainder (``csrc/threefry.cuh`` TfSpan):
    (magic, d, r32, mult) with magic = ceil(2^64 / d) mod 2^64, r32 = 2^32
    mod d and mult = r32^2 mod d = 2^64 mod d."""
    d = int(span)
    if not 1 <= d < 1 << 16:
        raise ValueError("a kernel span is in [1, 2^16)")
    r32 = (1 << 32) % d
    return (((1 << 64) - 1) // d + 1) % (1 << 64), d, r32, r32 * r32 % d


def _mod_u64(hi: torch.Tensor, lo: torch.Tensor, span: int) -> torch.Tensor:
    """(hi * 2^32 + lo) mod span, exact for span < 2^31."""
    return ((hi % span) * ((1 << 32) % span) + lo % span) % span


def randint_of_words(high, low, minval: int, maxval: int) -> torch.Tensor:
    """``_randint``'s combination of the two 64-bit draws ``high`` and
    ``low`` (each a (high, low) pair of u32 words) into ``[minval,
    maxval)``: ``(hi % span * (2^64 % span) + lo % span) % span``.  Exact
    for spans below 2^31; raises on a larger one."""
    minval, maxval = int(minval), int(maxval)
    span = 1 if maxval <= minval else maxval - minval
    if span >= 1 << 31:
        raise ValueError("randint: spans of 2^31 or more are not supported")
    mult = ((1 << 32) % span) ** 2 % span
    return (_mod_u64(*high, span) * mult + _mod_u64(*low, span)) % span + minval


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int):
    """``jax.random.randint(key, shape, minval, maxval)`` under x64 (int64):
    two 64-bit draws, from ``split(key)[0]`` and ``split(key)[1]``."""
    shape = _shape(shape)
    keys = split(key, 2)
    return randint_of_words(random_bits(keys[..., 0, :], 64, shape),
                            random_bits(keys[..., 1, :], 64, shape),
                            minval, maxval)
