"""u128 arithmetic on (lo, hi) u64 lane pairs, as int64 tensors holding the bits.

Port of ``tigerbeetle_tpu/u128.py``.  PyTorch on the CPU has no uint64 add,
shift, compare, ``scatter_add_`` or ``sort``, so every u64 here is an int64
tensor carrying the same 64 bits:

- add, sub and mul wrap modulo 2**64 exactly as u64 does;
- a logical right shift is ``(x >> k) & ((1 << (64 - k)) - 1)`` (``srl``);
- unsigned order is the signed order of ``x ^ INT64_MIN`` (``ult`` and kin).

All functions are elementwise and wrap modulo 2**128; overflow is reported
explicitly where the reference checks it.  The CUDA kernels (``csrc/``) use
native ``uint64_t`` and the same formulas.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

INT64_MIN = -(1 << 63)
U64_MASK = (1 << 64) - 1


def i64(value: int) -> int:
    """The int64 holding the bits of the u64 ``value`` (a Python int)."""
    value &= U64_MASK
    return value - (1 << 64) if value >> 63 else value


def u64(value: int) -> int:
    """The u64 (a Python int) whose bits the int64 ``value`` holds."""
    return int(value) & U64_MASK


class U128(NamedTuple):
    """A (possibly batched) 128-bit unsigned integer as two u64 lanes."""

    lo: torch.Tensor
    hi: torch.Tensor


def lit(value: int, device=None) -> U128:
    """A scalar u128 literal."""
    return U128(
        torch.tensor(i64(value), dtype=torch.int64, device=device),
        torch.tensor(i64(value >> 64), dtype=torch.int64, device=device),
    )


def zeros_like(x: U128) -> U128:
    return U128(torch.zeros_like(x.lo), torch.zeros_like(x.hi))


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical (u64) right shift of an int64 tensor by a constant ``k``."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """u64 ``a < b`` on int64 bit patterns."""
    return (a ^ INT64_MIN) < (b ^ INT64_MIN)


def ugt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ult(b, a)


def uge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ~ult(a, b)


def add(a: U128, b: U128) -> Tuple[U128, torch.Tensor]:
    """a + b mod 2**128, plus an overflow flag (mirrors sum_overflows u128)."""
    lo = a.lo + b.lo
    carry = ult(lo, a.lo).to(torch.int64)
    hi_nc = a.hi + b.hi
    c1 = ult(hi_nc, a.hi)
    hi = hi_nc + carry
    c2 = ult(hi, hi_nc)
    return U128(lo, hi), c1 | c2


def add_wrap(a: U128, b: U128) -> U128:
    return add(a, b)[0]


def sub(a: U128, b: U128) -> Tuple[U128, torch.Tensor]:
    """a - b mod 2**128, plus an underflow (borrow) flag."""
    lo = a.lo - b.lo
    borrow = ult(a.lo, b.lo).to(torch.int64)
    hi_nb = a.hi - b.hi
    b1 = ult(a.hi, b.hi)
    hi = hi_nb - borrow
    b2 = ult(hi_nb, borrow)
    return U128(lo, hi), b1 | b2


def sub_wrap(a: U128, b: U128) -> U128:
    return sub(a, b)[0]


def sub_saturate(a: U128, b: U128) -> U128:
    """a -| b (saturating subtraction)."""
    diff, under = sub(a, b)
    z = torch.zeros_like(diff.lo)
    return U128(torch.where(under, z, diff.lo), torch.where(under, z, diff.hi))


def eq(a: U128, b: U128) -> torch.Tensor:
    return (a.lo == b.lo) & (a.hi == b.hi)


def ne(a: U128, b: U128) -> torch.Tensor:
    return ~eq(a, b)


def gt(a: U128, b: U128) -> torch.Tensor:
    return ugt(a.hi, b.hi) | ((a.hi == b.hi) & ugt(a.lo, b.lo))


def ge(a: U128, b: U128) -> torch.Tensor:
    return ugt(a.hi, b.hi) | ((a.hi == b.hi) & uge(a.lo, b.lo))


def lt(a: U128, b: U128) -> torch.Tensor:
    return gt(b, a)


def le(a: U128, b: U128) -> torch.Tensor:
    return ge(b, a)


def min_(a: U128, b: U128) -> U128:
    take_a = le(a, b)
    return U128(torch.where(take_a, a.lo, b.lo), torch.where(take_a, a.hi, b.hi))


def is_zero(x: U128) -> torch.Tensor:
    return (x.lo == 0) & (x.hi == 0)


def is_max(x: U128) -> torch.Tensor:
    return (x.lo == -1) & (x.hi == -1)


def select(pred: torch.Tensor, a: U128, b: U128) -> U128:
    return U128(torch.where(pred, a.lo, b.lo), torch.where(pred, a.hi, b.hi))


_M0 = i64(0x9E3779B97F4A7C15)
_M1 = i64(0xBF58476D1CE4E5B9)
_M2 = i64(0x94D049BB133111EB)


def mix64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Mix a u128 key's lanes into one well-distributed u64 (for hashing):
    the splitmix64 finalizer over a xor-fold of the lanes, bit for bit the
    JAX package's ``u128.mix64``."""
    x = lo ^ (hi * _M0)
    x = (x ^ srl(x, 30)) * _M1
    x = (x ^ srl(x, 27)) * _M2
    return x ^ srl(x, 31)
