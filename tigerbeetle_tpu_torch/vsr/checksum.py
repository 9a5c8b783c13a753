"""vsr.checksum: AEGIS-128L in MAC mode, the universal 128-bit checksum.

Behavior contract (reference: src/vsr/checksum.zig — behavior only, clean
implementation): AEGIS-128L (draft-irtf-cfrg-aegis-aead) specialized to a
checksum — zero key, zero nonce, empty secret message, the input bytes as
associated data; the checksum is the 128-bit tag read as a little-endian
integer.  Used for: network message headers+bodies, WAL entries, superblock
copies, grid blocks, and prepare hash-chaining.

Primary implementation: native C++ w/ AES-NI (tigerbeetle_tpu/native/aegis.cpp)
via ctypes.  A pure-Python implementation below serves as fallback and as a
differential check in tests.  Test vectors from the reference's published
smoke-test vectors (checksum.zig "checksum test vectors").
"""

from __future__ import annotations

import struct
from typing import List, Optional

from .. import native

_C0 = bytes(
    [0x00, 0x01, 0x01, 0x02, 0x03, 0x05, 0x08, 0x0D,
     0x15, 0x22, 0x37, 0x59, 0x90, 0xE9, 0x79, 0x62]
)
_C1 = bytes(
    [0xDB, 0x3D, 0x18, 0x55, 0x6D, 0xC2, 0x2F, 0xF1,
     0x20, 0x11, 0x31, 0x42, 0x73, 0xB5, 0x28, 0xDD]
)

# --- AES round tables (generated, not copied) -------------------------------


def _make_tables():
    # AES S-box via GF(2^8) inverse + affine transform.
    sbox = [0] * 256
    p = q = 1
    sbox[0] = 0x63
    while True:
        p = p ^ ((p << 1) & 0xFF) ^ (0x1B if p & 0x80 else 0)
        q ^= (q << 1) & 0xFF
        q ^= (q << 2) & 0xFF
        q ^= (q << 4) & 0xFF
        if q & 0x80:
            q ^= 0x09
        rot = lambda x, r: ((x << r) | (x >> (8 - r))) & 0xFF
        sbox[p] = q ^ rot(q, 1) ^ rot(q, 2) ^ rot(q, 3) ^ rot(q, 4) ^ 0x63
        if p == 1:
            break
    t0 = [0] * 256
    for i in range(256):
        s = sbox[i]
        s2 = ((s << 1) ^ (0x1B if s & 0x80 else 0)) & 0xFF
        s3 = s2 ^ s
        t0[i] = s2 | (s << 8) | (s << 16) | (s3 << 24)
    t1 = [((x << 8) | (x >> 24)) & 0xFFFFFFFF for x in t0]
    t2 = [((x << 8) | (x >> 24)) & 0xFFFFFFFF for x in t1]
    t3 = [((x << 8) | (x >> 24)) & 0xFFFFFFFF for x in t2]
    return t0, t1, t2, t3


_T0, _T1, _T2, _T3 = _make_tables()


def _aesround(a: List[int], rk: List[int]) -> List[int]:
    """One AES round (SubBytes+ShiftRows+MixColumns+AddRoundKey) on 4 LE words."""
    a0, a1, a2, a3 = a
    return [
        _T0[a0 & 0xFF] ^ _T1[(a1 >> 8) & 0xFF] ^ _T2[(a2 >> 16) & 0xFF]
        ^ _T3[(a3 >> 24) & 0xFF] ^ rk[0],
        _T0[a1 & 0xFF] ^ _T1[(a2 >> 8) & 0xFF] ^ _T2[(a3 >> 16) & 0xFF]
        ^ _T3[(a0 >> 24) & 0xFF] ^ rk[1],
        _T0[a2 & 0xFF] ^ _T1[(a3 >> 8) & 0xFF] ^ _T2[(a0 >> 16) & 0xFF]
        ^ _T3[(a1 >> 24) & 0xFF] ^ rk[2],
        _T0[a3 & 0xFF] ^ _T1[(a0 >> 8) & 0xFF] ^ _T2[(a1 >> 16) & 0xFF]
        ^ _T3[(a2 >> 24) & 0xFF] ^ rk[3],
    ]


def _words(b: bytes) -> List[int]:
    return list(struct.unpack("<4I", b))


def _xor(a: List[int], b: List[int]) -> List[int]:
    return [x ^ y for x, y in zip(a, b)]


class _State:
    __slots__ = ("s",)

    def __init__(self) -> None:
        zero = [0, 0, 0, 0]
        c0, c1 = _words(_C0), _words(_C1)
        # init with key=0, nonce=0 (S0=K^N, S5=K^C0, S6=K^C1, S7=K^C0).
        self.s = [zero, c1, c0, list(c1), list(zero), list(c0), list(c1), list(c0)]
        for _ in range(10):
            self.update(zero, zero)

    def update(self, m0: List[int], m1: List[int]) -> None:
        # S'i = AESRound(S[i-1], S[i]); messages XOR into the key operand:
        # S'0 = AESRound(S7, S0 ^ M0), S'4 = AESRound(S3, S4 ^ M1).
        s = self.s
        t7 = s[7]
        s[7] = _aesround(s[6], s[7])
        s[6] = _aesround(s[5], s[6])
        s[5] = _aesround(s[4], s[5])
        s[4] = _aesround(s[3], _xor(s[4], m1))
        s[3] = _aesround(s[2], s[3])
        s[2] = _aesround(s[1], s[2])
        s[1] = _aesround(s[0], s[1])
        s[0] = _aesround(t7, _xor(s[0], m0))


def checksum_py(data: bytes) -> int:
    """Pure-Python AEGIS-128L MAC (fallback + differential check)."""
    st = _State()
    n = len(data)
    full = n // 32
    for i in range(full):
        st.update(_words(data[32 * i : 32 * i + 16]),
                  _words(data[32 * i + 16 : 32 * i + 32]))
    rem = n % 32
    if rem:
        pad = data[32 * full :] + b"\x00" * (32 - rem)
        st.update(_words(pad[:16]), _words(pad[16:]))
    # Finalize: tmp = S2 ^ (LE64(ad_len_bits) || LE64(0)); 7 updates; tag=S0^..^S6.
    tmp = _xor(st.s[2], _words(struct.pack("<QQ", 8 * n, 0)))
    for _ in range(7):
        st.update(tmp, tmp)
    tag = [0, 0, 0, 0]
    for i in range(7):
        tag = _xor(tag, st.s[i])
    return int.from_bytes(struct.pack("<4I", *tag), "little")


def checksum(data) -> int:
    """128-bit checksum of ``data`` (bytes-like), as an int."""
    lib = native.load()
    data = bytes(data)
    if lib is None:
        return checksum_py(data)
    import ctypes

    out = ctypes.create_string_buffer(16)
    lib.tb_checksum(data, len(data), out)
    return int.from_bytes(out.raw, "little")


CHECKSUM_EMPTY = None  # filled lazily below (avoids native build at import)


def checksum_empty() -> int:
    global CHECKSUM_EMPTY
    if CHECKSUM_EMPTY is None:
        CHECKSUM_EMPTY = checksum(b"")
    return CHECKSUM_EMPTY
