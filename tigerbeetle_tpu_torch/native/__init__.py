"""The port's native (C++) helper: the AEGIS-128L checksum (``aegis.cpp``, a
copy of the JAX package's), built with ``g++`` at first use into
``build/native/`` at the repository root and loaded with ctypes.  Without a
compiler ``load()`` returns None and ``vsr.checksum`` uses its pure-Python
version, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ["aegis.cpp"]
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                          "native")
_LIB_PATH = os.path.join(_BUILD_DIR, "libtb_aegis.so")

_lock = threading.Lock()
_lib = None
_build_failed = False


def _stale() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(_LIB_PATH)
    return any(os.path.getmtime(os.path.join(_DIR, s)) > lib_mtime
               for s in _SOURCES)


def _build() -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    sources = [os.path.join(_DIR, s) for s in _SOURCES]
    tmp = _LIB_PATH + f".tmp.{os.getpid()}"
    cmd = [
        "g++", "-std=c++17", "-O3", "-march=native", "-shared", "-fPIC",
        "-pthread", "-o", tmp, *sources,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, OSError):
        # -march=native may be unavailable (cross/sandboxed); retry generic.
        cmd = [
            "g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-pthread",
            "-o", tmp, *sources,
        ]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(tmp, _LIB_PATH)


def load():
    """The loaded library, built first if needed; None when it cannot be."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if _stale():
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
            lib.tb_checksum.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p
            ]
            lib.tb_checksum.restype = None
            lib.tb_checksum_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.tb_checksum_batch.restype = None
            lib.tb_aesni_enabled.restype = ctypes.c_int
            _lib = lib
        except Exception:
            _build_failed = True
    return _lib
