"""The port's native (C++) helpers, copies of the JAX package's, built with
``g++`` at first use into ``build/native/`` at the repository root and
loaded with ctypes:

- ``load()``: the AEGIS-128L checksum (``aegis.cpp``).  Without a compiler
  it returns None and ``vsr.checksum`` uses its pure-Python version, as the
  JAX package does.
- ``load_engine()``: the host engine (``engine.cpp`` with ``tb_types.h``),
  the sequential, exact commit engine ``host_engine.py`` drives; None when
  it cannot be built.
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

_ENGINE_SOURCES = ["engine.cpp", "tb_types.h"]
_ENGINE_LIB_PATH = os.path.join(_BUILD_DIR, "libtb_engine.so")

_lock = threading.Lock()
_lib = None
_build_failed = False
_engine_lib = None
_engine_build_failed = False


def _stale(lib_path: str = _LIB_PATH, sources=tuple(_SOURCES)) -> bool:
    if not os.path.exists(lib_path):
        return True
    lib_mtime = os.path.getmtime(lib_path)
    return any(os.path.getmtime(os.path.join(_DIR, s)) > lib_mtime
               for s in sources)


def _build(lib_path: str = _LIB_PATH, sources=tuple(_SOURCES)) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    sources = [os.path.join(_DIR, s) for s in sources if s.endswith(".cpp")]
    tmp = lib_path + f".tmp.{os.getpid()}"
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
    os.replace(tmp, lib_path)


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


def load_engine():
    """The loaded host engine library, built first if needed; None when it
    cannot be."""
    global _engine_lib, _engine_build_failed
    if _engine_lib is not None or _engine_build_failed:
        return _engine_lib
    with _lock:
        if _engine_lib is not None or _engine_build_failed:
            return _engine_lib
        try:
            if _stale(_ENGINE_LIB_PATH, _ENGINE_SOURCES):
                _build(_ENGINE_LIB_PATH, _ENGINE_SOURCES)
            lib = ctypes.CDLL(_ENGINE_LIB_PATH)
            for fn in ("tb_engine_create_accounts",
                       "tb_engine_create_transfers"):
                f = getattr(lib, fn)
                f.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
                    ctypes.c_uint64, ctypes.c_void_p,
                ]
                f.restype = ctypes.c_int
            for fn in ("tb_engine_lookup_accounts",
                       "tb_engine_lookup_transfers"):
                f = getattr(lib, fn)
                f.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
                    ctypes.c_void_p, ctypes.c_void_p,
                ]
                f.restype = ctypes.c_int
            lib.tb_engine_rehash.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ]
            lib.tb_engine_rehash.restype = ctypes.c_int
            _engine_lib = lib
        except Exception:
            _engine_build_failed = True
    return _engine_lib
