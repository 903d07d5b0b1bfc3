"""Native (C++) runtime pieces with ctypes bindings.

Builds lazily with g++ on first use; callers fall back to the pure
Python implementations when no toolchain is available, and
``build_error()`` says why the library is missing.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

_HERE = os.path.dirname(__file__)
LIB_PATH = os.path.join(_HERE, "libaomtpu_ec.so")
_lib = None
_error = None


def _build() -> bool:
    global _error
    src = os.path.join(_HERE, "ec.cpp")
    try:
        r = subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", src, "-o", LIB_PATH],
            capture_output=True, text=True)
    except OSError as e:
        _error = f"g++ not runnable: {e}"
        return False
    if r.returncode != 0:
        _error = f"g++ failed ({r.returncode}): {r.stderr.strip()[-2000:]}"
        return False
    return True


def build_error() -> str | None:
    """Why ``get_lib()`` returned None (build or load failure), else None."""
    return _error


def get_lib():
    """Load (building if needed) the native EC library, or None."""
    global _lib, _error
    if _lib is not None:
        return _lib
    if not os.path.exists(LIB_PATH) or (
            os.path.getmtime(LIB_PATH)
            < os.path.getmtime(os.path.join(_HERE, "ec.cpp"))):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError as e:
        _error = f"cannot load {LIB_PATH}: {e}"
        return None
    lib.ec_enc_new.restype = ctypes.c_void_p
    lib.ec_dec_new.restype = ctypes.c_void_p
    lib.ec_dec_new.argtypes = [ctypes.c_char_p, ctypes.c_long]
    for name in ("ec_enc_free", "ec_enc_set_allow_update", "ec_enc_symbol",
                 "ec_enc_cdf", "ec_enc_bit", "ec_enc_literal", "ec_enc_copy",
                 "ec_dec_free", "ec_dec_set_allow_update"):
        getattr(lib, name).restype = None
    for name in ("ec_enc_done", "ec_enc_size", "ec_enc_tell", "ec_dec_tell"):
        getattr(lib, name).restype = ctypes.c_long
    for name in ("ec_dec_symbol", "ec_dec_cdf", "ec_dec_bit"):
        getattr(lib, name).restype = ctypes.c_int
    lib.ec_dec_literal.restype = ctypes.c_uint
    lib.ec_enc_pack_kf_uniform.restype = ctypes.c_int
    _lib = lib
    return lib
