"""Native (C++/OpenMP) host-side helpers, loaded via ctypes.

The compute path is JAX/XLA; host-side preprocessing — RMAT generation,
text edge-list parsing, the reference's seeded square-id permutation and
the triangle-counting prep — is native, like the reference's header-only
C++ tile constructors.  The shared library compiles lazily from the
shipped source with g++ on first use and is cached next to the source;
everything falls back to the pure-python implementations when no compiler
is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "planner.cpp")
_LIB = os.path.join(_HERE, "libgmplanner.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
           _SRC, "-o", _LIB]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        return True
    except Exception:
        return False


def load_planner():
    """Return the ctypes lib with argtypes configured, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None:
            return _lib
        if _tried:
            return None
        _tried = True
        if not os.path.exists(_LIB) or (
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        lib.gm_tc_create.restype = ctypes.c_void_p
        lib.gm_tc_create.argtypes = [
            i32p, i32p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32)]
        lib.gm_tc_fill.restype = None
        lib.gm_tc_fill.argtypes = [ctypes.c_void_p, i32p, i32p, i32p,
                                   i32p, u32p, i32p, i32p, i32p,
                                   i32p, i32p]
        lib.gm_tc_destroy.restype = None
        lib.gm_tc_destroy.argtypes = [ctypes.c_void_p]
        lib.gm_rmat_gen.restype = ctypes.c_int64
        lib.gm_rmat_gen.argtypes = [
            ctypes.c_int32, ctypes.c_int64, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_uint64,
            ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p]
        lib.gm_glibc_square_mapping.restype = None
        lib.gm_glibc_square_mapping.argtypes = [
            ctypes.c_int64, ctypes.c_uint32, i32p]
        lib.gm_parse_text_edges.restype = ctypes.c_int64
        lib.gm_parse_text_edges.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, i32p,
            i32p, ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_planner() is not None
