"""ctypes binding for the native edge-list parser (csrc/io.cc)."""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..native_build import CSRC, build_native

_SRC = CSRC / "io.cc"
_FLAGS = ["-O3", "-std=c++17"]

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("SPARTA_TPU_NO_NATIVE"):
        return None
    try:
        so = build_native(_SRC, "sparta_io", _FLAGS)
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.sparta_count_edges.restype = ctypes.c_int64
        lib.sparta_count_edges.argtypes = [ctypes.c_char_p]
        lib.sparta_parse_edgelist.restype = ctypes.c_int64
        lib.sparta_parse_edgelist.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def parse_edgelist(path, skip_first: int = 0):
    """Returns (rows int64[n], cols int64[n], vals float64[n], has_weights)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native io unavailable")
    pb = str(path).encode()
    n = lib.sparta_count_edges(pb)
    if n < 0:
        raise FileNotFoundError(path)
    n -= skip_first
    n = max(n, 0)
    rows = np.empty(n, dtype=np.int64)
    cols = np.empty(n, dtype=np.int64)
    vals = np.empty(n, dtype=np.float64)
    mf = ctypes.c_int32(2)
    k = lib.sparta_parse_edgelist(
        pb, skip_first, n,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(mf),
    )
    if k < 0:
        raise FileNotFoundError(path)
    return rows[:k], cols[:k], vals[:k], mf.value == 3
