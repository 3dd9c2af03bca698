"""ctypes binding for the native C++ blocking engine (csrc/blocking.cc).

Compiled lazily with g++ on the machine that runs it (native_build.py: the
library is keyed by source, flags and host); falls back to the numpy engine
when no toolchain is available.  Same semantics as algos.greedy_blocking —
parity-tested in tests/test_native.py.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..native_build import CSRC, build_native
from .algos import BlockingStats

_SRC = CSRC / "blocking.cc"
_FLAGS = ["-O3", "-march=native", "-std=c++17"]

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
        so = build_native(_SRC, "sparta_blocking", _FLAGS)
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.sparta_greedy_blocking.restype = ctypes.c_int
        lib.sparta_greedy_blocking.argtypes = [
            ctypes.POINTER(ctypes.c_int64),   # indptr
            ctypes.POINTER(ctypes.c_int32),   # indices
            ctypes.c_int64, ctypes.c_int64,   # rows, cols
            ctypes.c_int32, ctypes.c_float, ctypes.c_int32,  # bw, tau, measure
            ctypes.c_int32, ctypes.c_int32,   # use_groups, use_pattern
            ctypes.c_int32, ctypes.c_int32,   # strict_less, prune
            ctypes.c_int32, ctypes.c_int32,   # max_size, keeper
            ctypes.POINTER(ctypes.c_int64),   # grouping_out
            ctypes.POINTER(ctypes.c_int64),   # counters_out
            ctypes.POINTER(ctypes.c_double),  # stats_out
        ]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def greedy_blocking(
    cmat,
    tau: float,
    measure: int,
    col_block_size: int,
    use_groups: bool = False,
    use_pattern: bool = True,
    strict_less: bool = False,
    prune: bool = True,
    max_size: int = 0,
    keeper: bool = False,
    stats: BlockingStats | None = None,
) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native blocking backend unavailable")
    indptr = np.ascontiguousarray(cmat.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(cmat.indices, dtype=np.int32)
    grouping = np.empty(cmat.rows, dtype=np.int64)
    counters = np.zeros(2, dtype=np.int64)
    dstats = np.zeros(4, dtype=np.float64)
    rc = lib.sparta_greedy_blocking(
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cmat.rows, cmat.cols,
        col_block_size, ctypes.c_float(tau), measure,
        int(use_groups), int(use_pattern), int(strict_less), int(prune),
        int(max_size), int(keeper),
        grouping.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        counters.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dstats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise RuntimeError(f"native blocking failed with code {rc}")
    if stats is not None:
        stats.comparison_counter += int(counters[0])
        stats.merge_counter += int(counters[1])
        stats.total_merge_tau += float(dstats[0])
        stats.total_row_distance += float(dstats[1])
        stats.time_comparisons += float(dstats[2])
        stats.time_merges += float(dstats[3])
    return grouping
