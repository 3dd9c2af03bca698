"""Permutation / partition helpers and timers.

Vectorized equivalents of the reference's pointer-chasing
helpers (reference: include/utilities.h, src/general/utilities.cpp).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


def get_permutation(grouping: np.ndarray) -> np.ndarray:
    """Argsort rows by group id (reference utilities.cpp:8-20).

    Stable: rows with equal group keep ascending original order.  (The
    reference uses std::sort, whose tie order is unspecified; within-group
    order does not affect any blocking statistic.)
    """
    return np.argsort(np.asarray(grouping), kind="stable")


def get_partition(grouping: np.ndarray) -> np.ndarray:
    """Block-row boundary vector from a grouping (reference utilities.cpp:22-43).

    Returns ``part`` with ``part[k]..part[k+1]`` the permuted-row range of the
    k-th group (groups ordered by ascending group id); ``part[-1] == rows``.
    """
    g = np.sort(np.asarray(grouping))
    if g.size == 0:
        return np.zeros(1, dtype=np.int64)
    # positions where a new group id starts
    starts = np.flatnonzero(np.concatenate(([True], g[1:] != g[:-1])))
    return np.concatenate((starts, [g.size])).astype(np.int64)


def get_group_sizes(grouping: np.ndarray) -> np.ndarray:
    part = get_partition(grouping)
    return np.diff(part)


def get_fixed_size_grouping(grouping: np.ndarray, row_block_size: int) -> np.ndarray:
    """Re-chop any grouping into fixed-height groups (reference utilities.cpp:45-54).

    Rows keep the permuted order implied by ``grouping``; each consecutive run
    of ``row_block_size`` permuted rows becomes one group.
    """
    grouping = np.asarray(grouping)
    perm = get_permutation(grouping)
    result = np.empty(grouping.size, dtype=np.int64)
    result[perm] = np.arange(grouping.size) // row_block_size
    return result


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return inv


@dataclass
class PhaseTimers:
    """Accumulating wall-clock phase timers (reference TIMER_* macros,
    include/utilities.h:12-21), in microseconds for schema parity."""

    totals_us: dict = field(default_factory=dict)

    def add(self, name: str, seconds: float) -> None:
        self.totals_us[name] = self.totals_us.get(name, 0.0) + seconds * 1e6

    def get(self, name: str) -> float:
        return self.totals_us.get(name, 0.0)


class Timer:
    """Context-manager wall timer."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False
