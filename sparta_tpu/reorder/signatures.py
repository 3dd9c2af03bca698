"""Packed-bitset column-block signatures.

The reference compares rows by merge-scanning their sorted column lists in
the column-block domain (idx // block_size) — O(nnz) per pair
(blocking.cpp:859-994).  The design here packs each row's occupied
column-block set into a uint64 bitset so one pattern-vs-row distance is a
handful of popcounts, and pattern-vs-ALL-candidates is a single vectorized
numpy pass over a [rows, words] array.
"""
from __future__ import annotations

import numpy as np

from ..formats.csr import CSR


def block_signatures(cmat: CSR, col_block_size: int) -> np.ndarray:
    """[rows, words] uint64 bitsets; bit k set iff column-block k occupied."""
    nbc = -(-cmat.cols // col_block_size)
    words = max(1, -(-nbc // 64))
    bits = np.zeros((cmat.rows, words), dtype=np.uint64)
    if cmat.nnz:
        rows = np.repeat(np.arange(cmat.rows), cmat.row_nnz)
        blk = cmat.indices.astype(np.int64) // col_block_size
        word = blk >> 6
        bit = np.uint64(1) << (blk & 63).astype(np.uint64)
        np.bitwise_or.at(bits, (rows, word), bit)
    return bits


def elem_signatures_row(indices: np.ndarray, cols: int) -> np.ndarray:
    """Element-level (column) bitset for one row — used for the pattern's
    exact element count in the empty-row distance special cases."""
    words = max(1, -(-cols // 64))
    out = np.zeros(words, dtype=np.uint64)
    idx = np.asarray(indices, dtype=np.int64)
    np.bitwise_or.at(out, idx >> 6, np.uint64(1) << (idx & 63).astype(np.uint64))
    return out


def popcount(bits: np.ndarray, axis: int = -1) -> np.ndarray:
    """Number of set bits, summed along ``axis``."""
    return np.bitwise_count(bits).sum(axis=axis, dtype=np.int64)
