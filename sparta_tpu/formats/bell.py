"""Blocked-ELLPACK: fixed-size block grid, rectangular (jit-friendly) index
tensor padded to the longest block-row.

The counterpart of the reference's cuSPARSE Blocked-ELL conversion
(src/cuda/cuda_utilities.cpp:1656-1710): ``cols_idx`` padded with -1 like the
reference's ellColInd; additionally ``nb_row`` stores the true per-row block
counts so device kernels can bound their inner loops without scanning for the
sentinel.  Values are [nbr, max_nb, bh, bw] row-major blocks — one gather +
matmul per (block-row, block) pair.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..definitions import DATA, INT, ceil_div, round_up
from ..utils import get_partition, get_permutation
from .csr import CSR
from .vbr import VBR


@dataclasses.dataclass
class BELL:
    cols_idx: np.ndarray   # INT [nbr, max_nb], block-col ids, -1 padded
    vals: np.ndarray       # DATA [nbr, max_nb, bh, bw]
    nb_row: np.ndarray     # INT [nbr] true nonzero-block count per block-row
    row_perm: np.ndarray   # original row at permuted slot (padding rows >= orig rows)
    block_row_size: int
    block_col_size: int
    shape: tuple[int, int]       # padded (nbr*bh, nbc*bw)
    orig_shape: tuple[int, int]

    @property
    def n_block_rows(self) -> int:
        return self.cols_idx.shape[0]

    @property
    def max_nb(self) -> int:
        return self.cols_idx.shape[1]

    @property
    def n_block_cols(self) -> int:
        return ceil_div(self.shape[1], self.block_col_size)

    @property
    def total_nzblocks(self) -> int:
        return int(self.nb_row.sum())

    @property
    def nzcount_total(self) -> int:
        """Stored entries incl. fill-in (= VBR_nzcount for fixed blocking)."""
        return self.total_nzblocks * self.block_row_size * self.block_col_size

    def density_stats(self, nnz: int) -> dict:
        """Blocking-quality metrics (reference blocking_barplots.py:148-162)."""
        rows, cols = self.orig_shape
        density = nnz / (rows * cols)
        block_density = nnz / max(self.nzcount_total, 1)
        return {
            "density": density,
            "block_density": block_density,
            "dense_amp": block_density / density if density else 0.0,
        }

    def to_dense_permuted(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=DATA)
        bh, bw = self.block_row_size, self.block_col_size
        for ib in range(self.n_block_rows):
            for k in range(int(self.nb_row[ib])):
                jb = int(self.cols_idx[ib, k])
                out[ib * bh : (ib + 1) * bh, jb * bw : (jb + 1) * bw] = self.vals[ib, k]
        return out

    def multiply(self, B: np.ndarray) -> np.ndarray:
        """Serial oracle: C = A_perm @ B with B padded to the blocked K."""
        B = np.asarray(B, dtype=np.float64)
        K = self.shape[1]
        if B.shape[0] < K:
            B = np.pad(B, ((0, K - B.shape[0]), (0, 0)))
        C = np.zeros((self.shape[0], B.shape[1]), dtype=np.float64)
        bh, bw = self.block_row_size, self.block_col_size
        for ib in range(self.n_block_rows):
            for k in range(int(self.nb_row[ib])):
                jb = int(self.cols_idx[ib, k])
                C[ib * bh : (ib + 1) * bh] += self.vals[ib, k].astype(np.float64) @ B[
                    jb * bw : (jb + 1) * bw
                ]
        return C.astype(DATA)


def bell_from_csr(
    cmat: CSR,
    grouping: np.ndarray | None,
    block_row_size: int,
    block_col_size: int | None = None,
    pad_nb_to: int = 1,
) -> BELL:
    """Build Blocked-ELL directly from CSR + grouping in one vectorized pass.

    ``grouping`` must produce fixed-size groups of ``block_row_size`` rows
    (apply ``get_fixed_size_grouping`` first, as the reference does with
    ``-F 1``); ``grouping=None`` means natural blocking.  ``pad_nb_to`` rounds
    max_nb up to a multiple (keeps Pallas grid shapes stable across rows).
    """
    bh = int(block_row_size)
    bw = int(block_col_size or block_row_size)
    rows = round_up(cmat.rows, bh)
    cols = round_up(cmat.cols, bw)
    nbr, nbc = rows // bh, cols // bw

    if grouping is None:
        row_perm = np.arange(rows, dtype=np.int64)
    else:
        grouping = np.asarray(grouping)
        part = get_partition(grouping)
        if np.any(np.diff(part)[:-1] != bh) or (np.diff(part)[-1] > bh):
            raise ValueError(
                "bell_from_csr needs fixed-size groups of block_row_size rows "
                "(use get_fixed_size_grouping / force_fixed_size)"
            )
        row_perm = get_permutation(grouping)
        if rows > row_perm.size:
            row_perm = np.concatenate((row_perm, np.arange(row_perm.size, rows)))

    inv_perm = np.empty(rows, dtype=np.int64)
    inv_perm[row_perm] = np.arange(rows)

    nnz_rows = np.repeat(np.arange(cmat.rows), cmat.row_nnz)
    prow = inv_perm[nnz_rows]
    ib = prow // bh
    jb = cmat.indices.astype(np.int64) // bw

    key = ib * nbc + jb
    order = np.argsort(key, kind="stable")
    uniq_key, block_of_entry_sorted = np.unique(key[order], return_inverse=True)
    block_of_entry = np.empty_like(block_of_entry_sorted)
    block_of_entry[order] = block_of_entry_sorted

    blk_ib = (uniq_key // nbc).astype(np.int64)
    blk_jb = (uniq_key % nbc).astype(INT)
    nb_row = np.bincount(blk_ib, minlength=nbr).astype(INT)
    max_nb = int(nb_row.max()) if nb_row.size else 0
    max_nb = max(round_up(max_nb, pad_nb_to), pad_nb_to)

    # ordinal of each block within its block-row
    jab_ptr = np.concatenate(([0], np.cumsum(nb_row))).astype(np.int64)
    blk_ord = np.arange(uniq_key.size) - jab_ptr[blk_ib]

    cols_idx = np.full((nbr, max_nb), -1, dtype=INT)
    cols_idx[blk_ib, blk_ord] = blk_jb

    vals = np.zeros((nbr, max_nb, bh, bw), dtype=DATA)
    e_ib = blk_ib[block_of_entry]
    e_ord = blk_ord[block_of_entry]
    # accumulate: stored duplicate (row, col) entries SUM, matching the
    # serial CSR.multiply oracle (plain fancy-index assignment would keep
    # only the last duplicate)
    np.add.at(vals, (e_ib, e_ord, prow % bh, cmat.indices % bw),
              cmat.values())

    return BELL(
        cols_idx=cols_idx,
        vals=vals,
        nb_row=nb_row,
        row_perm=row_perm,
        block_row_size=bh,
        block_col_size=bw,
        shape=(rows, cols),
        orig_shape=(cmat.rows, cmat.cols),
    )


def bell_from_vbr(vbr: VBR, pad_nb_to: int = 1) -> BELL:
    """Convert a fixed-height VBR to Blocked-ELL (reference
    prepare_cusparse_BLOCKEDELLPACK, cuda_utilities.cpp:1656-1710)."""
    heights = vbr.heights
    if heights.size == 0:
        raise ValueError("empty VBR")
    bh = int(heights[0])
    if np.any(heights != bh):
        raise ValueError("bell_from_vbr requires uniform block heights")
    bw = vbr.block_col_size
    nbr = vbr.block_rows
    nb_row = vbr.nzcount.astype(INT)
    max_nb = max(round_up(int(nb_row.max()), pad_nb_to), pad_nb_to)

    cols_idx = np.full((nbr, max_nb), -1, dtype=INT)
    vals = np.zeros((nbr, max_nb, bh, bw), dtype=DATA)
    jp = vbr.jab_ptr()
    for ib in range(nbr):
        n = int(nb_row[ib])
        cols_idx[ib, :n] = vbr.jab[jp[ib] : jp[ib] + n]
        for k in range(n):
            b = jp[ib] + k
            vals[ib, k] = vbr.mab[vbr.block_ptr[b] : vbr.block_ptr[b + 1]].reshape(bh, bw)
    return BELL(
        cols_idx=cols_idx,
        vals=vals,
        nb_row=nb_row,
        row_perm=vbr.row_perm,
        block_row_size=bh,
        block_col_size=bw,
        shape=(nbr * bh, vbr.block_cols * bw),
        orig_shape=vbr.orig_shape,
    )
