"""VBR (Variable Block Row) format: variable-height row blocks x fixed-width
column blocks, dense zero-padded blocks.

A re-design of the reference VBR (include/matrices.h:93-122,
src/general/vbr.cpp:135-237).  Construction is a vectorized scatter over the
nnz entries instead of a per-block scan; blocks are stored contiguously with
row-major entries inside each block (the natural layout for feeding matmul
tiles — the reference stores in-block column-major for cuBLAS, vbr.cpp:224).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..definitions import DATA, INT, ceil_div, round_up
from ..utils import get_partition, get_permutation
from .csr import CSR


@dataclasses.dataclass
class VBR:
    """Blocked matrix in permuted row space.

    ``row_part[k]..row_part[k+1]``: permuted-row range of block-row k.
    ``row_perm[p]`` : original row stored at permuted slot p (slots beyond
                      the original row count are zero padding rows).
    ``jab``         : flattened nonzero block-column indices, block-rows in
                      order, ascending within a block-row.
    ``block_ptr``   : [total_nzblocks+1] offsets into ``mab``.
    ``mab``         : flattened dense block entries; block b occupies
                      ``mab[block_ptr[b]:block_ptr[b+1]]`` with row-major
                      shape (height(block_row), block_col_size).
    ``shape``       : padded shape (rows may exceed the source matrix when
                      force_fixed_size pads to a block multiple).
    """

    row_part: np.ndarray
    row_perm: np.ndarray
    nzcount: np.ndarray
    jab: np.ndarray
    block_ptr: np.ndarray
    mab: np.ndarray
    block_col_size: int
    shape: tuple[int, int]
    orig_shape: tuple[int, int]

    @property
    def block_rows(self) -> int:
        return self.row_part.size - 1

    @property
    def block_cols(self) -> int:
        return ceil_div(self.shape[1], self.block_col_size)

    @property
    def heights(self) -> np.ndarray:
        return np.diff(self.row_part)

    @property
    def total_nzblocks(self) -> int:
        return int(self.jab.size)

    @property
    def nzcount_total(self) -> int:
        """Total stored (incl. fill-in zero) entries = reference VBR nztot."""
        return int(self.mab.size)

    def jab_ptr(self) -> np.ndarray:
        """[block_rows+1] offsets into jab."""
        return np.concatenate(([0], np.cumsum(self.nzcount))).astype(np.int64)

    def block(self, b: int) -> np.ndarray:
        """Dense entries of the b-th nonzero block, shape (height, bw)."""
        ib = int(np.searchsorted(self.jab_ptr(), b, side="right") - 1)
        h = int(self.heights[ib])
        return self.mab[self.block_ptr[b] : self.block_ptr[b + 1]].reshape(
            h, self.block_col_size
        )

    # -- serial oracle -----------------------------------------------------
    def multiply(self, B: np.ndarray) -> np.ndarray:
        """Reference serial block multiply (vbr.cpp:323-372): C = A_perm @ B.

        Output rows are in *permuted* order (row stripe k of C corresponds to
        block-row k), matching the reference which multiplies the reordered
        matrix.
        """
        B = np.asarray(B, dtype=np.float64)
        C = np.zeros((self.shape[0], B.shape[1]), dtype=np.float64)
        jp = self.jab_ptr()
        bw = self.block_col_size
        for ib in range(self.block_rows):
            r0, r1 = int(self.row_part[ib]), int(self.row_part[ib + 1])
            for k in range(jp[ib], jp[ib + 1]):
                jb = int(self.jab[k])
                blk = self.mab[self.block_ptr[k] : self.block_ptr[k + 1]].reshape(
                    r1 - r0, bw
                ).astype(np.float64)
                c0 = jb * bw
                c1 = min(c0 + bw, B.shape[0])
                C[r0:r1] += blk[:, : c1 - c0] @ B[c0:c1]
        return C.astype(DATA)

    def to_dense_permuted(self) -> np.ndarray:
        """Densify in permuted row space (zero-padded)."""
        out = np.zeros(self.shape, dtype=DATA)
        jp = self.jab_ptr()
        bw = self.block_col_size
        for ib in range(self.block_rows):
            r0, r1 = int(self.row_part[ib]), int(self.row_part[ib + 1])
            for k in range(jp[ib], jp[ib + 1]):
                jb = int(self.jab[k])
                blk = self.mab[self.block_ptr[k] : self.block_ptr[k + 1]].reshape(
                    r1 - r0, bw
                )
                c0 = jb * bw
                w = min(bw, self.shape[1] - c0)
                out[r0:r1, c0 : c0 + w] = blk[:, :w]
        return out


def partition_check(part: np.ndarray, rows: int) -> int:
    """Validate a partition vector (reference vbr.cpp:108-118).
    Returns 0 when valid, error code otherwise."""
    part = np.asarray(part)
    if part.size == 0:
        return 1
    if part[-1] != rows:
        return 2
    if np.any(np.diff(part) < 0):
        return 3
    return 0


def vbr_from_csr_partition(
    cmat: CSR, row_partition: np.ndarray, col_block_size: int
) -> VBR:
    """Build a VBR from an explicit row partition WITHOUT permuting rows
    (reference VBR::fill_from_CSR, vbr.cpp:239-321): block-row k covers
    original rows row_partition[k]..row_partition[k+1]."""
    part = np.asarray(row_partition)
    if partition_check(part, cmat.rows) != 0:
        raise ValueError("invalid row partition")
    # identity permutation; grouping implied by the partition
    grouping = np.zeros(cmat.rows, dtype=np.int64)
    for k in range(part.size - 1):
        grouping[part[k] : part[k + 1]] = k
    return vbr_from_csr(cmat, grouping, col_block_size)


def vbr_from_csr(
    cmat: CSR,
    grouping: np.ndarray | None = None,
    col_block_size: int = 128,
    row_block_size: int | None = None,
    force_fixed_size: bool = False,
) -> VBR:
    """Build a VBR from a CSR + grouping (reference VBR::fill_from_CSR_inplace,
    vbr.cpp:135-237).  ``grouping=None`` derives a natural fixed-size grouping
    from ``row_block_size`` (vbr.cpp:121-132).  With ``force_fixed_size`` the
    matrix is zero-padded so rows/cols are multiples of the block sizes
    (vbr.cpp:143-148).
    """
    bw = int(col_block_size)
    if grouping is None:
        if row_block_size is None:
            raise ValueError("need grouping or row_block_size")
        grouping = np.arange(cmat.rows) // int(row_block_size)
    grouping = np.asarray(grouping)

    row_part = get_partition(grouping).copy()
    row_perm = get_permutation(grouping)

    rows, cols = cmat.rows, cmat.cols
    if force_fixed_size:
        if row_block_size is None:
            raise ValueError("force_fixed_size requires row_block_size")
        rows = round_up(cmat.rows, int(row_block_size))
        cols = round_up(cmat.cols, bw)
        row_part[-1] = rows
        if rows > row_perm.size:
            row_perm = np.concatenate((row_perm, np.arange(row_perm.size, rows)))

    if partition_check(row_part, rows) != 0:
        raise ValueError("invalid partition derived from grouping")

    block_rows = row_part.size - 1

    # permuted row of each original row
    inv_perm = np.empty(row_perm.size, dtype=np.int64)
    inv_perm[row_perm] = np.arange(row_perm.size)

    nnz_rows = np.repeat(np.arange(cmat.rows), cmat.row_nnz)
    prow = inv_perm[nnz_rows]                                  # permuted row per entry
    ib = np.searchsorted(row_part, prow, side="right") - 1     # block-row per entry
    jb = cmat.indices.astype(np.int64) // bw                   # block-col per entry

    # unique nonzero blocks, ordered (block_row, block_col)
    nbc = ceil_div(cols, bw)
    key = ib * nbc + jb
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    uniq_key, block_of_entry_sorted = np.unique(key_sorted, return_inverse=True)
    block_of_entry = np.empty_like(block_of_entry_sorted)
    block_of_entry[order] = block_of_entry_sorted

    blk_ib = uniq_key // nbc
    blk_jb = (uniq_key % nbc).astype(INT)

    nzcount = np.bincount(blk_ib, minlength=block_rows).astype(np.int64)
    heights = np.diff(row_part)
    blk_sizes = heights[blk_ib] * bw
    block_ptr = np.concatenate(([0], np.cumsum(blk_sizes))).astype(np.int64)

    mab = np.zeros(int(block_ptr[-1]), dtype=DATA)
    local_r = prow - row_part[ib]
    local_c = cmat.indices.astype(np.int64) % bw
    pos = block_ptr[block_of_entry] + local_r * bw + local_c
    # stored duplicate (row, col) entries SUM (serial-oracle semantics);
    # fancy assignment would keep only the last duplicate
    np.add.at(mab, pos, cmat.values())

    return VBR(
        row_part=row_part.astype(np.int64),
        row_perm=row_perm.astype(np.int64),
        nzcount=nzcount,
        jab=blk_jb,
        block_ptr=block_ptr,
        mab=mab,
        block_col_size=bw,
        shape=(rows, cols),
        orig_shape=(cmat.rows, cmat.cols),
    )
