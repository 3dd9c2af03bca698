"""Artifact I/O: grouping (.g) files and npz checkpoints of blockings.

Reference: groupings persisted one id per line (utilities.cpp:239-243,
Matrix_Blocking.cpp:24-32) and re-loaded by Matrix_Analysis.cpp:10-32;
reordered matrices exported as .el (reorder_matrix.cpp:45-46).  The npz
checkpoint is the upgrade here: permutation/partition + BELL arrays
cached per (matrix, config) so reordering cost is paid once per sweep.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .bell import BELL


def read_grouping(path: str | Path, expected_rows: int | None = None) -> np.ndarray:
    """Read a .g grouping file: one group id per line.  When ``expected_rows``
    is given and the file has rows+1 entries, the leading size line is
    dropped (reference Matrix_Analysis.cpp:10-32, :78)."""
    vals = [int(float(x)) for x in Path(path).read_text().split()]
    if expected_rows is not None and len(vals) == expected_rows + 1:
        vals = vals[1:]
    return np.asarray(vals, dtype=np.int64)


def write_grouping(path: str | Path, grouping: np.ndarray) -> None:
    Path(path).write_text("\n".join(str(int(g)) for g in grouping) + "\n")


def save_blocking_npz(path: str | Path, bell: BELL, **extra) -> None:
    np.savez_compressed(
        path,
        cols_idx=bell.cols_idx,
        vals=bell.vals,
        nb_row=bell.nb_row,
        row_perm=bell.row_perm,
        block_row_size=bell.block_row_size,
        block_col_size=bell.block_col_size,
        shape=np.asarray(bell.shape),
        orig_shape=np.asarray(bell.orig_shape),
        **extra,
    )


def load_blocking_npz(path: str | Path) -> BELL:
    z = np.load(path)
    return BELL(
        cols_idx=z["cols_idx"],
        vals=z["vals"],
        nb_row=z["nb_row"],
        row_perm=z["row_perm"],
        block_row_size=int(z["block_row_size"]),
        block_col_size=int(z["block_col_size"]),
        shape=tuple(z["shape"]),
        orig_shape=tuple(z["orig_shape"]),
    )
