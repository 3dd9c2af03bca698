"""CSR matrix container + I/O + permutation ops (host side, numpy).

A re-design of the reference's jagged-pointer CSR
(reference: include/matrices.h:10-91, src/general/csr.cpp).  We use the
standard 3-array CSR layout (indptr/indices/data) so every transform is a
vectorized numpy pass instead of a per-row pointer walk, and conversion to
device-friendly blocked formats is a reshape/scatter.
"""
from __future__ import annotations

import dataclasses
import io as _io
from pathlib import Path

import numpy as np

from ..definitions import DATA, INT, MatrixFormat
from ..utils import get_permutation, invert_permutation


@dataclasses.dataclass
class CSR:
    """Compressed sparse row matrix.

    ``data is None`` corresponds to the reference's ``pattern_only`` mode
    (matrices.h:18): all stored values are implicitly 1.0.
    Column indices are kept sorted within each row (the reference relies on
    sorted rows for its merge-scan distance functions).
    """

    indptr: np.ndarray   # int64 [rows+1]
    indices: np.ndarray  # INT   [nnz], sorted within each row
    data: np.ndarray | None  # DATA [nnz] or None (pattern_only)
    shape: tuple[int, int]

    # -- basic properties -------------------------------------------------
    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    @property
    def pattern_only(self) -> bool:
        return self.data is None

    @property
    def nnz(self) -> int:
        """Total stored entries (reference ``nztot()``, matrices.h:46-54)."""
        return int(self.indices.size)

    @property
    def row_nnz(self) -> np.ndarray:
        """Per-row nonzero counts (reference ``nzcount``)."""
        return np.diff(self.indptr)

    def values(self) -> np.ndarray:
        """Materialized values; ones when pattern_only."""
        if self.data is None:
            return np.ones(self.nnz, dtype=DATA)
        return self.data

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_coo(
        cls,
        row: np.ndarray,
        col: np.ndarray,
        val: np.ndarray | None,
        shape: tuple[int, int],
        sum_duplicates: bool = False,
    ) -> "CSR":
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        order = np.lexsort((col, row))
        row, col = row[order], col[order]
        if val is not None:
            val = np.asarray(val, dtype=DATA)[order]
        if sum_duplicates and row.size:
            keep = np.concatenate(
                ([True], (row[1:] != row[:-1]) | (col[1:] != col[:-1]))
            )
            if val is not None:
                seg = np.cumsum(keep) - 1
                val = np.bincount(seg, weights=val, minlength=int(keep.sum())).astype(DATA)
            row, col = row[keep], col[keep]
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, row + 1, 1)
        np.cumsum(indptr, out=indptr)
        return cls(indptr, col.astype(INT), val, shape)

    @classmethod
    def from_scipy(cls, mat) -> "CSR":
        m = mat.tocsr()
        m.sort_indices()
        return cls(
            m.indptr.astype(np.int64),
            m.indices.astype(INT),
            m.data.astype(DATA),
            m.shape,
        )

    @classmethod
    def from_dense(cls, arr: np.ndarray, pattern_only: bool = False) -> "CSR":
        arr = np.asarray(arr)
        row, col = np.nonzero(arr)
        val = None if pattern_only else arr[row, col]
        return cls.from_coo(row, col, val, arr.shape)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.values(), self.indices.astype(np.int64), self.indptr), shape=self.shape
        )

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=DATA)
        rows = np.repeat(np.arange(self.rows), self.row_nnz)
        # stored duplicates SUM (same semantics as the serial multiply)
        np.add.at(out, (rows, self.indices), self.values())
        return out

    # -- reference serial oracle -----------------------------------------
    def multiply(self, B: np.ndarray) -> np.ndarray:
        """Serial-oracle SpMM C = A @ B (reference CSR::multiply, csr.cpp:49-65).

        The reference stores B, C column-major; here B, C are plain [K, N]
        numpy arrays — layout is an XLA concern on device.
        """
        B = np.asarray(B, dtype=np.float64)
        C = np.zeros((self.rows, B.shape[1]), dtype=np.float64)
        vals = self.values().astype(np.float64)
        rows = np.repeat(np.arange(self.rows), self.row_nnz)
        np.add.at(C, rows, vals[:, None] * B[self.indices])
        return C.astype(DATA)

    # -- permutation / reorder ops ---------------------------------------
    def permute_rows(self, permutation: np.ndarray) -> "CSR":
        """Row i of the result is row permutation[i] of self (csr.cpp:67-76)."""
        permutation = np.asarray(permutation)
        if permutation.size != self.rows:
            raise ValueError("permutation length must equal rows")
        counts = self.row_nnz[permutation]
        indptr = np.concatenate(([0], np.cumsum(counts)))
        # vectorized gather of each source row's entry range, in permuted order
        total = int(indptr[-1])
        starts = self.indptr[permutation]
        offsets = indptr[:-1]
        src = (
            np.repeat(starts - offsets, counts) + np.arange(total)
            if total
            else np.zeros(0, dtype=np.int64)
        )
        data = None if self.data is None else self.data[src]
        return CSR(indptr.astype(np.int64), self.indices[src], data, self.shape)

    def permute_cols(self, permutation: np.ndarray) -> "CSR":
        """Column j moves to position inverse_permutation[j] (csr.cpp:78-99)."""
        permutation = np.asarray(permutation)
        if permutation.size != self.cols:
            raise ValueError("permutation length must equal cols")
        inv = invert_permutation(permutation)
        new_idx = inv[self.indices]
        # re-sort within rows (values follow their column in our design;
        # note the reference sorts indices only and leaves ma unpermuted —
        # harmless there because reorder2d is used on pattern-only matrices)
        rows = np.repeat(np.arange(self.rows), self.row_nnz)
        order = np.lexsort((new_idx, rows))
        data = None if self.data is None else self.data[order]
        return CSR(self.indptr.copy(), new_idx[order].astype(INT), data, self.shape)

    def reorder(self, grouping: np.ndarray) -> "CSR":
        """Permute rows so same-group rows become adjacent (csr.cpp:101-109)."""
        return self.permute_rows(get_permutation(grouping))

    def reorder2d(self, grouping: np.ndarray) -> "CSR":
        """Symmetric row+column reorder (csr.cpp:111-120)."""
        perm = get_permutation(grouping)
        return self.permute_rows(perm).permute_cols(perm)

    def reorder_by_degree(self, descending: bool = True) -> "CSR":
        """Sort rows by nonzero count (csr.cpp:123-155)."""
        key = self.row_nnz
        perm = np.argsort(-key if descending else key, kind="stable")
        return self.permute_rows(perm)

    def scramble(self, seed: int = 0) -> "CSR":
        """Random row shuffle baseline (csr.cpp:157-166)."""
        rng = np.random.default_rng(seed)
        return self.permute_rows(rng.permutation(self.rows))

    def with_shape(self, shape: tuple[int, int]) -> "CSR":
        """Grow the shape (pad with empty rows / wider column space)."""
        rows, cols = shape
        if rows < self.rows or cols < self.cols:
            raise ValueError("with_shape cannot shrink")
        indptr = np.concatenate(
            (self.indptr, np.full(rows - self.rows, self.indptr[-1]))
        )
        return CSR(indptr.astype(np.int64), self.indices, self.data, (rows, cols))

    def symmetrized(self) -> "CSR":
        """Pattern union with the transpose (reference symmetrize path,
        csr.cpp:266-284; applies to pattern-only matrices)."""
        rows = np.repeat(np.arange(self.rows), self.row_nnz)
        n = max(self.rows, self.cols)
        r = np.concatenate((rows, self.indices))
        c = np.concatenate((self.indices, rows))
        mat = CSR.from_coo(r, c, None, (n, n))
        # drop duplicates
        keep_rows = np.repeat(np.arange(n), mat.row_nnz)
        keep = np.concatenate(
            ([True], (keep_rows[1:] != keep_rows[:-1]) | (mat.indices[1:] != mat.indices[:-1]))
        ) if mat.nnz else np.zeros(0, dtype=bool)
        return CSR.from_coo(keep_rows[keep], mat.indices[keep], None, (n, n))

    # -- I/O --------------------------------------------------------------
    def save_to_edgelist(self, path: str | Path, delimiter: str = " ") -> None:
        """Write as 0-based edge list (csr.cpp:169-179); weights when present."""
        rows = np.repeat(np.arange(self.rows), self.row_nnz)
        with open(path, "w") as f:
            if self.pattern_only:
                for i, j in zip(rows, self.indices):
                    f.write(f"{i}{delimiter}{j}\n")
            else:
                for i, j, v in zip(rows, self.indices, self.data):
                    f.write(f"{i}{delimiter}{j}{delimiter}{v:g}\n")


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def read_edgelist(
    path: str | Path,
    pattern_only: bool = False,
    symmetrize: bool = False,
    delimiter: str | None = None,
) -> CSR:
    """Read a 0-based space-separated edge list (reference csr.cpp:183-311).

    Shape semantics match the reference: rows = last row index with an entry
    + 1, cols = max column index + 1.  ``symmetrize`` adds the transpose
    pattern when the input is upper/lower triangular (pattern-only inputs).
    """
    r = c = v = None
    try:
        from . import native_io

        if native_io.available():
            r, c, w, has_w3 = native_io.parse_edgelist(path)
            v = w.astype(DATA) if (has_w3 and not pattern_only) else None
    except (RuntimeError, FileNotFoundError):
        pass
    if r is None:  # numpy fallback
        text = Path(path).read_text()
        lines = [ln for ln in text.splitlines() if ln and ln[0] not in "#%"]
        if not lines:
            return CSR(np.zeros(1, dtype=np.int64), np.zeros(0, dtype=INT),
                       None, (0, 0))
        arr = np.loadtxt(_io.StringIO("\n".join(lines)), dtype=np.float64, ndmin=2)
        r = arr[:, 0].astype(np.int64)
        c = arr[:, 1].astype(np.int64)
        has_w = arr.shape[1] > 2 and not pattern_only
        v = arr[:, 2].astype(DATA) if has_w else None
    if r.size == 0:
        return CSR(np.zeros(1, dtype=np.int64), np.zeros(0, dtype=INT), None, (0, 0))
    rows = int(r.max()) + 1
    cols = int(c.max()) + 1
    if symmetrize:
        triangular = bool(np.all(c >= r)) or bool(np.all(c <= r))
        if triangular:
            if v is not None:
                raise ValueError("symmetrize only implemented for unweighted graphs")
            n = max(rows, cols)
            mask = r != c
            r, c = np.concatenate((r, c[mask])), np.concatenate((c, r[mask]))
            rows = cols = n
            return CSR.from_coo(r, c, None, (rows, cols), sum_duplicates=True)
    return CSR.from_coo(r, c, v, (rows, cols))


def read_mtx(path: str | Path, pattern_only: bool = True) -> CSR:
    """Read a MatrixMarket coordinate file (reference csr.cpp:318-365).

    The reference reads mtx as pattern-only and ignores the symmetry field;
    we honor ``symmetric``/``skew-symmetric`` banners (adding the transpose)
    and support weighted reads with ``pattern_only=False``.
    """
    symmetric = False
    with open(path) as f:
        first = f.readline()
        if first.startswith("%%MatrixMarket"):
            symmetric = "symmetric" in first.lower()
        else:
            f.seek(0)
        # skip comments
        pos = f.tell()
        line = f.readline()
        while line and line.lstrip().startswith("%"):
            pos = f.tell()
            line = f.readline()
        header = line.split()
        rows, cols, nnz = int(header[0]), int(header[1]), int(header[2])
        r = c = v = None
        try:
            # the mtx coordinate body is the same triplet stream the native
            # scanner parses (banner/comments are % lines it skips; the size
            # header is the first data line) — np.loadtxt runs ~20x slower
            # on SuiteSparse-scale files
            from . import native_io

            if native_io.available():
                ri, ci, w, has_w3 = native_io.parse_edgelist(
                    path, skip_first=1)
                if ri.size < nnz:
                    raise ValueError(
                        f"mtx body truncated: header says {nnz} entries, "
                        f"found {ri.size}")
                r, c = ri[:nnz] - 1, ci[:nnz] - 1
                if not pattern_only and has_w3:
                    v = w[:nnz].astype(DATA)
        except (RuntimeError, FileNotFoundError):
            pass
        if r is None:  # numpy fallback
            body = np.loadtxt(f, dtype=np.float64, ndmin=2,
                              max_rows=nnz) if nnz else np.zeros((0, 3))
            r = body[:, 0].astype(np.int64) - 1
            c = body[:, 1].astype(np.int64) - 1
            if not pattern_only and body.shape[1] > 2:
                v = body[:, 2].astype(DATA)
    if symmetric:
        mask = r != c
        r2 = np.concatenate((r, c[mask]))
        c2 = np.concatenate((c, r[mask]))
        if v is not None:
            v = np.concatenate((v, v[mask]))
        r, c = r2, c2
    return CSR.from_coo(r, c, v, (rows, cols), sum_duplicates=True)


def read_matrix(
    path: str | Path,
    fmt: MatrixFormat | int | None = None,
    pattern_only: bool = False,
    symmetrize: bool = False,
) -> CSR:
    """Dispatch on format (reference CSR(CLineReader&), matrices.h:65-82)."""
    if fmt is None:
        fmt = MatrixFormat.mtx if str(path).endswith(".mtx") else MatrixFormat.el
    fmt = MatrixFormat(fmt)
    if fmt == MatrixFormat.mtx:
        # reference reads .mtx as pattern-only always (csr.cpp:318-321)
        return read_mtx(path, pattern_only=True)
    return read_edgelist(path, pattern_only=pattern_only, symmetrize=symmetrize)


# ---------------------------------------------------------------------------
# synthetic generators (bench / test fixtures)
# ---------------------------------------------------------------------------

def random_uniform_csr(
    rows: int, cols: int, density: float, seed: int = 0, pattern_only: bool = False
) -> CSR:
    rng = np.random.default_rng(seed)
    nnz = int(rows * cols * density)
    idx = rng.choice(rows * cols, size=nnz, replace=False)
    r, c = idx // cols, idx % cols
    v = None if pattern_only else rng.standard_normal(nnz).astype(DATA)
    return CSR.from_coo(r, c, v, (rows, cols))


def random_block_csr(
    rows: int,
    cols: int,
    block: int,
    block_density: float,
    intra_density: float = 1.0,
    seed: int = 0,
    shuffle_rows: bool = True,
) -> CSR:
    """Planted block-sparse matrix: a fraction of (block x block) tiles are
    dense-ish; optionally rows are shuffled so reordering has work to do.
    Mirrors the synthetic RMAT/uniform sets used by the reference sweeps."""
    rng = np.random.default_rng(seed)
    nbr, nbc = -(-rows // block), -(-cols // block)
    nblocks = int(nbr * nbc * block_density)
    bidx = rng.choice(nbr * nbc, size=max(nblocks, 1), replace=False)
    br, bc = bidx // nbc, bidx % nbc
    rs, cs = [], []
    for b in range(br.size):
        if intra_density >= 1.0:
            rr, cc = np.meshgrid(np.arange(block), np.arange(block), indexing="ij")
            rr, cc = rr.ravel(), cc.ravel()
        else:
            k = max(1, int(block * block * intra_density))
            flat = rng.choice(block * block, size=k, replace=False)
            rr, cc = flat // block, flat % block
        rs.append(br[b] * block + rr)
        cs.append(bc[b] * block + cc)
    r = np.concatenate(rs)
    c = np.concatenate(cs)
    keep = (r < rows) & (c < cols)
    r, c = r[keep], c[keep]
    v = rng.standard_normal(r.size).astype(DATA)
    m = CSR.from_coo(r, c, v, (rows, cols), sum_duplicates=True)
    if shuffle_rows:
        m = m.scramble(seed=seed + 1)
    return m


def rmat_csr(scale: int, edge_factor: int = 8, seed: int = 0, pattern_only: bool = True) -> CSR:
    """R-MAT style power-law graph (the reference's RMAT N_* synthetic set)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    nnz = n * edge_factor
    a, b, c = 0.57, 0.19, 0.19
    r = np.zeros(nnz, dtype=np.int64)
    cidx = np.zeros(nnz, dtype=np.int64)
    for lvl in range(scale):
        u = rng.random(nnz)
        bit_r = (u >= a + b).astype(np.int64)
        u2 = rng.random(nnz)
        thr = np.where(bit_r == 0, a / (a + b), c / (1 - a - b))
        bit_c = (u2 >= thr).astype(np.int64)
        r = (r << 1) | bit_r
        cidx = (cidx << 1) | bit_c
    v = None if pattern_only else rng.standard_normal(nnz).astype(DATA)
    return CSR.from_coo(r, cidx, v, (n, n), sum_duplicates=True)
