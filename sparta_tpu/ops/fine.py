"""Fine-grained (non-blocked) sparse SpMM for matrices too sparse to block.

The answer to the reference's cuSPARSE CSR SpMM kernel (cusparse_gemm_custom,
cuda_utilities.cpp:1251-1431) for power-law graphs and other low-fill
patterns where 128x128 blocking pads 100-1000x.  All three layouts are
plain XLA; the GPU has a native scatter-add, so the row combine is a sorted
``segment_sum`` rather than a hand-written kernel.

1. ``FineDevice`` + ``fine_spmm``: nonzeros in CSR order; one fused
   gather-and-scale of B rows produces per-nonzero contributions, and a
   sorted ``segment_sum`` over their row ids combines them.
2. ``DedupDevice`` + ``dedup_spmm``: per ``tile_rows``-row output tile,
   each distinct column is gathered once; a dense per-slot weight row W
   folds the values and the slot->row scatter together.  Each tile's slots
   are padded to a multiple of ``chunk``, so the combine is one batched dot
   over [chunk, tile_rows] x [chunk, N] slot chunks followed by a sorted
   ``segment_sum`` of the chunk partials onto their tiles.
3. ``FellDevice`` + ``fell_spmm``: rows split into width-W virtual rows
   (row splitting for power-law hubs); W fused full-row gathers summed,
   then a sorted ``segment_sum`` over nnz/W virtual rows.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..definitions import to_device
from ..formats.csr import CSR

WIDTHS = (4, 8, 16, 32, 64)


def _quantize_cols(B: jax.Array):
    """Per-column symmetric int8 quantization -> (int8 [K, N], f32 [1, N])."""
    Bf = B.astype(jnp.float32)
    amax = jnp.max(jnp.abs(Bf), axis=0, keepdims=True)
    scale = jnp.where(amax > 0, amax, 1.0) / 127.0
    return jnp.round(Bf / scale).astype(jnp.int8), scale


# ---------------------------------------------------------------------------
# FineDevice: gather + sorted segment-sum combine
# ---------------------------------------------------------------------------

def mask_combine(rows: jax.Array, contribs: jax.Array, M: int) -> jax.Array:
    """Per-nonzero contributions [S, N] -> [M, N] row sums.  ``rows`` [S]
    is sorted (CSR order); ids outside [0, M) are dropped."""
    return jax.ops.segment_sum(contribs, rows, num_segments=M,
                               indices_are_sorted=True)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class FineDevice:
    """CSR-ordered nonzeros: column, value and (sorted) row of each."""

    cols: jax.Array  # int32 [S]
    vals: jax.Array  # [S]
    rows_idx: jax.Array  # int32 [S], non-decreasing
    rows: int  # static: output row count

    def tree_flatten(self):
        return (self.cols, self.vals, self.rows_idx), self.rows

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, rows=aux)

    @property
    def n_slots(self) -> int:
        return self.cols.shape[0]

    @classmethod
    def from_csr(cls, cmat: CSR, dtype=jnp.bfloat16) -> "FineDevice":
        rows = np.repeat(np.arange(cmat.rows, dtype=np.int32), cmat.row_nnz)
        cols, vals = np.asarray(cmat.indices, np.int32), cmat.values()
        if cmat.nnz == 0:  # one dead slot keeps every shape non-empty
            rows, cols = np.full(1, cmat.rows, np.int32), np.zeros(1, np.int32)
            vals = np.zeros(1, np.float32)
        return cls(cols=jnp.asarray(cols), vals=to_device(vals, dtype),
                   rows_idx=jnp.asarray(rows), rows=cmat.rows)


@functools.partial(jax.jit, static_argnames=("b_int8",))
def fine_spmm(dev: FineDevice, B: jax.Array, b_int8: bool = False):
    """C = A @ B for a FineDevice-packed A.  B [K, N]; returns [rows, N].
    ``b_int8`` gathers a per-column int8 quantization of B (half the gather
    bytes, ~1e-3 relative error); the scale fuses into the multiply."""
    if b_int8:
        bq, scale = _quantize_cols(B)
        g = bq[dev.cols].astype(dev.vals.dtype) * scale.astype(dev.vals.dtype)
    else:
        g = B[dev.cols].astype(dev.vals.dtype)
    contrib = (dev.vals[:, None] * g).astype(jnp.float32)
    return mask_combine(dev.rows_idx, contrib, dev.rows).astype(B.dtype)


# ---------------------------------------------------------------------------
# DedupDevice: per-tile distinct-column gather + batched-dot combine
# ---------------------------------------------------------------------------

def dedup_combine(chunk_tile: jax.Array, W: jax.Array, Bg: jax.Array,
                  M: int, R: int, C: int, scale=None) -> jax.Array:
    """[S, R] weights x gathered B rows [S, N] -> [M, N] row sums.

    S is a multiple of ``C``; slot chunk c belongs to output tile
    ``chunk_tile[c]`` (non-decreasing).  One batched dot gives each chunk's
    [R, N] partial; a sorted segment-sum adds the partials of each tile.
    ``scale`` [1, N] dequantizes an int8-gathered ``Bg`` at the end."""
    nch = W.shape[0] // C
    N = Bg.shape[1]
    part = jnp.einsum("scr,scn->srn", W.reshape(nch, C, R),
                      Bg.astype(W.dtype).reshape(nch, C, N),
                      preferred_element_type=jnp.float32)
    out = jax.ops.segment_sum(part, chunk_tile, num_segments=M // R,
                              indices_are_sorted=True).reshape(M, N)
    return out if scale is None else out * scale


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DedupDevice:
    """Distinct (tile, column) pairs, each tile's slots padded to a
    ``chunk`` multiple, with a dense per-slot weight row over the tile's R
    rows.

    On power-law graphs 30-50% of nonzeros share a (tile, column) pair
    with another nonzero (hub columns); deduping cuts the gather by that
    fraction, and the W dot replaces the value multiply and the row
    combine."""

    gidx: jax.Array        # int32 [S] column of each slot (0 on dead)
    W: jax.Array           # [S, R] weights (0 on dead slots)
    chunk_tile: jax.Array  # int32 [S // chunk] owning tile of each chunk
    rows: int              # static: true output row count
    tile_rows: int = 128
    chunk: int = 256

    def tree_flatten(self):
        return ((self.gidx, self.W, self.chunk_tile),
                (self.rows, self.tile_rows, self.chunk))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, rows=aux[0], tile_rows=aux[1], chunk=aux[2])

    @property
    def n_slots(self) -> int:
        return self.gidx.shape[0]

    @property
    def padded_rows(self) -> int:
        return -(-self.rows // self.tile_rows) * self.tile_rows

    @classmethod
    def from_csr(cls, cmat: CSR, dtype=jnp.bfloat16, tile_rows: int = 128,
                 chunk: int = 256) -> "DedupDevice":
        R = tile_rows
        rows = np.repeat(np.arange(cmat.rows, dtype=np.int64), cmat.row_nnz)
        key = (rows // R) * np.int64(cmat.cols) + cmat.indices
        uniq, inv = np.unique(key, return_inverse=True)
        u_tile = (uniq // max(cmat.cols, 1)).astype(np.int64)
        ntiles = max(-(-cmat.rows // R), 1)
        per_tile = np.bincount(u_tile, minlength=ntiles)
        nchunks = np.maximum(-(-per_tile // chunk), 1)  # >= 1 chunk per tile
        start = np.zeros(ntiles + 1, dtype=np.int64)
        np.cumsum(nchunks * chunk, out=start[1:])
        first = np.zeros(ntiles + 1, dtype=np.int64)
        np.cumsum(per_tile, out=first[1:])
        pos = start[u_tile] + np.arange(uniq.size) - first[u_tile]
        total = int(start[-1])
        gidx = np.zeros(total, dtype=np.int32)
        gidx[pos] = (uniq % max(cmat.cols, 1)).astype(np.int32)
        W = np.zeros((total, R), dtype=np.float32)
        np.add.at(W, (pos[inv], rows % R), cmat.values())
        return cls(
            gidx=jnp.asarray(gidx),
            # upload f32 and convert on device: numpy's elementwise bf16
            # cast is slow on large W
            W=jnp.asarray(W).astype(dtype),
            chunk_tile=jnp.asarray(np.repeat(
                np.arange(ntiles, dtype=np.int32), nchunks)),
            rows=cmat.rows,
            tile_rows=R,
            chunk=chunk,
        )


@functools.partial(jax.jit, static_argnames=("b_int8",))
def dedup_spmm(dev: DedupDevice, B: jax.Array,
               b_int8: bool = False) -> jax.Array:
    """C = A @ B for a DedupDevice-packed A.  B [K, N]; returns [rows, N].
    ``b_int8`` gathers a per-column int8 quantization of B (half the gather
    bytes, ~1e-3 relative error), dequantized after the combine."""
    scale = None
    if b_int8:
        bq, scale = _quantize_cols(B)
        bg = bq[dev.gidx]
    else:
        bg = B[dev.gidx].astype(dev.W.dtype)  # distinct rows only
    out = dedup_combine(dev.chunk_tile, dev.W, bg, dev.padded_rows,
                        R=dev.tile_rows, C=dev.chunk, scale=scale)
    return out[: dev.rows].astype(B.dtype)


def dedup_pair_from_csr(cmat: CSR, dtype=jnp.bfloat16, tile_rows: int = 128,
                        chunk: int = 256):
    """(forward, transpose) DedupDevice pair for a fixed sparse operand —
    the training-time packing: C = A @ B forward, dB = A^T @ dC backward."""
    fwd = DedupDevice.from_csr(cmat, dtype=dtype, tile_rows=tile_rows,
                               chunk=chunk)
    rows = np.repeat(np.arange(cmat.rows, dtype=np.int64), cmat.row_nnz)
    mt = CSR.from_coo(cmat.indices, rows, cmat.values(),
                      (cmat.cols, cmat.rows))
    bwd = DedupDevice.from_csr(mt, dtype=dtype, tile_rows=tile_rows,
                               chunk=chunk)
    return fwd, bwd


@jax.custom_vjp
def dedup_spmm_ad(dev: DedupDevice, devT: DedupDevice,
                  B: jax.Array) -> jax.Array:
    """Differentiable C = A @ B through the dedup path (gradient flows to B
    only; the sparse operand is static structure, as in a GCN adjacency).
    ``devT`` packs A^T so the backward pass is the same product:
    dB = A^T @ dC."""
    return dedup_spmm(dev, B)


def _dedup_ad_fwd(dev, devT, B):
    # zero-size token carries B's dtype through the residuals
    return dedup_spmm(dev, B), (devT, jnp.zeros((0,), B.dtype))


def _dedup_ad_bwd(res, dC):
    devT, tok = res
    return None, None, dedup_spmm(devT, dC.astype(tok.dtype))


dedup_spmm_ad.defvjp(_dedup_ad_fwd, _dedup_ad_bwd)


# ---------------------------------------------------------------------------
# FellDevice: width-W virtual-row ELL
# ---------------------------------------------------------------------------

def fell_slots(row_nnz: np.ndarray, w: int) -> tuple[int, int]:
    """(n_virt, padded_slots) after splitting rows into width-``w`` pieces.
    Empty rows produce no virtual rows."""
    nseg = -(-row_nnz.astype(np.int64) // w)
    n_virt = int(nseg.sum())
    return n_virt, n_virt * w


def choose_width(row_nnz: np.ndarray) -> int:
    """The W with the least work: padded gather slots plus the virtual rows
    the segment-sum combines (a count of operations, not a device rate)."""
    return min(WIDTHS, key=lambda w: sum(fell_slots(row_nnz, w)))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class FellDevice:
    """Virtual-row ELL device arrays.

    cols/vals are [n_virt, W] (0-padded); vr_rows [n_virt] is each virtual
    row's owner row, non-decreasing (CSR order)."""

    cols: jax.Array      # int32 [n_virt, W]
    vals: jax.Array      # [n_virt, W]
    vr_rows: jax.Array   # int32 [n_virt]
    rows: int            # static: output row count

    def tree_flatten(self):
        return (self.cols, self.vals, self.vr_rows), self.rows

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, rows=aux)

    @property
    def width(self) -> int:
        return self.cols.shape[1]

    @classmethod
    def from_csr(cls, cmat: CSR, width: int | None = None,
                 dtype=jnp.float32) -> "FellDevice":
        """Vectorized build — no per-row python loops."""
        L = cmat.row_nnz.astype(np.int64)
        w = width or choose_width(L)
        nseg = -(-L // w)
        n_virt = max(int(nseg.sum()), 1)
        cols = np.zeros((n_virt, w), dtype=np.int32)
        vals = np.zeros((n_virt, w), dtype=np.float32)
        # destination slot of each nonzero: rows occupy contiguous virtual
        # rows, nonzeros fill them in CSR order
        seg_start = np.zeros(cmat.rows + 1, dtype=np.int64)
        np.cumsum(nseg, out=seg_start[1:])
        off_in_row = np.arange(cmat.nnz, dtype=np.int64) - np.repeat(
            cmat.indptr[:-1].astype(np.int64), L)
        dest = np.repeat(seg_start[:-1] * w, L) + off_in_row
        cols.reshape(-1)[dest] = cmat.indices
        vals.reshape(-1)[dest] = cmat.values()
        vr_rows = np.zeros(n_virt, dtype=np.int32)
        if int(nseg.sum()):
            vr_rows = np.repeat(
                np.arange(cmat.rows, dtype=np.int32), nseg)
        return cls(jnp.asarray(cols), to_device(vals, dtype),
                   jnp.asarray(vr_rows), cmat.rows)


@functools.partial(jax.jit, static_argnames=("rows",))
def _fell_spmm(cols, vals, vr_rows, rows, B):
    w = cols.shape[1]

    # W fused gather-multiply-adds: each step gathers full rows of B and XLA
    # fuses them into one loop, no [n_virt, W, N] intermediate.  Each term
    # multiplies in the storage dtype but ACCUMULATES in fp32: W-deep bf16
    # adds plus a bf16 segment-sum exceed the 1e-2 matched-accuracy bar on
    # power-law graphs.
    def term(i):
        return (vals[:, i: i + 1]
                * B[cols[:, i]].astype(vals.dtype)).astype(jnp.float32)

    acc = term(0)
    for i in range(1, w):
        acc += term(i)
    # sorted segment-sum over n_virt ~= nnz/W rows
    out = jax.ops.segment_sum(acc, vr_rows, num_segments=rows,
                              indices_are_sorted=True)
    return out.astype(B.dtype)


def fell_spmm(dev: FellDevice, B: jax.Array) -> jax.Array:
    """C = A @ B for a FELL-packed A. B is [K, N]; returns [rows, N]."""
    return _fell_spmm(dev.cols, dev.vals, dev.vr_rows, dev.rows, B)
