"""Multi-chip blocked SpMM.

New capability over the single-GPU reference (SURVEY §2.7): the blocked
matrix is partitioned across a jax.sharding.Mesh and XLA collectives (NCCL
on the GPU) replace the reference's CUDA-stream concurrency.  Three
layouts:

1. row-sharded  : block-rows sharded, B replicated -> C row-sharded with
                  ZERO communication (pure data parallel).
2. colsplit     : block-COLUMNS sharded (each chip holds a K-slice of A and
                  the matching row-slice of B); partial products reduced with
                  psum_scatter so C lands row-sharded (reduce_scatter overlap).
3. ring         : block-rows sharded, B column-sharded (doesn't fit
                  replicated); B shards rotate around the ring via ppermute
                  while each chip fills the matching column stripe of its C
                  rows — compute overlaps the rotation (the SpMM cousin of
                  ring attention).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..definitions import ceil_div, round_up
from ..formats.bell import BELL
from ..ops.bell_xla import bell_spmm_xla
from ..ops.blocked import blocked_spmm
from ..ops.device import BellDevice


def _local_spmm(dev: BellDevice, B: jax.Array,
                interpret: bool = False) -> jax.Array:
    """Per-shard SpMM body for the sharded layouts: ``blocked_spmm`` (the
    Triton kernel on the GPU, XLA elsewhere) composed with ``shard_map``.
    ``interpret=True`` runs the kernel in the Pallas interpreter, so the
    virtual CPU mesh exercises the shard_map + pallas_call composition."""
    return blocked_spmm(dev, B, interpret=interpret)


# ---------------------------------------------------------------- helpers --
def pad_block_rows(bell: BELL, multiple: int) -> BELL:
    """Pad empty block-rows so n_block_rows % multiple == 0."""
    nbr = bell.n_block_rows
    target = round_up(nbr, multiple)
    if target == nbr:
        return bell
    extra = target - nbr
    return dataclasses.replace(
        bell,
        cols_idx=np.concatenate(
            [bell.cols_idx, np.full((extra, bell.max_nb), -1, bell.cols_idx.dtype)]
        ),
        vals=np.concatenate(
            [bell.vals, np.zeros((extra,) + bell.vals.shape[1:], bell.vals.dtype)]
        ),
        nb_row=np.concatenate([bell.nb_row, np.zeros(extra, bell.nb_row.dtype)]),
        shape=(target * bell.block_row_size, bell.shape[1]),
    )


def split_bell_cols(bell: BELL, n_parts: int):
    """Split by block-column range into n_parts stacked sub-BELLs.

    Returns (cols_idx [P,nbr,w], nb_row [P,nbr], vals [P,nbr,w,bh,bw],
    k_part) where part p holds blocks with jb in [p*k_part, (p+1)*k_part),
    indices remapped to the local range.
    """
    nbc = bell.n_block_cols
    k_part = ceil_div(nbc, n_parts)
    nbr = bell.n_block_rows
    parts_idx, parts_vals, parts_nb = [], [], []
    width = 0
    sel_cache = []
    for p in range(n_parts):
        lo, hi = p * k_part, min((p + 1) * k_part, nbc)
        sel = (bell.cols_idx >= lo) & (bell.cols_idx < hi)
        sel_cache.append((lo, sel))
        width = max(width, int(sel.sum(axis=1).max()) if sel.size else 0)
    width = max(width, 1)
    max_nb = bell.cols_idx.shape[1] if bell.cols_idx.size else 0
    vals2d = bell.vals.reshape((nbr * max_nb,) + bell.vals.shape[2:]) \
        if max_nb else bell.vals
    for lo, sel in sel_cache:
        nb = sel.sum(axis=1).astype(bell.nb_row.dtype)
        # compact each row's selected blocks to the front, preserving order
        # (stable argsort of ~sel), then zero the tail — vectorized over all
        # rows (the per-row flatnonzero loop dominated ingest on big graphs);
        # gathers go through flat integer indices on a 2D view of vals
        # (boolean/elementwise fancy indexing of the 4D array is ~25x slower)
        order = np.argsort(~sel, axis=1, kind="stable")[:, :width]
        in_part = np.arange(width)[None, :] < nb[:, None]
        idx = np.where(
            in_part, np.take_along_axis(bell.cols_idx, order, axis=1) - lo, -1
        ).astype(bell.cols_idx.dtype)
        flat = (np.arange(nbr, dtype=np.int64)[:, None] * max_nb + order)
        vals = vals2d[flat.ravel()].reshape(
            (nbr, width) + bell.vals.shape[2:]).astype(bell.vals.dtype)
        vals *= in_part[:, :, None, None].astype(vals.dtype)
        parts_idx.append(idx)
        parts_vals.append(vals)
        parts_nb.append(nb)
    return (
        np.stack(parts_idx),
        np.stack(parts_nb),
        np.stack(parts_vals),
        k_part,
    )


# ------------------------------------------------------------ row-sharded --
def shard_bell_rowwise(bell: BELL, mesh: Mesh, axis: str = "x", dtype=jnp.float32):
    """Place a BELL on the mesh with block-rows sharded (pads nbr first)."""
    n = mesh.shape[axis]
    bell = pad_block_rows(bell, n)
    dev = BellDevice.from_host(bell, dtype=dtype)
    sh = lambda *spec: NamedSharding(mesh, P(*spec))
    return BellDevice(
        cols_idx=jax.device_put(dev.cols_idx, sh(axis, None)),
        nb_row=jax.device_put(dev.nb_row, sh(axis)),
        vals=jax.device_put(dev.vals, sh(axis, None, None, None)),
    )


def spmm_rowsharded(
    bell_dev: BellDevice,
    B: jax.Array,
    mesh: Mesh | None = None,
    axis: str = "x",
    interpret: bool = False,
) -> jax.Array:
    """C = A @ B with block-rows sharded and B replicated — no collectives.

    Without a mesh, XLA partitions the gather path automatically from the
    operand shardings.  With a mesh, the shard-local compute runs through
    ``_local_spmm`` (the Triton kernel on the GPU) under ``shard_map``."""
    if mesh is None:
        return bell_spmm_xla(bell_dev, B)

    def local(ci, nb, v, b):
        return _local_spmm(BellDevice(ci, nb, v), b, interpret)

    return shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis, None, None, None),
                  P(None, None)),
        out_specs=P(axis, None),
        check_vma=False,
    )(bell_dev.cols_idx, bell_dev.nb_row, bell_dev.vals, B)


# --------------------------------------------- colsplit + reduce_scatter ---
@functools.partial(jax.jit, static_argnames=("mesh", "axis", "interpret"))
def spmm_colsplit_reduce_scatter(
    cols_idx: jax.Array,  # [P, nbr, w] (sharded on P)
    nb_row: jax.Array,    # [P, nbr]
    vals: jax.Array,      # [P, nbr, w, bh, bw]
    B: jax.Array,         # [P, k_part*bw, N] (sharded on P: each chip its K-slice)
    mesh: Mesh,
    axis: str = "x",
    interpret: bool = False,
) -> jax.Array:
    """Partial products on each chip's K-slice, then psum_scatter over
    block-rows: C lands row-sharded.  The reduce_scatter is an XLA
    collective (NCCL on the GPU), replacing the reference's stream-serialized
    accumulation into shared C stripes (cuda_utilities.cpp:665)."""
    n = mesh.shape[axis]
    if cols_idx.shape[1] % n:
        raise ValueError(
            f"{cols_idx.shape[1]} block-rows do not split over {n} devices: "
            f"pad them with pad_block_rows(bell, {n}) before split_bell_cols")

    def local(ci, nb, v, b):
        ci, nb, v, b = ci[0], nb[0], v[0], b[0]
        part = _local_spmm(BellDevice(ci, nb, v), b, interpret)  # [M, N]
        # reduce partials across chips, scattering rows
        return jax.lax.psum_scatter(
            part.reshape(n, part.shape[0] // n, part.shape[1]),
            axis,
            scatter_dimension=0,
            tiled=False,
        )

    spec_in = (
        P(axis, None, None),
        P(axis, None),
        P(axis, None, None, None, None),
        P(axis, None, None),
    )
    return shard_map(
        local, mesh=mesh, in_specs=spec_in, out_specs=P(axis, None), check_vma=False
    )(cols_idx, nb_row, vals, B).reshape(-1, B.shape[-1])


# ------------------------------------------------------------------- ring --
@functools.partial(jax.jit, static_argnames=("mesh", "axis", "interpret"))
def spmm_ring(
    bell_dev: BellDevice,  # row-sharded on axis
    B: jax.Array,          # [K, N] sharded over N on axis
    mesh: Mesh,
    axis: str = "x",
    interpret: bool = False,
) -> jax.Array:
    """Row-sharded A x column-sharded B: B shards rotate via ppermute; each
    step fills one column stripe of the local C rows while the next B shard
    is in flight.  Memory per chip: |B|/n instead of |B|."""
    n = mesh.shape[axis]
    N = B.shape[1]
    if N % n:
        raise ValueError(f"B's {N} columns are not divisible by the {n} "
                         f"devices of the ring")
    n_chunk = N // n

    def local(ci, nb, v, b_local):
        me = jax.lax.axis_index(axis)
        sub = BellDevice(ci, nb, v)
        M_local = ci.shape[0] * v.shape[2]
        C = jnp.zeros((M_local, N), dtype=b_local.dtype)

        def step(s, carry):
            b_cur, C = carry
            # chunk currently held started at device (me + s) % n
            src = jax.lax.rem(me + s, n)
            Cpart = _local_spmm(sub, b_cur, interpret)
            C = jax.lax.dynamic_update_slice(C, Cpart, (0, src * n_chunk))
            b_nxt = jax.lax.ppermute(
                b_cur, axis, perm=[((i + 1) % n, i) for i in range(n)]
            )
            return b_nxt, C

        _, C = jax.lax.fori_loop(0, n, step, (b_local, C))
        return C

    return shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis, None, None, None), P(None, axis)),
        out_specs=P(axis, None),
        check_vma=False,
    )(bell_dev.cols_idx, bell_dev.nb_row, bell_dev.vals, B)


# --------------------------------------------------- fine-grained (dedup) ---
@dataclasses.dataclass
class ShardedDedup:
    """Row-tile-sharded DedupDevice arrays, leading mesh dim P.

    Each shard owns an equal slice of row tiles with its own chunk-padded
    slot stream (padded to the largest shard with dead chunks owned by an
    out-of-range tile); gidx references the FULL column space, so B stays
    replicated and the layout needs no collectives — the fine-grained
    cousin of ``spmm_rowsharded``."""

    gidx: jax.Array        # int32 [P, Spad]
    W: jax.Array           # [P, Spad, R]
    chunk_tile: jax.Array  # int32 [P, Spad // chunk]
    rows: int              # true (unpadded) global row count
    tile_rows: int
    chunk: int


def shard_dedup_rowwise(cmat, mesh: Mesh, axis: str = "x",
                        dtype=jnp.bfloat16, tile_rows: int = 128,
                        chunk: int = 256) -> ShardedDedup:
    """Partition rows evenly (tile-aligned) and pack each part as its own
    DedupDevice; dedup happens within each shard's tiles exactly as in the
    single-chip packing."""
    from ..formats.csr import CSR
    from ..ops.fine import DedupDevice

    n = mesh.shape[axis]
    rows_per = round_up(ceil_div(cmat.rows, n), tile_rows)
    S = cmat.to_scipy()
    devs = []
    for i in range(n):
        lo = min(i * rows_per, cmat.rows)
        hi = min(lo + rows_per, cmat.rows)
        part = CSR.from_scipy(S[lo:hi]).with_shape((rows_per, cmat.cols))
        devs.append(DedupDevice.from_csr(part, dtype=dtype,
                                         tile_rows=tile_rows, chunk=chunk))
    smax = max(d.n_slots for d in devs)
    ntl = rows_per // tile_rows

    def padslots(a, fill, n_to):
        a = np.asarray(a)
        return np.pad(a, [(0, n_to - a.shape[0])] + [(0, 0)] * (a.ndim - 1),
                      constant_values=fill)

    gidx = np.stack([padslots(d.gidx, 0, smax) for d in devs])
    W = np.stack([padslots(np.asarray(d.W, np.float32), 0, smax)
                  for d in devs])
    # dead chunks point past the last local tile: segment_sum drops them
    ctile = np.stack([padslots(d.chunk_tile, ntl, smax // chunk)
                      for d in devs])
    sh = lambda *spec: NamedSharding(mesh, P(*spec))
    return ShardedDedup(
        gidx=jax.device_put(jnp.asarray(gidx), sh(axis, None)),
        W=jax.device_put(jnp.asarray(W, dtype=dtype), sh(axis, None, None)),
        chunk_tile=jax.device_put(jnp.asarray(ctile), sh(axis, None)),
        rows=cmat.rows,
        tile_rows=tile_rows,
        chunk=chunk,
    )


def dedup_spmm_rowsharded(sdev: ShardedDedup, B: jax.Array,
                          mesh: Mesh, axis: str = "x") -> jax.Array:
    """C = A @ B through the dedup path with row tiles sharded and B
    replicated — no collectives; each device combines its resident
    slots."""
    from ..ops.fine import dedup_combine

    R, C = sdev.tile_rows, sdev.chunk
    n = mesh.shape[axis]
    Mloc = round_up(ceil_div(sdev.rows, n), R)

    def local(gidx, W, ctile, b):
        gidx, W, ctile = gidx[0], W[0], ctile[0]
        bg = b[gidx].astype(W.dtype)
        return dedup_combine(ctile, W, bg, Mloc, R=R, C=C).astype(b.dtype)

    full = shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None, None), P(axis, None),
                  P(None, None)),
        out_specs=P(axis, None),
        check_vma=False,
    )(sdev.gidx, sdev.W, sdev.chunk_tile, B)
    return full[: sdev.rows]
