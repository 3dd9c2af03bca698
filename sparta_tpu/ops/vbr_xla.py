"""Variable Block Row SpMM on device: height-bucketed batched matmuls.

True VBR (unequal row-block heights, reference vbr.cpp) fights XLA's static
shapes; the answer here is bucketing: block-rows are grouped by padded
height (next multiple of ``sublane``, or the next power of two of at least
16 for the blocked kernel, ops/vbr_pallas.py), each bucket is a rectangular
Blocked-ELL batch handled by one dot_general sweep, and the stripes scatter
back to their true row offsets.  The reference's GPU numbers all use
force_fixed_size anyway (SURVEY §7 hard parts) — this path exists for parity
with the general ``-M 4/6`` semantics at full fidelity.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..definitions import round_up, to_device
from ..formats.vbr import VBR


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class VbrBucket:
    """Block-rows of one padded height, Blocked-ELL layout."""

    cols_idx: jax.Array   # int32 [nb_rows, max_nb], -1 padded
    vals: jax.Array       # [nb_rows, max_nb, h_pad, bw]
    row_start: jax.Array  # int32 [nb_rows] — output row offset (permuted space)
    heights: jax.Array    # int32 [nb_rows] — true heights

    def tree_flatten(self):
        return (self.cols_idx, self.vals, self.row_start, self.heights), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class VbrDevice:
    buckets: list
    out_rows_aux: tuple  # (out_rows, block_col_size, n_block_cols) — static

    def tree_flatten(self):
        return (self.buckets,), self.out_rows_aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux)

    @property
    def out_rows(self) -> int:
        return self.out_rows_aux[0]

    @classmethod
    def from_host(cls, vbr: VBR, dtype=jnp.float32, sublane: int = 8,
                  pow2_heights: bool = False) -> "VbrDevice":
        heights = vbr.heights
        if pow2_heights:
            h_pads = np.array([max(16, 1 << (int(h) - 1).bit_length())
                               for h in heights], dtype=np.int64)
        else:
            h_pads = np.maximum(round_up(1, sublane), (np.ceil(
                heights / sublane) * sublane).astype(np.int64))
        jp = vbr.jab_ptr()
        bw = vbr.block_col_size
        buckets = []
        for hp in np.unique(h_pads):
            sel = np.flatnonzero(h_pads == hp)
            max_nb = max(int(vbr.nzcount[sel].max()) if sel.size else 0, 1)
            cols = np.full((sel.size, max_nb), -1, dtype=np.int32)
            vals = np.zeros((sel.size, max_nb, int(hp), bw), dtype=np.float32)
            for t, ib in enumerate(sel):
                n = int(vbr.nzcount[ib])
                h = int(heights[ib])
                cols[t, :n] = vbr.jab[jp[ib] : jp[ib] + n]
                for k in range(n):
                    b = jp[ib] + k
                    vals[t, k, :h] = vbr.mab[
                        vbr.block_ptr[b] : vbr.block_ptr[b + 1]
                    ].reshape(h, bw)
            buckets.append(
                VbrBucket(
                    cols_idx=jnp.asarray(cols),
                    vals=to_device(vals, dtype),
                    row_start=jnp.asarray(vbr.row_part[sel], dtype=jnp.int32),
                    heights=jnp.asarray(heights[sel], dtype=jnp.int32),
                )
            )
        return cls(buckets, (vbr.shape[0], bw, vbr.block_cols))


@partial(jax.jit, static_argnames=("accum_dtype",))
def vbr_spmm_xla(vbr: VbrDevice, B: jax.Array, accum_dtype=jnp.float32) -> jax.Array:
    """C[permuted rows] = A_vbr @ B;  B: [K, N] padded to nbc*bw."""
    out_rows, bw, _ = vbr.out_rows_aux
    N = B.shape[1]
    Bt = B.reshape(-1, bw, N)
    # one dump row swallows the height-padding writes
    C = jnp.zeros((out_rows + 1, N), dtype=accum_dtype)

    for bucket in vbr.buckets:
        nbb, max_nb, hp, _ = bucket.vals.shape
        safe_idx = jnp.maximum(bucket.cols_idx, 0)

        def step(acc, k, bucket=bucket, safe_idx=safe_idx):
            stripes = Bt[safe_idx[:, k]]  # [nbb, bw, N]
            prod = jax.lax.dot_general(
                bucket.vals[:, k], stripes,
                dimension_numbers=(((2,), (1,)), ((0,), (0,))),
                preferred_element_type=accum_dtype,
            )
            return acc + prod, None

        acc0 = jnp.zeros((nbb, hp, N), dtype=accum_dtype)
        acc, _ = jax.lax.scan(step, acc0, jnp.arange(max_nb))
        # scatter stripes to true row offsets; pad rows -> dump row
        offs = jax.lax.broadcasted_iota(jnp.int32, (nbb, hp), 1)
        idx = bucket.row_start[:, None] + offs
        idx = jnp.where(offs < bucket.heights[:, None], idx, out_rows)
        C = C.at[idx.reshape(-1)].add(acc.reshape(-1, N))

    return C[:out_rows].astype(B.dtype)


@partial(jax.jit, static_argnames=("accum_dtype",))
def vbr_spmm_xla_ba(vbr: VbrDevice, B: jax.Array, accum_dtype=jnp.float32) -> jax.Array:
    """Inverted operand order C = B @ A_vbr (reference cublas_blockmat_multiplyBA
    generalized to variable heights);  B: [N, M_permuted] -> C: [N, nbc*bw]."""
    out_rows, bw, nbc = vbr.out_rows_aux
    N = B.shape[0]
    C = jnp.zeros((nbc, N, bw), dtype=accum_dtype)
    for bucket in vbr.buckets:
        nbb, max_nb, hp, _ = bucket.vals.shape
        offs = jax.lax.broadcasted_iota(jnp.int32, (nbb, hp), 1)
        idx = jnp.where(offs < bucket.heights[:, None],
                        bucket.row_start[:, None] + offs, out_rows)
        Bpad = jnp.pad(B, ((0, 0), (0, 1)))
        Bg = Bpad[:, idx.reshape(-1)].reshape(N, nbb, hp).transpose(1, 0, 2)
        safe_idx = jnp.maximum(bucket.cols_idx, 0)

        def step(acc, k, bucket=bucket, Bg=Bg, safe_idx=safe_idx):
            prod = jax.lax.dot_general(
                Bg, bucket.vals[:, k],
                dimension_numbers=(((2,), (1,)), ((0,), (0,))),
                preferred_element_type=accum_dtype,
            )  # [nbb, N, bw]
            return acc.at[safe_idx[:, k]].add(prod), None

        C, _ = jax.lax.scan(step, C, jnp.arange(max_nb))
    return C.transpose(1, 0, 2).reshape(N, nbc * bw).astype(B.dtype)
