"""Blocked-ELL SpMM, pure-XLA path (gather + batched matmul).

The plain-XLA counterpart of the reference's cuSPARSE Blocked-ELL backend
(cuda_utilities.cpp:1497-1653): instead of a library call, a gather of B row
stripes by block-column index followed by a batched dot_general.  The path
on every backend but the GPU, and the correctness anchor for the Triton
kernel (ops/blocked.py).

Padding entries (cols_idx == -1) carry zero values and gather row-stripe 0;
they are masked anyway so their gradients stay zero.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .device import BellDevice


@partial(jax.jit, static_argnames=("accum_dtype",))
def bell_spmm_xla(bell: BellDevice, B: jax.Array, accum_dtype=jnp.float32,
                  stripe_scale=None) -> jax.Array:
    """C[perm rows] = A_bell @ B.   B: [K, N] with K == nbc*bw.

    Loops over the block ordinal k with lax.scan so only one gathered
    [nbr, bw, N] stripe batch is live at a time (the full
    [nbr, max_nb, bw, N] gather would not fit device memory at large N).

    Float operands return B's dtype.  ``accum_dtype=None`` returns the
    accumulator itself, as the quantized callers want: int32 for int8
    operands, float32 otherwise; fp8 operands are widened to bf16 (exactly)
    as they are gathered.  ``stripe_scale`` [nbc, N] scales each block's
    product by its B stripe's per-column dequant factor.
    """
    nbr, max_nb, bh, bw = bell.vals.shape
    N = B.shape[1]
    vals = bell.vals
    if vals.dtype.itemsize == 1 and not jnp.issubdtype(vals.dtype,
                                                       jnp.integer):
        vals, B = vals.astype(jnp.bfloat16), B.astype(jnp.bfloat16)
    acc_dtype = accum_dtype or (
        jnp.int32 if jnp.issubdtype(vals.dtype, jnp.integer)
        and stripe_scale is None else jnp.float32)
    Bt = B.reshape(-1, bw, N)  # [nbc, bw, N]
    safe_idx = jnp.maximum(bell.cols_idx, 0)  # [nbr, max_nb]
    # mask padding entries: their stored values are zero, but masking also
    # keeps gradients w.r.t. padding values at zero under autodiff
    valid = bell.cols_idx >= 0

    def term(k):
        stripes = Bt[safe_idx[:, k]]  # [nbr, bw, N] gather
        t = jax.lax.dot_general(
            jnp.where(valid[:, k, None, None], vals[:, k], 0),
            stripes,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=acc_dtype,
        )  # [nbr, bh, N]
        if stripe_scale is not None:
            t = t.astype(jnp.float32) * stripe_scale[safe_idx[:, k]][:, None]
        return t

    def step(acc, k):
        return acc + term(k), None

    # seed the carry with term 0 (not a fresh zeros buffer): under
    # shard_map the terms are device-varying and a replicated zero carry
    # trips the varying-manual-axes check in the scan
    acc, _ = jax.lax.scan(step, term(0), jnp.arange(1, max_nb))
    acc = acc.reshape(nbr * bh, N)
    return acc if accum_dtype is None else acc.astype(B.dtype)


@partial(jax.jit, static_argnames=("accum_dtype",))
def bell_spmm_xla_unrolled(
    bell: BellDevice, B: jax.Array, accum_dtype=jnp.float32
) -> jax.Array:
    """Single fused gather+einsum variant — fastest when the gathered
    [nbr, max_nb, bw, N] tensor fits memory (small N or few blocks)."""
    nbr, max_nb, bh, bw = bell.vals.shape
    N = B.shape[1]
    Bt = B.reshape(-1, bw, N)
    stripes = Bt[jnp.maximum(bell.cols_idx, 0)]  # [nbr, max_nb, bw, N]
    acc = jnp.einsum(
        "rkab,rkbn->ran",
        bell.vals,
        stripes,
        preferred_element_type=accum_dtype,
    )
    return acc.reshape(nbr * bh, N).astype(B.dtype)


@partial(jax.jit, static_argnames=("n_block_cols", "accum_dtype"))
def bell_spmm_xla_ba(
    bell: BellDevice, B: jax.Array, n_block_cols: int, accum_dtype=jnp.float32
) -> jax.Array:
    """Inverted operand order C = B · A (reference cublas_blockmat_multiplyBA,
    cuda_utilities.cpp:553-721): each A-block (ib, jb) maps B's row-block
    stripe ib into C's column stripe jb — a batched matmul followed by a
    scatter-add over block-column ids (duplicate targets accumulate, the
    structural analogue of the reference's per-block-column stream ownership).

    B: [N, M] with M == nbr*bh;  returns C: [N, n_block_cols*bw].
    """
    nbr, max_nb, bh, bw = bell.vals.shape
    N = B.shape[0]
    Br = B.reshape(N, nbr, bh).transpose(1, 0, 2)  # [nbr, N, bh]
    safe_idx = jnp.maximum(bell.cols_idx, 0)

    def step(C, k):
        prod = jax.lax.dot_general(
            Br,
            bell.vals[:, k],
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=accum_dtype,
        )  # [nbr, N, bw]
        return C.at[safe_idx[:, k]].add(prod), None

    C0 = jnp.zeros((n_block_cols, N, bw), dtype=accum_dtype)
    C, _ = jax.lax.scan(step, C0, jnp.arange(max_nb))
    return C.transpose(1, 0, 2).reshape(N, n_block_cols * bw).astype(B.dtype)
