"""Differentiable blocked SpMM: routed forward, XLA backward.

The blocked kernel has no VJP of its own; this wraps the routed forward
(``blocked_spmm``: the Triton kernel on the GPU, XLA elsewhere) with a
custom_vjp whose backward pass reuses the gather/scatter structure:

  C = A @ B            (A blocked, values V[r,k] at block-cols J[r,k])
  dV[r,k] = dC_r @ B_{J[r,k]}^T      (per-block outer product, batched dot)
  dB_{J[r,k]} += V[r,k]^T @ dC_r     (scatter-add over block columns)

so the block-sparse transformer trains through the fast kernel.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .blocked import blocked_spmm
from .device import BellDevice


@partial(jax.custom_vjp, nondiff_argnums=(4,))
def bell_spmm(cols_idx, nb_row, vals, B, interpret: bool = False):
    """C = A @ B for A in Blocked-ELL (cols_idx, nb_row, vals).
    ``interpret`` runs the kernel in the Pallas interpreter (tests)."""
    return blocked_spmm(BellDevice(cols_idx, nb_row, vals), B,
                        interpret=interpret)


def _fwd(cols_idx, nb_row, vals, B, interpret):
    out = bell_spmm(cols_idx, nb_row, vals, B, interpret)
    return out, (cols_idx, nb_row, vals, B)


def _bwd(interpret, res, dC):
    cols_idx, nb_row, vals, B = res
    nbr, max_nb, bh, bw = vals.shape
    N = B.shape[1]
    dC = dC.astype(jnp.float32)
    dCr = dC.reshape(nbr, bh, N)
    Bt = B.astype(jnp.float32).reshape(-1, bw, N)
    safe_idx = jnp.maximum(cols_idx, 0)
    valid = (cols_idx >= 0).astype(jnp.float32)

    # dV[r,k] = dC_r @ B_{J[r,k]}^T
    def dv_step(_, k):
        stripes = Bt[safe_idx[:, k]]  # [nbr, bw, N]
        dv = jax.lax.dot_general(
            dCr, stripes,
            dimension_numbers=(((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )  # [nbr, bh, bw]
        return None, dv * valid[:, k, None, None]

    _, dV = jax.lax.scan(dv_step, None, jnp.arange(max_nb))
    dV = jnp.moveaxis(dV, 0, 1).astype(vals.dtype)  # [nbr, max_nb, bh, bw]

    # dB: scatter-add V^T @ dC_r into block-row stripes of B
    def db_step(acc, k):
        contrib = jax.lax.dot_general(
            vals[:, k].astype(jnp.float32), dCr,
            dimension_numbers=(((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )  # [nbr, bw, N]
        contrib = contrib * valid[:, k, None, None]
        return acc.at[safe_idx[:, k]].add(contrib), None

    dBt0 = jnp.zeros_like(Bt)
    dBt, _ = jax.lax.scan(db_step, dBt0, jnp.arange(max_nb))
    dB = dBt.reshape(B.shape).astype(B.dtype)
    return None, None, dV, dB


bell_spmm.defvjp(_fwd, _bwd)
