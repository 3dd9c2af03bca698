"""Variable Block Row SpMM through the blocked kernel.

The XLA bucketed path (vbr_xla.py) is the correctness anchor for true VBR
(unequal row-block heights, reference vbr.cpp).  This path pads each
bucket's height to a power of two of at least 16 (the kernel's tile rule),
runs each bucket as one Blocked-ELL product through ``blocked_spmm``
(the Triton kernel on the GPU, XLA elsewhere), then scatters the stripes to
their true row offsets.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..formats.vbr import VBR
from .blocked import blocked_spmm
from .device import BellDevice
from .vbr_xla import VbrDevice


def vbr_kernel_device(vbr: VBR, dtype=jnp.float32) -> VbrDevice:
    """Height-bucketed device layout with kernel-tileable heights."""
    return VbrDevice.from_host(vbr, dtype=dtype, pow2_heights=True)


@partial(jax.jit, static_argnames=("interpret", "accum_dtype"))
def vbr_spmm_pallas(vbr: VbrDevice, B: jax.Array, accum_dtype=jnp.float32,
                    interpret: bool = False) -> jax.Array:
    """C[permuted rows] = A_vbr @ B;  B: [K, N] padded to nbc*bw.

    Per bucket: one blocked product (bh = the bucket's padded height), then
    an XLA scatter-add of the stripes to their true row offsets (one dump
    row swallows the height-padding writes)."""
    out_rows, _, _ = vbr.out_rows_aux
    N = B.shape[1]
    C = jnp.zeros((out_rows + 1, N), dtype=accum_dtype)
    for bucket in vbr.buckets:
        nbb, _, hp, _ = bucket.vals.shape
        nb_row = (bucket.cols_idx >= 0).sum(axis=1).astype(jnp.int32)
        dev = BellDevice(bucket.cols_idx, nb_row, bucket.vals)
        Cb = blocked_spmm(dev, B, out_dtype=accum_dtype,
                          interpret=interpret).reshape(nbb, hp, N)
        offs = jax.lax.broadcasted_iota(jnp.int32, (nbb, hp), 1)
        idx = bucket.row_start[:, None] + offs
        idx = jnp.where(offs < bucket.heights[:, None], idx, out_rows)
        C = C.at[idx.reshape(-1)].add(Cb.reshape(-1, N))
    return C[:out_rows].astype(B.dtype)
