"""Blocked-ELL SpMM: one Pallas kernel through Triton, and the one routing
function that decides where it runs.

The reference ran one cuBLAS GEMM per nonzero block over CUDA streams
(cuda_utilities.cpp:39-209).  Here a single kernel walks each block-row:

- grid (block-row tile, N tile); a loop inside the program runs over the
  row's ``nb_row[i]`` blocks and reads their column ids itself;
- each step loads one A block tile [bm, bw] and the matching B stripe
  [bw, tn] and accumulates with ``pl.dot`` (fp32, or int32 for int8);
  Triton's software pipelining (``NUM_STAGES``) overlaps the loads;
- an optional epilogue applies per-row / per-column scales, a bias and a
  ReLU before the single store of the output tile.

The plain version, ``bell_spmm_xla``, writes every gathered B stripe to
device memory before its batched dot; fusing the gather into the product
saves those bytes.  Padding entries (cols_idx == -1) lie past ``nb_row``
and are never visited.
"""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .bell_xla import bell_spmm_xla
from .device import BellDevice

# the output tile is [TILE_M, TILE_N] (narrower where N is); one launch
# configuration serves every dtype, and per-dtype tiles are open work
TILE_N = 128
TILE_M = 64
NUM_WARPS = 4
NUM_STAGES = 3


_FORCED_XLA = False


def _pow2_at_least_16(x: int) -> bool:
    return x >= 16 and x & (x - 1) == 0


@contextlib.contextmanager
def xla_route():
    """Trace blocked SpMMs on the plain XLA path, whatever the backend — the
    comparison route for checking the kernel inside a whole model.  The
    choice is made when a function is traced, so jit a fresh function
    under this context rather than re-calling one already compiled."""
    global _FORCED_XLA
    prev, _FORCED_XLA = _FORCED_XLA, True
    try:
        yield
    finally:
        _FORCED_XLA = prev


def spmm_route(bh: int, bw: int, interpret: bool = False) -> str:
    """The one place that decides which blocked-SpMM path runs.

    ``"triton"``: the Pallas kernel, compiled for the GPU, or run by the
    Pallas interpreter when a caller (a test) passes ``interpret=True``.
    ``"xla"``: the plain gather + batched-dot path, on every other backend,
    under :func:`xla_route`, and for blocks the kernel cannot tile
    (Triton's ``dot`` needs power-of-two sides of at least 16)."""
    if not _pow2_at_least_16(bh) or not _pow2_at_least_16(bw):
        return "xla"
    if interpret:
        return "triton"
    if jax.default_backend() == "gpu" and not _FORCED_XLA:
        return "triton"
    return "xla"


def _kernel(cols_ref, nb_ref, vals_ref, b_ref, *refs, bm, tn, stripe, rows,
            cols, bias, relu):
    """One [bm, tn] output tile of block-row ``i // (bh // bm)``."""
    it = iter(refs)
    sscale_ref = next(it) if stripe else None
    rscale_ref = next(it) if rows else None
    cscale_ref = next(it) if cols else None
    bias_ref = next(it) if bias else None
    out_ref = next(it)

    i, j = pl.program_id(0), pl.program_id(1)
    bh, bw = vals_ref.shape[2], vals_ref.shape[3]
    per_row = bh // bm
    row, sub = i // per_row, i % per_row
    col_tile = pl.ds(j * tn, tn)
    int_acc = jnp.issubdtype(vals_ref.dtype, jnp.integer) and not stripe

    def body(k, acc):
        jb = cols_ref[row, k]
        a = vals_ref[row, k, pl.ds(sub * bm, bm), :]
        b = b_ref[pl.ds(jb * bw, bw), col_tile]
        d = pl.dot(a, b)
        if stripe:  # per-(stripe, column) dequant scale, inside the loop
            d = d.astype(jnp.float32) * sscale_ref[jb, col_tile][None, :]
        return acc + d

    acc0 = jnp.zeros((bm, tn), jnp.int32 if int_acc else jnp.float32)
    acc = jax.lax.fori_loop(0, nb_ref[row], body, acc0).astype(jnp.float32)
    out_rows = pl.ds(i * bm, bm)
    if rows:
        acc = acc * rscale_ref[out_rows][:, None]
    if cols:
        acc = acc * cscale_ref[col_tile][None, :]
    if bias:
        acc = acc + bias_ref[out_rows][:, None]
    if relu:
        acc = jnp.maximum(acc, 0.0)
    out_ref[...] = acc.astype(out_ref.dtype)


@functools.partial(
    jax.jit,
    static_argnames=("relu", "out_dtype", "bm", "interpret"))
def bell_spmm_triton(dev: BellDevice, B: jax.Array, *, bias=None,
                     relu: bool = False, row_scale=None, col_scale=None,
                     stripe_scale=None, out_dtype=None, bm: int = TILE_M,
                     interpret: bool = False) -> jax.Array:
    """C[permuted rows] = epilogue(A_bell @ B) through the Triton kernel.

    B: [K, N] with K == nbc*bw, in the storage dtype of ``dev.vals``.
    Optional float32 operands: ``stripe_scale`` [nbc, N] multiplies each
    block's product inside the loop; ``row_scale`` [M], ``col_scale`` [N]
    and ``bias`` [M] apply once to the finished tile, then ``relu``.  N is
    padded to a multiple of the column tile and sliced back; ``bm`` (rows
    per program, at most the block height) splits each block-row."""
    nbr, _, bh, bw = dev.vals.shape
    K, N = B.shape
    if dev.vals.dtype != B.dtype:
        raise ValueError(f"A is {dev.vals.dtype} but B is {B.dtype}")
    bm = min(bm, bh)
    tn = min(TILE_N, max(16, 1 << (N - 1).bit_length()))
    Np = -(-N // tn) * tn
    out_dtype = out_dtype or (jnp.float32 if jnp.issubdtype(
        B.dtype, jnp.integer) or B.dtype.itemsize == 1 else B.dtype)

    def pad_cols(x):
        return x if x.shape[-1] == Np else jnp.pad(
            x, [(0, 0)] * (x.ndim - 1) + [(0, Np - x.shape[-1])])

    f32 = functools.partial(jnp.asarray, dtype=jnp.float32)
    extras = [(stripe_scale, lambda s: pad_cols(f32(s))),
              (row_scale, f32), (col_scale, lambda s: pad_cols(f32(s))),
              (bias, f32)]
    operands = [fn(x) for x, fn in extras if x is not None]
    kernel = functools.partial(
        _kernel, bm=bm, tn=tn, stripe=stripe_scale is not None,
        rows=row_scale is not None, cols=col_scale is not None,
        bias=bias is not None, relu=relu)
    n_in = 4 + len(operands)
    out = pl.pallas_call(
        kernel,
        grid=(nbr * (bh // bm), Np // tn),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * n_in,
        out_specs=pl.BlockSpec((bm, tn), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((nbr * bh, Np), out_dtype),
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        interpret=interpret,
        name="bell_spmm_triton",
    )(dev.cols_idx, dev.nb_row, dev.vals, pad_cols(B), *operands)
    return out if Np == N else out[:, :N]


def _epilogue_xla(acc, *, bias=None, relu=False, row_scale=None,
                 col_scale=None):
    """The kernel's epilogue in plain XLA (fused into the producer)."""
    if row_scale is not None:
        acc = acc * row_scale.astype(jnp.float32)[:, None]
    if col_scale is not None:
        acc = acc * col_scale.astype(jnp.float32)[None, :]
    if bias is not None:
        acc = acc + bias.astype(jnp.float32)[:, None]
    if relu:
        acc = jnp.maximum(acc, 0.0)
    return acc


def blocked_spmm(dev: BellDevice, B: jax.Array, *, bias=None,
                 relu: bool = False, row_scale=None, col_scale=None,
                 stripe_scale=None, out_dtype=None,
                 interpret: bool = False) -> jax.Array:
    """Routed blocked SpMM with the kernel's epilogue: the Triton kernel
    where :func:`spmm_route` says so, otherwise ``bell_spmm_xla`` with the
    same epilogue in XLA.  Arguments as in :func:`bell_spmm_triton`."""
    bh, bw = dev.block_row_size, dev.block_col_size
    kw = dict(bias=bias, relu=relu, row_scale=row_scale, col_scale=col_scale)
    if spmm_route(bh, bw, interpret) == "triton":
        return bell_spmm_triton(dev, B, stripe_scale=stripe_scale,
                                out_dtype=out_dtype, interpret=interpret,
                                **kw)
    quantized = jnp.issubdtype(B.dtype, jnp.integer) or B.dtype.itemsize == 1
    out_dtype = out_dtype or (jnp.float32 if quantized else B.dtype)
    plain = not any(v is not None for v in (bias, row_scale, col_scale,
                                            stripe_scale)) and not relu
    if plain and not quantized:
        return bell_spmm_xla(dev, B).astype(out_dtype)
    acc = bell_spmm_xla(dev, B, accum_dtype=None, stripe_scale=stripe_scale)
    return _epilogue_xla(acc.astype(jnp.float32), **kw).astype(out_dtype)
