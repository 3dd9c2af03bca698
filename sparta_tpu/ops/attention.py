"""Block-sparse attention on the framework's blocked-sparsity machinery.

The reference stops at SpMM (its transformer story is "pruned weight
matrices", BASELINE north star); this extends the same 128-block
structure to the attention *pattern* — the other place block sparsity
pays.  Scores are computed only for the mask's nonzero blocks
(SDD: sampled dense-dense QKᵀ as batched dots over the block list),
softmax runs per query row across that block-row's blocks via segment
reductions, and the probability blocks multiply V with the same
batched-dot + segment-sum shape as the bell SpMM.

Everything is pure XLA on static block patterns: the block list (br, bc)
is host-built per config, so jit sees fixed shapes; intra-block causal /
key-padding masks are built on the fly from iota (no [nb, bh, bw] host
tensors).  Differentiable end-to-end (plain XLA ops — jax.grad flows
through segment_sum/segment_max), vmapped over batch and heads.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class BlockMask:
    """Static block-sparsity pattern for [T_q, T_k] attention scores.

    ``br``/``bc`` list the nonzero (query-block, key-block) pairs, sorted
    by ``br``.  ``causal`` adds the intra-block lower-triangular mask on
    diagonal blocks (off-diagonal blocks are all-or-nothing by
    construction of the builders)."""

    br: tuple  # int block-row (query tile) per nonzero block, sorted
    bc: tuple  # int block-col (key tile) per nonzero block
    nbr: int
    nbc: int
    block: int
    causal: bool = False

    @property
    def n_blocks(self) -> int:
        return len(self.br)

    @property
    def density(self) -> float:
        return self.n_blocks / (self.nbr * self.nbc)


def build_block_mask(T_q: int, T_k: int, block: int = 128, *,
                     window: int | None = None, causal: bool = False,
                     global_blocks: int = 0) -> BlockMask:
    """Local-window (+ optional global key blocks) block pattern —
    the Longformer/BigBird family of structures, at tile granularity.

    window=None -> every block (dense pattern, for testing);
    window=w    -> query tile i sees key tiles within w-1 tiles
                   (past-only when causal);
    global_blocks=g -> the first g key tiles are visible to every row.
    """
    if T_q % block or T_k % block:
        raise ValueError(f"T_q={T_q}, T_k={T_k} must be multiples of "
                         f"block={block}")
    nbr, nbc = T_q // block, T_k // block
    pairs = set()
    for i in range(nbr):
        if window is None:
            lo, hi = 0, nbc - 1
        else:
            lo, hi = i - (window - 1), i + (window - 1)
        if causal:
            hi = min(hi, i)
        for j in range(max(lo, 0), min(hi, nbc - 1) + 1):
            pairs.add((i, j))
        for j in range(min(global_blocks, nbc)):
            if not causal or j <= i:
                pairs.add((i, j))
    br, bc = zip(*sorted(pairs)) if pairs else ((), ())
    return BlockMask(br=br, bc=bc, nbr=nbr, nbc=nbc, block=block,
                     causal=causal)


def block_mask_from_csr(m, block: int = 128, *, grouping=None,
                        causal: bool = False,
                        symmetric: bool = True) -> BlockMask:
    """Attention pattern from a sparse matrix's block structure — the
    bridge between the reorder engine and block-sparse attention.

    Tile the (optionally reordered) CSR into ``block`` x ``block`` cells;
    every occupied cell becomes an attention block (graph-structured /
    data-derived sparsity, e.g. a graph transformer attending along a
    reordered adjacency).  ``grouping`` applies a BlockingEngine grouping
    symmetrically (rows AND columns — token identity must permute both
    ways) before tiling, so a similarity reorder concentrates the pattern
    into fewer blocks exactly as it does for SpMM.  ``symmetric`` ors the
    pattern with its transpose (attention edges are usually undirected);
    ``causal`` keeps lower-triangular blocks and adds the intra-block
    triangular mask.  Rows/cols pad up to a block multiple.
    """
    from ..utils import get_permutation

    csr = m.to_scipy().tocoo()
    r, c = np.asarray(csr.row), np.asarray(csr.col)
    if grouping is not None:
        perm = np.asarray(get_permutation(grouping))
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        r, c = inv[r], inv[c]
    nbr = -(-m.rows // block)
    nbc = -(-m.cols // block)
    pairs = {(int(i), int(j)) for i, j in zip(r // block, c // block)}
    if symmetric:
        pairs |= {(j, i) for i, j in pairs if j < nbr and i < nbc}
    # every query tile must see its diagonal (a token always attends to
    # itself, and an all-masked softmax row would NaN)
    pairs |= {(i, i) for i in range(min(nbr, nbc))}
    if causal:
        pairs = {(i, j) for i, j in pairs if j <= i}
    br, bc = zip(*sorted(pairs))
    return BlockMask(br=br, bc=bc, nbr=nbr, nbc=nbc, block=block,
                     causal=causal)


@functools.lru_cache(maxsize=64)
def _mask_to_ell(mask: BlockMask):
    """ELL-ify the block list: every block-row padded to the max blocks
    per row (``wmax``).  Dead slots point at key tile 0 and are killed by
    an additive -inf.  Converts every per-row reduction downstream into a
    dense reduce over the static wmax axis — no segment ops anywhere in
    the pipeline."""
    counts = np.zeros(mask.nbr, dtype=np.int64)
    for i in mask.br:
        counts[i] += 1
    wmax = max(int(counts.max()) if counts.size else 0, 1)
    bc_ell = np.zeros((mask.nbr, wmax), dtype=np.int32)
    live = np.zeros((mask.nbr, wmax), dtype=bool)
    fill = np.zeros(mask.nbr, dtype=np.int64)
    for i, j in zip(mask.br, mask.bc):
        bc_ell[i, fill[i]] = j
        live[i, fill[i]] = True
        fill[i] += 1
    return wmax, bc_ell, live


@functools.partial(jax.jit, static_argnames=("nbr", "block", "causal"))
def _bsa_core(q, k, v, bc_ell, live, nbr, block, causal, scale):
    """Single-head core: q [T_q, D], k/v [T_k, D] -> [T_q, D].

    ELL layout: bc_ell/live [nbr, wmax] give each query tile's key tiles
    (dead slots masked).  SDD scores, softmax and PV are all batched
    dense ops over [nbr, wmax, bh, bw] — batched dots plus regular
    reduces, no gather/scatter beyond the tile gathers."""
    bh = bw = block
    D = q.shape[-1]
    qt = q.reshape(nbr, bh, D)
    kt = k.reshape(-1, bw, D)[bc_ell]           # [nbr, wmax, bw, D]
    vt = v.reshape(-1, bw, D)[bc_ell]
    # SDD: scores only for the pattern's blocks — batched dots
    s = jnp.einsum("rbd,rwcd->rwbc", qt, kt,
                   preferred_element_type=jnp.float32) * scale
    neg = jnp.asarray(-jnp.inf, s.dtype)
    if causal:
        # intra-block triangular mask from iota (diagonal blocks);
        # strictly-past blocks are fully visible, future ones absent
        qi = jax.lax.broadcasted_iota(jnp.int32, (nbr, 1, bh, 1), 0) * bh \
            + jax.lax.broadcasted_iota(jnp.int32, (1, 1, bh, 1), 2)
        ki = bc_ell[:, :, None, None] * bw + jax.lax.broadcasted_iota(
            jnp.int32, (1, 1, 1, bw), 3)
        s = jnp.where(qi >= ki, s, neg)
    s = jnp.where(live[:, :, None, None], s, neg)
    # per-query-row softmax: dense reduce over (wmax, bw)
    m = jnp.maximum(s.max(axis=(1, 3)), -1e30)          # [nbr, bh]
    p = jnp.exp(s - m[:, None, :, None])
    denom = p.sum(axis=(1, 3))                          # [nbr, bh]
    p = p / jnp.maximum(denom, 1e-30)[:, None, :, None]
    # PV: one batched matmul, reduced over the static wmax axis
    o = jnp.einsum("rwbc,rwcd->rbd", p.astype(v.dtype), vt,
                   preferred_element_type=jnp.float32)  # [nbr, bh, D]
    return o.reshape(nbr * bh, D).astype(q.dtype)


def block_sparse_attention(q: jax.Array, k: jax.Array, v: jax.Array,
                           mask: BlockMask,
                           scale: float | None = None) -> jax.Array:
    """Attention over a static block pattern.

    q: [..., T_q, D], k/v: [..., T_k, D]; leading dims (batch, heads)
    are vmapped.  Returns [..., T_q, D].  Scores exist ONLY for the
    mask's blocks — compute and memory scale with mask.n_blocks, not
    T_q*T_k.

    Plain XLA on every backend: batched dots over the mask's blocks,
    differentiable through ``jax.grad``.  Causal masking aligns query and
    key index 0 (row i sees keys j <= i), for any T_q and T_k."""
    if q.shape[-2] != mask.nbr * mask.block:
        raise ValueError(f"T_q={q.shape[-2]} != mask {mask.nbr}x{mask.block}")
    if k.shape[-2] != mask.nbc * mask.block:
        raise ValueError(f"T_k={k.shape[-2]} != mask {mask.nbc}x{mask.block}")
    scale = scale if scale is not None else 1.0 / np.sqrt(q.shape[-1])
    _, bc_ell, live = _mask_to_ell(mask)
    bc_ell = jnp.asarray(bc_ell)
    live = jnp.asarray(live)
    fn = functools.partial(_bsa_core, nbr=mask.nbr, block=mask.block,
                           causal=mask.causal, scale=scale)
    for _ in range(q.ndim - 2):
        fn = jax.vmap(fn, in_axes=(0, 0, 0, None, None))
    return fn(q, k, v, bc_ell, live)


def dense_mask_from_block_mask(mask: BlockMask) -> np.ndarray:
    """Boolean [T_q, T_k] elementwise mask equivalent — the test oracle."""
    T_q, T_k = mask.nbr * mask.block, mask.nbc * mask.block
    out = np.zeros((T_q, T_k), dtype=bool)
    b = mask.block
    for i, j in zip(mask.br, mask.bc):
        out[i * b:(i + 1) * b, j * b:(j + 1) * b] = True
    if mask.causal:
        out &= np.tril(np.ones((T_q, T_k), dtype=bool))
    return out
