"""Pipeline parallelism (GPipe schedule) for the block-sparse transformer.

Layers are split into S contiguous stages over a mesh axis ("pp"); the
batch is split into M microbatches.  All devices run the same SPMD program
of ``M + S - 1`` ticks inside one ``shard_map``: at tick t, stage s works
on microbatch ``t - s`` (a `lax.scan` over ticks), and activations move to
the next stage with one ``ppermute`` per tick — the SPMD form of
point-to-point stage transfers.  The pipeline bubble is the standard
``(S-1)/(M+S-1)`` fraction.

Stage parameters are the per-layer param pytrees stacked along a leading
layer axis and sharded ``P("pp")`` — each device materializes only its
``L/S`` layers, which is the point: pipeline parallelism scales model
DEPTH beyond one chip's HBM.  Inside a stage the local layers run under
``lax.scan`` with the Blocked-ELL FFN structure passed as traced arrays
(the same custom-VJP SpMM as everywhere else).

Stage 0 embeds tokens; the last stage applies the final layernorm + tied
head and accumulates the per-microbatch NLL — the loss (and its gradients,
via shard_map's transpose of ppermute) matches the unsharded
``train.lm_loss`` exactly (`tests/test_pp.py`).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .layers import layernorm_apply
from .moe import _expert_ffn
from .transformer import BlockSparseTransformer


def stack_layer_params(params) -> dict:
    """params['layers'] (list of identical pytrees) -> one pytree with a
    leading [L] axis, shardable P('pp') for stage ownership."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *params["layers"])


def stack_ffn_structure(model: BlockSparseTransformer):
    """Static Blocked-ELL structure of every layer's FFN pair, stacked to
    [L, nbr, max_nb]/[L, nbr] (max_nb padded to the widest layer; nb_row
    bounds the walk so padding is never read)."""
    def stack(layers):
        mx = max(la.max_nb for la in layers)
        cols = np.zeros((len(layers), layers[0].cols_idx.shape[0], mx),
                        np.int32)
        nb = np.zeros((len(layers), layers[0].cols_idx.shape[0]), np.int32)
        for i, la in enumerate(layers):
            c = np.asarray(la.cols_idx)
            cols[i, :, : c.shape[1]] = c
            nb[i] = np.asarray(la.nb_row)
        return jnp.asarray(cols), jnp.asarray(nb)

    uc, un = stack(model.ffn_up)
    dc, dn = stack(model.ffn_down)
    return {"up_cols": uc, "up_nb": un, "dn_cols": dc, "dn_nb": dn}


def _one_layer(model: BlockSparseTransformer, x, lp, st):
    """One transformer layer with traced params AND traced FFN structure
    (so it can run under lax.scan across a stage's layers)."""
    cfg = model.cfg
    x = x + BlockSparseTransformer._attn(
        lp, layernorm_apply(lp["ln1"], x), cfg)
    h = layernorm_apply(lp["ln2"], x)
    lead = h.shape[:-1]
    if "bias" in lp["ffn_down"]:
        # the dense-FFN transformer carries biases on both projections
        # (the up bias rides INSIDE gelu), so fold them in directly —
        # _expert_ffn is the bias-free MoE variant
        from ..ops.autodiff import bell_spmm

        xf = h.reshape(-1, cfg.d_model)
        Kd = -(-cfg.d_model // cfg.block) * cfg.block
        xp = jnp.pad(xf, ((0, 0), (0, Kd - xf.shape[1]))) \
            if xf.shape[1] < Kd else xf
        u = bell_spmm(st["up_cols"], st["up_nb"],
                      lp["ffn_up"]["vals"].astype(h.dtype), xp.T).T[:, : cfg.d_ff]
        u = jax.nn.gelu(u + lp["ffn_up"]["bias"].astype(u.dtype))
        Kf = -(-cfg.d_ff // cfg.block) * cfg.block
        up_ = jnp.pad(u, ((0, 0), (0, Kf - u.shape[1]))) \
            if u.shape[1] < Kf else u
        y = bell_spmm(st["dn_cols"], st["dn_nb"],
                      lp["ffn_down"]["vals"].astype(h.dtype), up_.T).T[:, : cfg.d_model]
        y = y + lp["ffn_down"]["bias"].astype(y.dtype)
    else:
        y = _expert_ffn(st["up_cols"], st["up_nb"], lp["ffn_up"]["vals"],
                        st["dn_cols"], st["dn_nb"], lp["ffn_down"]["vals"],
                        h.reshape(-1, cfg.d_model), cfg.d_model, cfg.d_ff,
                        cfg.block)
    return x + y.reshape(*lead, cfg.d_model)


def _pp_loss_local(model, head_params, stage_params, structure, tokens,
                   *, axis_pp: str, n_stages: int, n_micro: int,
                   axis_dp: str | None, n_dp: int):
    """Shard-local GPipe loop.  tokens [B_l, T] (already dp-local);
    stage_params/structure carry this stage's [L/S] layers."""
    cfg = model.cfg
    dtype = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    B, T = tokens.shape
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    mb = B // n_micro
    S = n_stages
    s_idx = lax.axis_index(axis_pp)
    # pcast replicated/partially-replicated params to fully varying: the
    # transpose of the cast is a psum, so the backward's grads (which vary
    # over dp through the tokens) stay vma-consistent through the scan and
    # come back correctly all-reduced
    axes_all = (axis_pp,) if axis_dp is None else (axis_pp, axis_dp)
    head_params = jax.tree.map(
        lambda a: lax.pcast(a, axes_all, to="varying"), head_params)
    if axis_dp is not None:
        stage_params = jax.tree.map(
            lambda a: lax.pcast(a, (axis_dp,), to="varying"), stage_params)

    toks_mb = tokens.reshape(n_micro, mb, T)
    Tm = T - 1  # positions fed to the model (lm_loss feeds tokens[:, :-1])

    def embed(mtoks):
        x = head_params["embed"][mtoks[:, :Tm]].astype(dtype)
        return x + head_params["pos"][:Tm].astype(dtype)

    def stage(x):
        def body(xc, per_layer):
            lp, st = per_layer
            return _one_layer(model, xc, lp, st), None

        out, _ = lax.scan(body, x, (stage_params, structure))
        return out

    def head_nll(x, mtoks):
        x = layernorm_apply(head_params["final_ln"], x)
        logits = (x @ head_params["embed"].T.astype(dtype)).astype(
            jnp.float32)
        targets = mtoks[:, 1:]
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, targets[..., None],
                                   axis=-1).squeeze(-1)
        return nll.sum()

    perm = [(i, i + 1) for i in range(S - 1)]

    def tick(carry, t):
        buf, acc = carry  # buf: activation entering this stage [mb, Tm, d]
        m_in = jnp.clip(t, 0, n_micro - 1)
        x0 = embed(lax.dynamic_index_in_dim(toks_mb, m_in, keepdims=False))
        x = jnp.where(s_idx == 0, x0, buf)
        y = stage(x)
        m_out = t - (S - 1)
        is_out = (s_idx == S - 1) & (m_out >= 0) & (m_out < n_micro)
        mo = jnp.clip(m_out, 0, n_micro - 1)
        nll = head_nll(y, lax.dynamic_index_in_dim(toks_mb, mo,
                                                   keepdims=False))
        acc = acc + jnp.where(is_out, nll, 0.0)
        buf = lax.ppermute(y, axis_pp, perm) if S > 1 else y
        return (buf, acc), None

    # the scan carry becomes device-varying on the first tick (ppermute /
    # dp-local tokens); pcast the zero initializers to match
    buf0 = lax.pcast(jnp.zeros((mb, Tm, cfg.d_model), dtype), axes_all,
                     to="varying")
    acc0 = lax.pcast(jnp.zeros((), jnp.float32), axes_all, to="varying")
    (_, acc), _ = lax.scan(tick, (buf0, acc0), jnp.arange(n_micro + S - 1))
    axes = (axis_pp,) if axis_dp is None else (axis_pp, axis_dp)
    total = lax.psum(acc, axes)
    return total / (B * n_dp * Tm)


def make_pp_train_step(model: BlockSparseTransformer, optimizer,
                       mesh: Mesh, n_micro: int, axis_pp: str = "pp",
                       axis_dp: str | None = "dp"):
    """GPipe training step over a (dp, pp) mesh (pass ``axis_dp=None``
    for a pure-pp 1-D mesh).

    Per-layer params are stacked and sharded on ``axis_pp`` (each stage
    holds L/S layers); embed/pos/final_ln are replicated (stage 0 / last
    stage use them); tokens shard on ``axis_dp``.  Layer count must divide
    by the stage count, and cfg.moe_experts must be 0 (compose ep with dp,
    not pp, this round).

    Returns ``(init_sharded, train_step)``; ``train_step(head_params,
    stacked_layers, opt_state, tokens)``.
    """
    cfg = model.cfg
    S = mesh.shape[axis_pp]
    n_dp = mesh.shape[axis_dp] if axis_dp else 1
    if cfg.n_layers % S:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"{S} pipeline stages")
    if cfg.moe_experts:
        raise ValueError("pipeline parallelism composes with the dense "
                         "block-sparse FFN (moe_experts=0)")
    structure = stack_ffn_structure(model)

    def pp_loss(head_params, stacked, tokens):
        tok_spec = P(axis_dp) if axis_dp else P()
        fn = jax.shard_map(
            functools.partial(_pp_loss_local, model, axis_pp=axis_pp,
                              n_stages=S, n_micro=n_micro, axis_dp=axis_dp,
                              n_dp=n_dp),
            mesh=mesh,
            in_specs=(P(), P(axis_pp), P(axis_pp), tok_spec),
            out_specs=P())
        return fn(head_params, stacked, structure, tokens)

    def init_sharded(key, sample_tokens):
        params = model.init(key)
        stacked = stack_layer_params(params)
        head_params = {k: v for k, v in params.items() if k != "layers"}
        head_params = jax.device_put(head_params, NamedSharding(mesh, P()))
        stacked = jax.device_put(
            stacked, NamedSharding(mesh, P(axis_pp)))
        opt_state = optimizer.init((head_params, stacked))
        tokens = jax.device_put(sample_tokens, NamedSharding(
            mesh, P(axis_dp) if axis_dp else P()))
        return head_params, stacked, opt_state, tokens

    @functools.partial(jax.jit, donate_argnums=(0, 1, 2))
    def train_step(head_params, stacked, opt_state, tokens):
        loss, grads = jax.value_and_grad(pp_loss, argnums=(0, 1))(
            head_params, stacked, tokens)
        updates, opt_state = optimizer.update(
            grads, opt_state, (head_params, stacked))
        head_params, stacked = optax.apply_updates(
            (head_params, stacked), updates)
        return head_params, stacked, opt_state, loss

    return init_sharded, train_step
