"""Training step for the block-sparse transformer, shardable over a
(dp, tp) mesh.

Gradients flow into the Blocked-ELL FFN values through the SpMM gather
structure (bell_spmm_xla is pure jnp, so autodiff handles it); the optimizer
only ever sees the stored blocks — pruned weights stay pruned.

Sharding layout (annotated via NamedSharding on params + batch):
- dp: batch axis of tokens/activations
- tp: FFN block-rows (ffn_up vals: output-feature parallel) and FFN
  block-columns via ffn_down vals block-rows (d_model rows) replication;
  attention weights replicated.  XLA inserts the psum/all-gathers.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .transformer import BlockSparseTransformer


def lm_loss(model: BlockSparseTransformer, params, tokens) -> jax.Array:
    if model.cfg.moe_experts:
        logits, aux = model.apply(params, tokens[:, :-1], return_aux=True)
    else:
        logits, aux = model.apply(params, tokens[:, :-1]), 0.0
    targets = tokens[:, 1:]
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1).squeeze(-1)
    return nll.mean() + model.cfg.moe_aux_weight * aux


def make_train_step(model: BlockSparseTransformer, optimizer):
    @jax.jit
    def train_step(params, opt_state, tokens):
        loss, grads = jax.value_and_grad(
            functools.partial(lm_loss, model)
        )(params, tokens)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


def param_shardings(model: BlockSparseTransformer, params, mesh: Mesh):
    """NamedShardings: FFN vals sharded over tp on block-rows; attention
    projections Megatron-style (column-parallel qkv, row-parallel proj —
    GSPMD then runs the per-head attention math tp-local and inserts ONE
    all-reduce after proj); MoE expert vals sharded over ep on the expert
    axis (expert parallelism — GSPMD partitions the dispatch/combine
    einsums and routes expert slabs between devices); everything else replicated."""
    has_tp = "tp" in mesh.shape
    has_ep = "ep" in mesh.shape
    tp = mesh.shape.get("tp", 1)
    ep = mesh.shape.get("ep", 1)

    def shard_of(path, leaf):
        names = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if (has_ep and names[-1] in ("up_vals", "down_vals")
                and "moe" in names and leaf.shape[0] % ep == 0):
            return NamedSharding(mesh, P("ep"))
        if has_tp and "ffn_up" in names and names[-1] == "vals":
            return NamedSharding(mesh, P("tp", None, None, None))
        if "ffn_down" in names and names[-1] == "vals":
            # block-columns of the down projection follow ffn_up's rows;
            # sharding vals on max_nb (ragged) is unsound -> replicate rows
            return NamedSharding(mesh, P(None, None, None, None))
        if (has_tp and "qkv" in names and leaf.shape[-1] % tp == 0
                and model.cfg.n_heads % tp == 0):
            # column-parallel: the qkv out dim is head-major [h, 3, dh]
            # (transformer._attn), so a contiguous tp chunk = whole head
            # groups and the per-head attention math stays tp-local
            return NamedSharding(
                mesh, P(None, "tp") if names[-1] == "w" else P("tp"))
        if (has_tp and "proj" in names and names[-1] == "w"
                and leaf.shape[0] % tp == 0):
            return NamedSharding(mesh, P("tp", None))  # row-parallel
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(shard_of, params)


def make_sharded_train_step(
    model: BlockSparseTransformer, optimizer, mesh: Mesh
):
    """jit with explicit in/out shardings over the (dp, tp) mesh."""

    def init_sharded(key, sample_tokens):
        params = model.init(key)
        p_sh = param_shardings(model, params, mesh)
        params = jax.device_put(params, p_sh)
        opt_state = optimizer.init(params)
        tokens = jax.device_put(
            sample_tokens, NamedSharding(mesh, P("dp", None))
        )
        return params, opt_state, tokens

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def train_step(params, opt_state, tokens):
        loss, grads = jax.value_and_grad(
            functools.partial(lm_loss, model)
        )(params, tokens)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return init_sharded, train_step


def make_sharded_decode(model: BlockSparseTransformer, mesh: Mesh):
    """Serving over a (dp, tp) mesh: returns ``(place, step)``.

    ``place(params, cache, tokens)`` puts params Megatron-style
    (``param_shardings``), the token batch over dp, and the per-layer K/V
    rings over (dp on batch, tp on heads) — the qkv column split makes each
    head group tp-local, so cache writes and per-head attention run without
    collectives and GSPMD inserts the single all-reduce after the row-
    parallel proj.  ``step`` is ``decode_step`` jitted with the cache
    sharding pinned on its outputs so the rings never silently gather."""
    tp = mesh.shape.get("tp", 1)
    # heads shard over tp only when the mesh has one and heads divide (same
    # guard as param_shardings' qkv rule); otherwise the rings replicate
    kv_sh = NamedSharding(
        mesh, P("dp", "tp" if "tp" in mesh.shape
                and model.cfg.n_heads % tp == 0 else None, None, None))
    cache_sh = {
        "pos": NamedSharding(mesh, P()),
        "layers": [
            {"k": kv_sh, "v": kv_sh}
            for _ in range(model.cfg.n_layers)
        ],
    }

    def place(params, cache, tokens):
        params = jax.device_put(params, param_shardings(model, params, mesh))
        cache = jax.device_put(cache, cache_sh)
        tokens = jax.device_put(tokens, NamedSharding(mesh, P("dp")))
        return params, cache, tokens

    step = jax.jit(
        model.decode_step,
        out_shardings=(NamedSharding(mesh, P("dp", None)), cache_sh),
        donate_argnums=(2,),  # the cache ring updates in place
    )
    return place, step
