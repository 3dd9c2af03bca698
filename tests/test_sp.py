"""Sequence parallelism: halo-exchange local attention + sp training step
on the 8-virtual-device CPU mesh."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

from sparta_tpu.models import (
    BlockSparseTransformer,
    TransformerConfig,
    lm_loss,
    make_sp_train_step,
)
from sparta_tpu.models.sp import _sp_loss_local
from sparta_tpu.ops.attention import block_sparse_attention, build_block_mask
from sparta_tpu.parallel import (
    make_mesh,
    make_mesh_2d,
    sequence_sharded_attention,
)


@pytest.fixture(scope="module")
def mesh4():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(4)


@pytest.mark.parametrize("window,global_blocks,block", [
    (3, 1, 16),   # halo + owner-broadcast global tile
    (1, 0, 16),   # no halo, no global
    (2, 2, 8),    # multiple global tiles
    (1, 1, 32),   # global only
])
def test_sequence_sharded_attention_matches_oracle(mesh4, window,
                                                   global_blocks, block):
    """Sharding the token axis must be invisible: bit-compare against the
    single-device block_sparse_attention on the equivalent BlockMask."""
    H, D = 2, 32
    T = 4 * 2 * block  # 2 tiles per shard
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.standard_normal((H, T, D)), jnp.float32)
               for _ in range(3))
    got = np.asarray(sequence_sharded_attention(
        q, k, v, mesh4, "x", block=block, window=window,
        global_blocks=global_blocks))
    mask = build_block_mask(T, T, block, window=window, causal=True,
                            global_blocks=global_blocks)
    ref = np.asarray(block_sparse_attention(q, k, v, mask))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_sequence_sharded_attention_batch_dim(mesh4):
    """4-D [B, H, T, D] inputs ride the same specs (leading dims
    replicated)."""
    B, H, T, D, blk = 2, 2, 4 * 2 * 16, 16, 16
    rng = np.random.default_rng(1)
    q, k, v = (jnp.asarray(rng.standard_normal((B, H, T, D)), jnp.float32)
               for _ in range(3))
    got = np.asarray(sequence_sharded_attention(
        q, k, v, mesh4, "x", block=blk, window=2, global_blocks=1))
    mask = build_block_mask(T, T, blk, window=2, causal=True,
                            global_blocks=1)
    ref = np.asarray(block_sparse_attention(q, k, v, mask))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_sequence_sharded_attention_rejects_oversize_halo(mesh4):
    """window-1 tiles must fit in one shard (single-neighbor halo)."""
    T, blk = 4 * 16, 16  # 1 tile per shard
    q = jnp.zeros((1, T, 8), jnp.float32)
    with pytest.raises(ValueError, match="halo"):
        sequence_sharded_attention(q, q, q, mesh4, "x", block=blk, window=3)


@pytest.fixture(scope="module")
def sp_setup():
    cfg = TransformerConfig(
        vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq=128,
        block=16, ffn_block_density=0.5, attention="local", attn_window=2,
        attn_global_blocks=1)
    model = BlockSparseTransformer.create(cfg, jax.random.PRNGKey(0))
    params = model.init(jax.random.PRNGKey(2))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 128), 0,
                                cfg.vocab)
    mesh = make_mesh_2d((2, 4), axes=("dp", "sp"))
    return model, params, tokens, mesh


def test_sp_loss_and_grads_match_unsharded(sp_setup):
    """The (dp, sp)-sharded loss AND its param gradients must equal the
    single-device lm_loss — sequence sharding is a pure execution layout."""
    model, params, tokens, mesh = sp_setup
    sp_loss = jax.shard_map(
        functools.partial(_sp_loss_local, model, axis_dp="dp", axis_sp="sp",
                          n_dp=2, n_sp=4),
        mesh=mesh, in_specs=(P(), P("dp", "sp")), out_specs=P())
    l_sp, g_sp = jax.value_and_grad(sp_loss)(params, tokens)
    l_ref, g_ref = jax.value_and_grad(
        functools.partial(lm_loss, model))(params, tokens)
    assert float(l_sp) == pytest.approx(float(l_ref), abs=1e-5)
    flat_sp = jax.tree.leaves(g_sp)
    flat_ref = jax.tree.leaves(g_ref)
    assert len(flat_sp) == len(flat_ref)
    for a, b in zip(flat_sp, flat_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-6)


def test_sp_train_step_reduces_loss(sp_setup):
    model, _, tokens, mesh = sp_setup
    opt = optax.adamw(1e-3)
    init_s, step = make_sp_train_step(model, opt, mesh)
    params, opt_state, toks_s = init_s(jax.random.PRNGKey(2), tokens)
    with jax.sharding.set_mesh(mesh):
        losses = []
        for _ in range(6):
            params, opt_state, loss = step(params, opt_state, toks_s)
            losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_sp_moe_composition_matches_unsharded():
    """Sequence parallelism composes with the MoE FFN (routing/capacity
    per sequence shard): with ample capacity (dropless both ways) and
    aux_weight=0 (aux statistics are shard-local by design), the sp loss
    equals the unsharded lm_loss exactly."""
    cfg = TransformerConfig(
        vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq=128,
        block=16, ffn_block_density=0.5, attention="local", attn_window=2,
        attn_global_blocks=1, moe_experts=4, moe_capacity=8.0,
        moe_aux_weight=0.0)
    model = BlockSparseTransformer.create(cfg, jax.random.PRNGKey(0))
    params = model.init(jax.random.PRNGKey(2))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 128), 0, 64)
    mesh = make_mesh_2d((2, 4), axes=("dp", "sp"))
    sp_loss = jax.shard_map(
        functools.partial(_sp_loss_local, model, axis_dp="dp", axis_sp="sp",
                          n_dp=2, n_sp=4),
        mesh=mesh, in_specs=(P(), P("dp", "sp")), out_specs=P())
    l_sp = float(sp_loss(params, tokens))
    l_ref = float(lm_loss(model, params, tokens))
    assert l_sp == pytest.approx(l_ref, abs=1e-5)


def test_sp_train_step_rejects_dense_attention():
    cfg = TransformerConfig(
        vocab=32, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_seq=64,
        block=16, attention="dense")
    model = BlockSparseTransformer.create(cfg, jax.random.PRNGKey(0))
    mesh = make_mesh_2d((2, 4), axes=("dp", "sp"))
    init_s, step = make_sp_train_step(model, optax.sgd(1e-2), mesh)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0, 32)
    params, opt_state, toks_s = init_s(jax.random.PRNGKey(2), tokens)
    with pytest.raises(ValueError, match="local"):
        with jax.sharding.set_mesh(mesh):
            step(params, opt_state, toks_s)
