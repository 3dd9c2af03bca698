"""Block-sparse attention vs the dense-masked oracle.

A capability beyond the reference (its transformer story is pruned FFN
weights only); built on the same 128-block structure as the SpMM family."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparta_tpu.ops.attention import (
    BlockMask,
    block_sparse_attention,
    build_block_mask,
    dense_mask_from_block_mask,
)


def _dense_attention(q, k, v, mask_bool, scale):
    s = (q @ k.swapaxes(-1, -2)) * scale
    s = np.where(mask_bool, s, -np.inf)
    s = s - s.max(axis=-1, keepdims=True)
    p = np.exp(s)
    denom = p.sum(axis=-1, keepdims=True)
    p = np.divide(p, denom, out=np.zeros_like(p), where=denom > 0)
    return p @ v


def _qkv(rng, shape):
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


@pytest.mark.parametrize("causal", [False, True])
def test_bsa_local_window_matches_dense(causal):
    T, D, block = 512, 64, 128
    mask = build_block_mask(T, T, block, window=2, causal=causal)
    assert 0 < mask.density < 1
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, (T, D))
    out = np.asarray(block_sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask))
    ref = _dense_attention(q, k, v, dense_mask_from_block_mask(mask),
                           1.0 / np.sqrt(D))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_bsa_dense_pattern_equals_full_attention():
    """window=None covers every block: must equal unmasked attention."""
    T, D = 256, 32
    mask = build_block_mask(T, T, 128)
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, (T, D))
    out = np.asarray(block_sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask))
    ref = _dense_attention(q, k, v, np.ones((T, T), bool), 1.0 / np.sqrt(D))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_bsa_global_blocks_and_batch_heads():
    """[B, H, T, D] operands vmap over leading dims; global key blocks are
    visible to every query row."""
    B, H, T, D, block = 2, 3, 384, 32, 128
    mask = build_block_mask(T, T, block, window=1, causal=True,
                            global_blocks=1)
    # global column present for every block-row
    assert all(any(b == i and c == 0 for b, c in zip(mask.br, mask.bc))
               for i in range(mask.nbr))
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, (B, H, T, D))
    out = np.asarray(block_sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask))
    ref = _dense_attention(q, k, v, dense_mask_from_block_mask(mask),
                           1.0 / np.sqrt(D))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_bsa_rectangular_cross_attention():
    """T_q != T_k (cross attention over a block pattern)."""
    Tq, Tk, D = 256, 512, 64
    mask = build_block_mask(Tq, Tk, 128, window=None)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((Tq, D)).astype(np.float32)
    k = rng.standard_normal((Tk, D)).astype(np.float32)
    v = rng.standard_normal((Tk, D)).astype(np.float32)
    out = np.asarray(block_sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask))
    ref = _dense_attention(q, k, v, np.ones((Tq, Tk), bool),
                           1.0 / np.sqrt(D))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_bsa_differentiable():
    """Gradients flow through the segment softmax to q, k, v."""
    T, D = 256, 32
    mask = build_block_mask(T, T, 128, window=1, causal=True)
    rng = np.random.default_rng(4)
    q, k, v = (jnp.asarray(x) for x in _qkv(rng, (T, D)))

    def loss(q, k, v):
        return jnp.sum(block_sparse_attention(q, k, v, mask) ** 2)

    gq, gk, gv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for g in (gq, gk, gv):
        assert np.isfinite(np.asarray(g)).all()
        assert float(jnp.abs(g).max()) > 0
    # numeric check on a single coordinate
    eps = 1e-3
    e = jnp.zeros_like(q).at[3, 5].set(eps)
    num = (loss(q + e, k, v) - loss(q - e, k, v)) / (2 * eps)
    assert abs(float(num) - float(gq[3, 5])) < 5e-2 * max(
        1.0, abs(float(num)))


def test_bsa_compute_scales_with_blocks():
    """The SDD really is sampled: block count grows linearly with window,
    not quadratically with T."""
    T = 1024
    m1 = build_block_mask(T, T, 128, window=1, causal=True)
    m2 = build_block_mask(T, T, 128, window=2, causal=True)
    assert m1.n_blocks == T // 128
    assert m2.n_blocks == 2 * (T // 128) - 1
    full = build_block_mask(T, T, 128)
    assert full.n_blocks == (T // 128) ** 2


def test_bsa_shape_validation():
    mask = build_block_mask(256, 256, 128)
    q = jnp.zeros((384, 32))
    with pytest.raises(ValueError):
        block_sparse_attention(q, q, q, mask)
    with pytest.raises(ValueError):
        build_block_mask(200, 256, 128)


# ---------------------------------------------------------------------------
# the former flash-kernel cases, on the XLA path against the dense oracle
# ---------------------------------------------------------------------------

def _dense_jax(q, k, v, mask_bool, scale):
    """Dense-masked attention in jax.numpy (the differentiable oracle)."""
    s = jnp.einsum("...td,...sd->...ts", q.astype(jnp.float32),
                   k.astype(jnp.float32)) * scale
    s = jnp.where(mask_bool, s, -jnp.inf)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("...ts,...sd->...td", p, v.astype(jnp.float32))


def _grads(fn, q, k, v):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) ** 2)

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _check_vs_dense(q, k, v, mask, fwd_tol=1e-4, grad_tol=1e-4):
    scale = 1.0 / np.sqrt(q.shape[-1])
    dm = jnp.asarray(dense_mask_from_block_mask(mask))
    got = block_sparse_attention(q, k, v, mask)
    ref = _dense_jax(q, k, v, dm, scale)
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref),
                               rtol=fwd_tol, atol=fwd_tol)
    gb = _grads(lambda a, b, c: block_sparse_attention(a, b, c, mask),
                q, k, v)
    gd = _grads(lambda a, b, c: _dense_jax(a, b, c, dm, scale), q, k, v)
    for name, a, b in zip("qkv", gb, gd):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32),
                                   rtol=grad_tol, atol=grad_tol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_bsa_pallas_matches_xla(causal):
    """Window + global pattern, forward and gradients vs the dense oracle."""
    T, D = 512, 64
    mask = build_block_mask(T, T, 128, window=2, causal=causal,
                            global_blocks=1)
    q, k, v = (jnp.asarray(x) for x in _qkv(np.random.default_rng(10),
                                            (2, T, D)))
    _check_vs_dense(q, k, v, mask)


def test_bsa_pallas_vs_dense_oracle_batched():
    """[B, H, T, D] operands (D=32) straight against the numpy oracle."""
    B, H, T, D = 2, 3, 384, 32
    mask = build_block_mask(T, T, 128, window=1, causal=True,
                            global_blocks=1)
    q, k, v = _qkv(np.random.default_rng(11), (B, H, T, D))
    got = np.asarray(block_sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask))
    ref = _dense_attention(q, k, v, dense_mask_from_block_mask(mask),
                           1.0 / np.sqrt(D))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_bsa_pallas_rectangular():
    Tq, Tk, D = 256, 512, 64
    mask = build_block_mask(Tq, Tk, 128, window=None)
    rng = np.random.default_rng(12)
    q = jnp.asarray(rng.standard_normal((Tq, D)).astype(np.float32))
    k, v = (jnp.asarray(rng.standard_normal((Tk, D)).astype(np.float32))
            for _ in range(2))
    _check_vs_dense(q, k, v, mask)


def test_bsa_pallas_grad_matches_xla():
    T, D = 256, 64
    mask = build_block_mask(T, T, 128, window=1, causal=True)
    q, k, v = (jnp.asarray(x) for x in _qkv(np.random.default_rng(13),
                                            (T, D)))
    _check_vs_dense(q, k, v, mask)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("global_blocks", [0, 1])
def test_flash_backward_matches_xla(causal, global_blocks):
    T, D = 512, 64
    mask = build_block_mask(T, T, 128, window=2, causal=causal,
                            global_blocks=global_blocks)
    q, k, v = (jnp.asarray(x) for x in _qkv(np.random.default_rng(21),
                                            (T, D)))
    _check_vs_dense(q, k, v, mask)


def test_flash_backward_ragged_mask_and_lead_dims():
    """Data-derived mask (uneven blocks per row and per column) with batch
    leading dims."""
    from sparta_tpu.formats.csr import rmat_csr
    from sparta_tpu.ops.attention import block_mask_from_csr

    m = rmat_csr(11, edge_factor=2, seed=7)
    mask = block_mask_from_csr(m, block=128)
    assert len(set(np.bincount(mask.br).tolist())) > 2
    T, D = mask.nbr * 128, 64
    q, k, v = (jnp.asarray(x) for x in _qkv(np.random.default_rng(22),
                                            (2, T, D)))
    _check_vs_dense(q, k, v, mask)


def test_flash_backward_rectangular():
    """Cross-attention: T_q != T_k with a windowed pattern."""
    Tq, Tk, D = 256, 512, 64
    mask = build_block_mask(Tq, Tk, 128, window=2)
    rng = np.random.default_rng(23)
    q = jnp.asarray(rng.standard_normal((Tq, D)).astype(np.float32))
    k, v = (jnp.asarray(rng.standard_normal((Tk, D)).astype(np.float32))
            for _ in range(2))
    _check_vs_dense(q, k, v, mask)


@pytest.mark.parametrize("Tq,Tk", [(512, 256), (384, 128)])
def test_causal_rectangular_tq_gt_tk(Tq, Tk):
    """Causal attention with more queries than keys: query i sees keys
    j <= i.  The mask's diagonal blocks exist only for the first T_k/128
    query tiles; later tiles see every key and no triangle.  Forward and
    gradients match the dense oracle."""
    D = 64
    mask = build_block_mask(Tq, Tk, 128, window=None, causal=True)
    dm = dense_mask_from_block_mask(mask)
    assert dm[Tq - 1].all() and not dm[0, 1:].any()
    rng = np.random.default_rng(Tq + Tk)
    q = jnp.asarray(rng.standard_normal((Tq, D)).astype(np.float32))
    k, v = (jnp.asarray(rng.standard_normal((Tk, D)).astype(np.float32))
            for _ in range(2))
    _check_vs_dense(q, k, v, mask)


def test_flash_backward_bf16():
    """bf16 inputs: fp32 softmax/accumulate, loose elementwise tolerance."""
    T, D = 512, 64
    mask = build_block_mask(T, T, 128, window=3, causal=True)
    q, k, v = (jnp.asarray(x, jnp.bfloat16)
               for x in _qkv(np.random.default_rng(24), (T, D)))
    _check_vs_dense(q, k, v, mask, fwd_tol=5e-2, grad_tol=0.15)


def test_bsa_impl_dispatch():
    """One path on every backend: jit and eager agree."""
    T, D = 256, 64
    mask = build_block_mask(T, T, 128, window=2, causal=True)
    q, k, v = (jnp.asarray(x) for x in _qkv(np.random.default_rng(14),
                                            (T, D)))
    a = np.asarray(block_sparse_attention(q, k, v, mask))
    x = np.asarray(jax.jit(lambda q, k, v: block_sparse_attention(
        q, k, v, mask))(q, k, v))
    np.testing.assert_allclose(a, x, rtol=1e-6, atol=1e-7)


def test_hybrid_grad_dispatch_matches_xla():
    """Gradients under jit equal the eager gradients."""
    T, D = 512, 64
    mask = build_block_mask(T, T, 128, window=2, causal=True)
    q, k, v = (jnp.asarray(x) for x in _qkv(np.random.default_rng(31),
                                            (T, D)))
    fn = lambda a, b, c: block_sparse_attention(a, b, c, mask)  # noqa: E731
    ge = _grads(fn, q, k, v)
    gj = jax.jit(lambda a, b, c: _grads(fn, a, b, c))(q, k, v)
    for name, a, b in zip("qkv", ge, gj):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6, err_msg=f"d{name}")


def test_block_mask_from_csr_graph_pattern():
    """Data-derived attention pattern: every nnz of the (reordered) matrix
    lands inside a mask block; reordering concentrates the pattern into
    fewer blocks; attention through the pattern matches the dense oracle."""
    from sparta_tpu.formats import random_block_csr
    from sparta_tpu.ops.attention import block_mask_from_csr
    from sparta_tpu.reorder import BlockingEngine
    from sparta_tpu.definitions import BlockingType

    b = 16
    m = random_block_csr(8 * b, 8 * b, block=b, block_density=0.2,
                         intra_density=0.5, seed=3)  # shuffled rows
    mask_nat = block_mask_from_csr(m, b)
    # coverage: every nonzero inside some block
    dm = dense_mask_from_block_mask(mask_nat)
    coo = m.to_scipy().tocoo()
    sym = set(zip(coo.row.tolist(), coo.col.tolist()))
    sym |= {(c, r) for r, c in sym}
    assert all(dm[r, c] for r, c in sym)

    eng = BlockingEngine(tau=0.3, col_block_size=b, row_block_size=b,
                         blocking_algo=BlockingType.iterative_clocked,
                         force_fixed_size=True)
    grouping = eng.get_grouping(m)
    mask_re = block_mask_from_csr(m, b, grouping=grouping)
    assert mask_re.n_blocks <= mask_nat.n_blocks  # reorder concentrates

    # attention through the data-derived pattern == dense-masked oracle
    rng = np.random.default_rng(0)
    T = mask_nat.nbr * b
    q, k, v = _qkv(rng, (T, 64))
    got = np.asarray(block_sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask_nat))
    ref = _dense_attention(q, k, v, dm, 1.0 / np.sqrt(64))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_block_mask_from_csr_causal_and_diagonal():
    """causal=True keeps lower-triangular blocks + intra-block tri; the
    diagonal is always present so no softmax row is empty."""
    from sparta_tpu.formats.csr import rmat_csr
    from sparta_tpu.ops.attention import block_mask_from_csr

    m = rmat_csr(7, edge_factor=2, seed=1)
    mask = block_mask_from_csr(m, 16, causal=True)
    assert all(j <= i for i, j in zip(mask.br, mask.bc))
    assert mask.causal
    diag = {(i, i) for i in range(mask.nbr)}
    assert diag <= set(zip(mask.br, mask.bc))
    dm = dense_mask_from_block_mask(mask)
    assert dm.diagonal().all()


@pytest.mark.parametrize("causal", [False, True])
def test_bsa_pallas_multichunk_forward_and_grad(causal):
    """A dense pattern at 12 block rows (many key tiles per query tile)."""
    T, D = 12 * 128, 64
    mask = build_block_mask(T, T, 128, window=None, causal=causal)
    q, k, v = (jnp.asarray(x) for x in _qkv(np.random.default_rng(21),
                                            (2, T, D)))
    _check_vs_dense(q, k, v, mask)


@pytest.mark.parametrize("window", [2, 4])
def test_bsa_pallas_v2_rows_per_step(window):
    """Window + global pattern at T=1024 (the train-step shape class)."""
    T, D = 1024, 64
    mask = build_block_mask(T, T, 128, window=window, causal=True,
                            global_blocks=1)
    q, k, v = (jnp.asarray(x) for x in _qkv(np.random.default_rng(33),
                                            (2, T, D)))
    _check_vs_dense(q, k, v, mask)
