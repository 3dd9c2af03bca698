"""Fine-grained (non-blocked) SpMM: FineDevice gather + segment-sum,
DedupDevice gather + batched-dot combine, FellDevice virtual rows.

Reference capability: cusparse_gemm_custom
(cuda_utilities.cpp:1251-1431) — the fine-grained
sparse kernel for matrices too sparse to block."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparta_tpu.formats.csr import CSR, random_uniform_csr, rmat_csr
from sparta_tpu.ops.fine import (
    DedupDevice,
    FellDevice,
    FineDevice,
    choose_width,
    dedup_combine,
    dedup_spmm,
    fell_slots,
    fell_spmm,
    fine_spmm,
    mask_combine,
)


def _dense_oracle(m: CSR, B: np.ndarray) -> np.ndarray:
    return m.to_dense() @ B


@pytest.mark.parametrize("N", [512, 1024])
def test_fine_spmm_matches_dense_uniform(N):
    m = random_uniform_csr(300, 400, density=0.01, seed=3)
    B = np.random.default_rng(0).standard_normal((400, N)).astype(np.float32)
    dev = FineDevice.from_csr(m, dtype=jnp.float32)
    C = np.asarray(fine_spmm(dev, jnp.asarray(B)))
    assert C.shape == (300, N)
    np.testing.assert_allclose(C, _dense_oracle(m, B), rtol=1e-4, atol=1e-4)


def test_fine_spmm_powerlaw_hubs_and_empty_rows():
    """RMAT graph: hub rows spanning many combine chunks + empty rows."""
    m = rmat_csr(9, edge_factor=8, seed=5)
    assert (m.row_nnz == 0).any(), "want empty rows in the test graph"
    B = np.random.default_rng(1).standard_normal((m.cols, 512)).astype(
        np.float32)
    dev = FineDevice.from_csr(m, dtype=jnp.float32)
    C = np.asarray(fine_spmm(dev, jnp.asarray(B)))
    np.testing.assert_allclose(C, _dense_oracle(m, B), rtol=1e-3, atol=1e-3)


def test_fine_spmm_bf16():
    m = random_uniform_csr(200, 200, density=0.02, seed=7)
    B = np.random.default_rng(2).standard_normal((200, 512)).astype(
        np.float32)
    dev = FineDevice.from_csr(m, dtype=jnp.bfloat16)
    C = np.asarray(fine_spmm(dev, jnp.asarray(B, dtype=jnp.bfloat16))
                   ).astype(np.float32)
    ref = _dense_oracle(m, B)
    denom = np.abs(ref).max() + 1e-9
    assert np.abs(C - ref).max() / denom < 3e-2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_combine_matches_scipy(seed):
    """The segment-sum combine == scipy's CSR product for the same
    per-nonzero contributions (vals * B[cols])."""
    m = rmat_csr(8, edge_factor=6, seed=seed)
    B = np.random.default_rng(seed).standard_normal((m.cols, 64)).astype(
        np.float32)
    rows = np.repeat(np.arange(m.rows), m.row_nnz)
    contrib = m.values()[:, None] * B[m.indices]
    got = np.asarray(mask_combine(jnp.asarray(rows, jnp.int32),
                                  jnp.asarray(contrib), m.rows))
    np.testing.assert_allclose(got, m.to_scipy() @ B, rtol=1e-4, atol=1e-4)


def test_fine_empty_matrix():
    m = CSR.from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64),
                     np.zeros(0, np.float32), (5, 7))
    dev = FineDevice.from_csr(m, dtype=jnp.float32)
    C = np.asarray(fine_spmm(dev, jnp.ones((7, 16), jnp.float32)))
    assert C.shape == (5, 16) and not C.any()


# ------------------------------------------------------------ DEDUP ----
def test_dedup_spmm_matches_dense():
    """Distinct-column dedup path: duplicates within a tile share one
    gathered row; values fold into the dense W operand."""
    m = rmat_csr(9, edge_factor=8, seed=5)  # hub cols -> real dedup
    B = np.random.default_rng(1).standard_normal((m.cols, 512)).astype(
        np.float32)
    dev = DedupDevice.from_csr(m, dtype=jnp.float32, tile_rows=128,
                               chunk=128)
    ntiles = -(-m.rows // 128)
    assert dev.n_slots < m.nnz + ntiles * 128  # dedup + < 1 chunk padding
    C = np.asarray(dedup_spmm(dev, jnp.asarray(B)))
    np.testing.assert_allclose(C, _dense_oracle(m, B), rtol=1e-3, atol=1e-3)


def test_fine_dedup_narrow_slab_correct():
    """An operand width that is no power of two (N=768): fine and dedup vs
    the dense oracle."""
    m = rmat_csr(9, edge_factor=8, seed=6)
    B = np.random.default_rng(7).standard_normal((m.cols, 768)).astype(
        np.float32)
    fdev = FineDevice.from_csr(m, dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(fine_spmm(fdev, jnp.asarray(B))),
                               _dense_oracle(m, B), rtol=1e-3, atol=1e-3)
    ddev = DedupDevice.from_csr(m, dtype=jnp.float32)
    np.testing.assert_allclose(
        np.asarray(dedup_spmm(ddev, jnp.asarray(B))),
        _dense_oracle(m, B), rtol=1e-3, atol=1e-3)


def test_dedup256_candidate_and_pricing():
    """The 256-row-tile dedup variant: counted in csr_work_table with its
    own distinct-pair count, buildable via csr_candidate_fn, and correct."""
    from sparta_tpu.ops.csr_spmm import csr_candidate_fn, csr_work_table

    m = rmat_csr(11, edge_factor=8, seed=5)
    table, aux = csr_work_table(m, 512, dtype=jnp.float32)
    assert "dedup256" in table
    # bigger tiles can only merge MORE (tile, col) pairs
    assert aux["dedup256_n_uniq"] <= aux["dedup_n_uniq"]
    assert np.isfinite(table["dedup256"])
    B = np.random.default_rng(4).standard_normal((m.cols, 512)).astype(
        np.float32)
    fn = csr_candidate_fn(m, 512, "dedup256", dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(fn(jnp.asarray(B))),
                               _dense_oracle(m, B), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("chunk", [16, 256, 2048])
def test_dedup_spmm_tail_chunk_overrun(chunk):
    """Each tile's slots pad to a chunk multiple with zero-weight dead
    slots; any chunk size (smaller or larger than a tile's slots) gives
    the same product."""
    m = random_uniform_csr(300, 400, density=0.02, seed=3)
    B = np.random.default_rng(2).standard_normal((400, 512)).astype(
        np.float32)
    dev = DedupDevice.from_csr(m, dtype=jnp.float32, tile_rows=128,
                               chunk=chunk)
    assert dev.n_slots % chunk == 0
    C = np.asarray(dedup_spmm(dev, jnp.asarray(B)))
    np.testing.assert_allclose(C, _dense_oracle(m, B), rtol=1e-4, atol=1e-4)


def test_dedup_spmm_int8_b():
    m = rmat_csr(9, edge_factor=8, seed=5)
    B = np.random.default_rng(3).standard_normal((m.cols, 512)).astype(
        np.float32)
    dev = DedupDevice.from_csr(m, dtype=jnp.float32, tile_rows=128,
                               chunk=128)
    C = np.asarray(dedup_spmm(dev, jnp.asarray(B), b_int8=True),
                   np.float32)
    ref = _dense_oracle(m, B)
    denom = np.abs(ref).max() + 1e-9
    assert np.abs(C - ref).max() / denom < 2e-2


def test_dedup_duplicate_coo_entries_sum():
    """Stored duplicate (row, col) entries accumulate into one W cell —
    same semantics as the serial CSR.multiply oracle (which sums every
    stored entry)."""
    rows = np.array([0, 0, 5, 5, 5])
    cols = np.array([3, 3, 7, 7, 2])
    vals = np.array([1.0, 2.0, 4.0, 8.0, 16.0], dtype=np.float32)
    m = CSR.from_coo(rows, cols, vals, (130, 10))
    dev = DedupDevice.from_csr(m, dtype=jnp.float32, chunk=128)
    eye = np.eye(10, 128, dtype=np.float32)
    C = np.asarray(dedup_spmm(dev, jnp.asarray(eye)))
    np.testing.assert_allclose(C[:, :10], m.multiply(np.eye(10, dtype=np.float32)))


def test_dedup_spmm_wide_n_single_pass():
    """A wide operand (N=1536) in one gather and one combine."""
    m = rmat_csr(9, edge_factor=8, seed=7)
    B = np.random.default_rng(4).standard_normal((m.cols, 1536)).astype(
        np.float32)  # 3 slabs of 512
    dev = DedupDevice.from_csr(m, dtype=jnp.float32, tile_rows=128,
                               chunk=128)
    C = np.asarray(dedup_spmm(dev, jnp.asarray(B)))
    np.testing.assert_allclose(C, _dense_oracle(m, B), rtol=1e-3, atol=1e-3)


def test_dedup_spmm_wide_n_int8():
    """Wide-N with int8-gathered B: one [1, N] dequant row applied after
    the combine."""
    m = rmat_csr(8, edge_factor=6, seed=9)
    B = np.random.default_rng(5).standard_normal((m.cols, 1024)).astype(
        np.float32)
    dev = DedupDevice.from_csr(m, dtype=jnp.float32, tile_rows=128,
                               chunk=128)
    C = np.asarray(dedup_spmm(dev, jnp.asarray(B), b_int8=True), np.float32)
    ref = _dense_oracle(m, B)
    denom = np.abs(ref).max() + 1e-9
    assert np.abs(C - ref).max() / denom < 2e-2


@pytest.mark.parametrize("R,chunk", [(128, 64), (256, 128)])
def test_dedup_combine_matches_scipy(R, chunk):
    """The batched-dot combine == scipy's product, straight from the
    packed weights and the gathered distinct rows."""
    m = rmat_csr(9, edge_factor=6, seed=R)
    B = np.random.default_rng(1).standard_normal((m.cols, 96)).astype(
        np.float32)
    dev = DedupDevice.from_csr(m, dtype=jnp.float32, tile_rows=R,
                               chunk=chunk)
    bg = jnp.asarray(B)[dev.gidx]
    got = np.asarray(dedup_combine(dev.chunk_tile, dev.W, bg,
                                   dev.padded_rows, R=R, C=chunk))
    np.testing.assert_allclose(got[: m.rows], m.to_scipy() @ B, rtol=1e-4,
                               atol=1e-4)
    assert not got[m.rows:].any()


# ------------------------------------------------------------- FELL ----
def test_fell_spmm_matches_dense():
    m = rmat_csr(10, edge_factor=8, seed=3)
    B = np.random.default_rng(0).standard_normal((m.cols, 64)).astype(
        np.float32)
    ref = _dense_oracle(m, B)
    for w in (4, 8, 16):
        dev = FellDevice.from_csr(m, width=w)
        C = np.asarray(fell_spmm(dev, jnp.asarray(B)))
        np.testing.assert_allclose(C, ref, rtol=1e-4, atol=1e-4)


def test_fell_bf16_accumulates_fp32():
    """bf16 storage must not mean bf16 ACCUMULATION: W-deep bf16 adds plus
    a bf16 segment-sum measured 6e-2 normalized error on power-law graphs
    (over the 1e-2 matched-accuracy bar). The product accumulates fp32."""
    m = rmat_csr(11, edge_factor=16, seed=5)
    rng = np.random.default_rng(1)
    B = rng.standard_normal((m.cols, 256)).astype(np.float32)
    ref = _dense_oracle(m, B)
    dev = FellDevice.from_csr(m, width=32, dtype=jnp.bfloat16)
    C = np.asarray(fell_spmm(dev, jnp.asarray(B, dtype=jnp.bfloat16)),
                   dtype=np.float32)
    err = np.abs(C - ref).max() / (np.abs(ref).max() + 1e-9)
    assert err < 1e-2, f"normalized error {err:.2e}"


def test_fell_empty_rows():
    vals = np.array([1.0, 2.0, 3.0], dtype=np.float32)
    m = CSR.from_coo(np.array([0, 0, 4]), np.array([1, 3, 2]), vals, (6, 5))
    dev = FellDevice.from_csr(m, width=4)
    C = np.asarray(fell_spmm(dev, jnp.asarray(np.eye(5, dtype=np.float32))))
    np.testing.assert_allclose(C, m.to_dense())


def test_fell_slots_and_width():
    L = np.array([0, 1, 5, 100])
    n_virt, slots = fell_slots(L, 4)
    assert n_virt == 0 + 1 + 2 + 25
    assert slots == n_virt * 4
    w = choose_width(L)
    assert w in (4, 8, 16, 32, 64)
    # the least padded slots plus virtual rows among the widths
    assert sum(fell_slots(L, w)) == min(sum(fell_slots(L, v))
                                        for v in (4, 8, 16, 32, 64))


def test_csr_auto_picks_fine_on_powerlaw():
    """A low-fill power-law graph routes to the fine family when nothing
    is measured (the fewest multiply-adds)."""
    from sparta_tpu.ops.csr_spmm import csr_spmm_auto

    m = rmat_csr(12, edge_factor=4, seed=2)
    fn, name, flops = csr_spmm_auto(m, 512, dtype=jnp.bfloat16)
    assert name.startswith("csr_auto_fine"), name
    B = np.random.default_rng(3).standard_normal((m.cols, 512)).astype(
        np.float32)
    C = np.asarray(fn(jnp.asarray(B, dtype=jnp.bfloat16))).astype(np.float32)
    ref = np.asarray(m.to_scipy() @ B)
    denom = np.abs(ref).max() + 1e-9
    assert np.abs(C[: m.rows] - ref).max() / denom < 3e-2


def test_dedup_spmm_ad_grad_matches_dense():
    """Custom VJP: dB = A^T @ dC through the transpose-packed device."""
    from sparta_tpu.ops.fine import dedup_pair_from_csr, dedup_spmm_ad

    m = rmat_csr(8, edge_factor=6, seed=2)
    dev, devT = dedup_pair_from_csr(m, dtype=jnp.float32, chunk=128)
    rng = np.random.default_rng(0)
    for N in (128, 1024):  # single slab and wide-N (one-pass combine)
        B = jnp.asarray(rng.standard_normal((m.cols, N)).astype(np.float32))
        T = jnp.asarray(rng.standard_normal((m.rows, N)).astype(np.float32))

        def loss(b):
            return jnp.sum(dedup_spmm_ad(dev, devT, b) * T)

        g = np.asarray(jax.grad(loss)(B))
        A = m.to_dense()
        g_ref = A.T @ np.asarray(T)
        np.testing.assert_allclose(g, g_ref, rtol=1e-4, atol=1e-4)
        v_ref = float((A @ np.asarray(B) * np.asarray(T)).sum())
        assert abs(float(loss(B)) - v_ref) / abs(v_ref) < 1e-4


def test_gcn_fine_adjacency_trains():
    """GCN with adjacency='fine': power-law graph, no blocking/reordering,
    loss decreases through the dedup kernel's custom VJP."""
    import optax

    from sparta_tpu.models.gcn import GCN, GCNConfig, make_gcn_train_step

    m = rmat_csr(8, edge_factor=6, seed=2)
    cfg = GCNConfig(in_dim=16, hidden_dim=128, out_dim=4, n_layers=2,
                    adjacency="fine")
    gcn = GCN.create(m, cfg)
    params = gcn.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((m.rows, 16)).astype(np.float32))
    labels = jnp.asarray(rng.integers(0, 4, m.rows))
    mask = jnp.ones(m.rows)
    opt = optax.adam(1e-2)
    step = make_gcn_train_step(gcn, opt)
    st = opt.init(params)
    first = None
    for _ in range(25):
        params, st, loss = step(params, st, X, labels, mask)
        if first is None:
            first = float(loss)
    assert float(loss) < first * 0.8


def test_fine_spmm_int8_gather_accuracy():
    """b_int8 gathers a per-column int8 quantization of B: half the gather
    traffic at ~1e-3 normalized error (mirrors dedup_spmm's option)."""
    m = rmat_csr(9, edge_factor=8, seed=4)
    rng = np.random.default_rng(2)
    B = rng.standard_normal((m.cols, 256)).astype(np.float32)
    ref = _dense_oracle(m, B)
    dev = FineDevice.from_csr(m, dtype=jnp.bfloat16)
    C = np.asarray(fine_spmm(dev, jnp.asarray(B, jnp.bfloat16), b_int8=True),
                   np.float32)
    err = np.abs(C - ref).max() / (np.abs(ref).max() + 1e-9)
    assert err < 1e-2, f"normalized error {err:.2e}"
