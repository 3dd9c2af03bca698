"""Device SpMM tests (CPU backend; the Triton kernel in interpret mode).

Oracle = host serial multiply / scipy, as in the reference's TEST_cuda
memcmp strategy but with tolerances (fp32 accumulate).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparta_tpu.formats import bell_from_csr, random_block_csr, random_uniform_csr  # noqa: F401
from sparta_tpu.ops import (
    BellDevice,
    EllDevice,
    bcoo_spmm,
    bell_spmm_triton,
    bell_spmm_xla,
    bell_spmm_xla_ba,
    bell_spmm_xla_unrolled,
    csr_to_bcoo,
    dense_matmul,
    ell_spmm,
    pad_b_for_bell,
)
from sparta_tpu.utils import get_permutation


@pytest.fixture(scope="module")
def problem():
    m = random_block_csr(256, 256, block=8, block_density=0.15, intra_density=0.7, seed=3)
    grouping = np.arange(256) // 8
    bell = bell_from_csr(m, grouping, block_row_size=8)
    B = np.random.default_rng(0).standard_normal((256, 64)).astype(np.float32)
    C_ref = m.to_scipy() @ B
    return m, bell, B, C_ref


def test_bell_spmm_xla(problem):
    m, bell, B, C_ref = problem
    dev = BellDevice.from_host(bell)
    C = bell_spmm_xla(dev, pad_b_for_bell(B, bell))
    np.testing.assert_allclose(np.asarray(C)[: m.rows], C_ref, rtol=1e-4, atol=1e-4)


def test_bell_spmm_xla_unrolled(problem):
    m, bell, B, C_ref = problem
    dev = BellDevice.from_host(bell)
    C = bell_spmm_xla_unrolled(dev, pad_b_for_bell(B, bell))
    np.testing.assert_allclose(np.asarray(C)[: m.rows], C_ref, rtol=1e-4, atol=1e-4)


def test_bell_spmm_xla_reordered():
    m = random_block_csr(128, 128, block=16, block_density=0.2, seed=9)
    from sparta_tpu.definitions import BlockingType
    from sparta_tpu.reorder import BlockingEngine

    eng = BlockingEngine(tau=0.6, col_block_size=16, row_block_size=16,
                         blocking_algo=BlockingType.iterative_max_size,
                         force_fixed_size=True, backend="numpy")
    g = eng.get_grouping(m)
    bell = bell_from_csr(m, g, block_row_size=16)
    B = np.random.default_rng(1).standard_normal((m.cols, 32)).astype(np.float32)
    C = bell_spmm_xla(BellDevice.from_host(bell), pad_b_for_bell(B, bell))
    C_ref = (m.to_scipy() @ B)[get_permutation(g)]
    np.testing.assert_allclose(np.asarray(C)[: m.rows], C_ref, rtol=1e-4, atol=1e-4)


def test_bell_spmm_ba(problem):
    m, bell, B, C_ref = problem
    dev = BellDevice.from_host(bell)
    N = 32
    Bl = np.random.default_rng(2).standard_normal((N, bell.shape[0])).astype(np.float32)
    C = bell_spmm_xla_ba(dev, jnp.asarray(Bl), n_block_cols=bell.n_block_cols)
    C_ref2 = Bl[:, : m.rows] @ m.to_scipy()
    np.testing.assert_allclose(np.asarray(C)[:, : m.cols], C_ref2, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def problem16():
    """The kernel's tile rule wants power-of-two blocks of at least 16."""
    m = random_block_csr(256, 256, block=16, block_density=0.15,
                         intra_density=0.7, seed=3)
    bell = bell_from_csr(m, np.arange(256) // 16, block_row_size=16)
    B = np.random.default_rng(0).standard_normal((256, 64)).astype(np.float32)
    return m, bell, B, m.to_scipy() @ B


def _ragged_bell(b=16, nbr=12, nbc=12, seed=4):
    """Heavy-tailed row block counts, empty rows included."""
    from sparta_tpu.formats import BELL

    rng = np.random.default_rng(seed)
    nb_row = np.array([nbc, 1, 0, 2, 1, 1, 8, 1, 0, 1, 2, 1][:nbr],
                      dtype=np.int32)
    max_nb = int(nb_row.max())
    cols = np.full((nbr, max_nb), -1, dtype=np.int32)
    vals = np.zeros((nbr, max_nb, b, b), dtype=np.float32)
    dense = np.zeros((nbr * b, nbc * b), dtype=np.float32)
    for r in range(nbr):
        sel = np.sort(rng.choice(nbc, size=nb_row[r], replace=False))
        cols[r, : sel.size] = sel
        for t, jb in enumerate(sel):
            blk = rng.standard_normal((b, b)).astype(np.float32)
            vals[r, t] = blk
            dense[r*b:(r+1)*b, jb*b:(jb+1)*b] = blk
    bell = BELL(cols_idx=cols, nb_row=nb_row, vals=vals,
                row_perm=np.arange(nbr * b), block_row_size=b,
                block_col_size=b, shape=(nbr * b, nbc * b),
                orig_shape=(nbr * b, nbc * b))
    return bell, dense


def test_bell_spmm_pallas_interpret(problem16):
    m, bell, B, C_ref = problem16
    dev = BellDevice.from_host(bell)
    C = bell_spmm_triton(dev, pad_b_for_bell(B, bell), interpret=True)
    np.testing.assert_allclose(np.asarray(C)[: m.rows], C_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("N", [256, 300])
def test_bell_spmm_pallas_multiple_col_tiles(problem16, N):
    """N wider than the column tile: several N tiles, the last one ragged
    when N is not a multiple of it."""
    from sparta_tpu.ops.blocked import TILE_N

    assert N > TILE_N
    m, bell, _, _ = problem16
    B = np.random.default_rng(N).standard_normal((256, N)).astype(np.float32)
    C = bell_spmm_triton(BellDevice.from_host(bell), jnp.asarray(B),
                         interpret=True)
    assert C.shape == (bell.shape[0], N)
    np.testing.assert_allclose(np.asarray(C)[: m.rows], m.to_scipy() @ B,
                               rtol=1e-4, atol=1e-4)


def test_bell_spmm_pallas_empty_rows():
    # block-rows with zero blocks must produce zero stripes
    from sparta_tpu.formats import CSR

    r = np.array([1, 3, 60, 63])
    c = np.array([5, 40, 2, 63])
    m = CSR.from_coo(r, c, np.ones(4, dtype=np.float32), (64, 64))
    bell = bell_from_csr(m, None, block_row_size=16)
    assert (bell.nb_row == 0).any()
    B = np.random.default_rng(3).standard_normal((64, 16)).astype(np.float32)
    C = bell_spmm_triton(BellDevice.from_host(bell), pad_b_for_bell(B, bell),
                         interpret=True)
    C_ref = m.to_scipy() @ B
    np.testing.assert_allclose(np.asarray(C)[: m.rows], C_ref, rtol=1e-4, atol=1e-4)


def test_csr_baselines(problem):
    m, bell, B, C_ref = problem
    C1 = bcoo_spmm(csr_to_bcoo(m), jnp.asarray(B))
    np.testing.assert_allclose(np.asarray(C1), C_ref, rtol=1e-4, atol=1e-4)
    C2 = ell_spmm(EllDevice.from_csr(m), jnp.asarray(B))
    np.testing.assert_allclose(np.asarray(C2), C_ref, rtol=1e-4, atol=1e-4)


def test_bcoo_spmm_wide_scan_under_jit(problem):
    """B wider than the slab limit runs slabs under lax.scan so a jitted
    caller traces ONE slab-sized scatter program (the slab bound must
    survive an outer jit)."""
    m, bell, B, C_ref = problem
    A = csr_to_bcoo(m)
    Bw = jnp.asarray(np.tile(B, (1, max(1024 // B.shape[1], 2))))
    caller = jax.jit(lambda b: bcoo_spmm(A, b, max_cols=B.shape[1]) * 1.0)
    Cw = np.asarray(caller(Bw))
    ref = np.asarray(m.to_scipy() @ np.asarray(Bw))
    np.testing.assert_allclose(Cw, ref, rtol=1e-4, atol=1e-4)


def test_dense_baseline(problem):
    m, bell, B, C_ref = problem
    C = dense_matmul(jnp.asarray(m.to_dense()), jnp.asarray(B))
    np.testing.assert_allclose(np.asarray(C), C_ref, rtol=1e-4, atol=1e-4)


def test_bf16_matched_accuracy(problem):
    """bf16 storage w/ fp32 accumulate: <=1e-2 relative error vs fp32 oracle."""
    m, bell, B, C_ref = problem
    dev = BellDevice.from_host(bell, dtype=jnp.bfloat16)
    C = bell_spmm_xla(dev, pad_b_for_bell(B, bell).astype(jnp.bfloat16))
    err = np.abs(np.asarray(C, dtype=np.float32)[: m.rows] - C_ref)
    rel = err.max() / (np.abs(C_ref).max() + 1e-9)
    assert rel < 1e-2


def test_bell_spmm_bcache(problem16):
    """The routed entry point: the kernel under interpret, XLA otherwise,
    same result."""
    from sparta_tpu.ops import blocked_spmm

    m, bell, B, C_ref = problem16
    dev = BellDevice.from_host(bell)
    for interpret in (False, True):
        C = np.asarray(blocked_spmm(dev, jnp.asarray(B), interpret=interpret))
        np.testing.assert_allclose(C[: m.rows], C_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows_per_step", [1, 2, 4])
def test_bell_spmm_compact_multirow(rows_per_step):
    """Row tiles smaller than the block (bm = bh / rows_per_step): each
    block-row runs as several programs."""
    m = random_block_csr(256, 256, block=64, block_density=0.3,
                         intra_density=0.6, seed=5)
    bell = bell_from_csr(m, None, block_row_size=64)
    B = np.random.default_rng(1).standard_normal((256, 32)).astype(np.float32)
    C = np.asarray(bell_spmm_triton(
        BellDevice.from_host(bell), jnp.asarray(B),
        bm=64 // rows_per_step, interpret=True))
    np.testing.assert_allclose(C[:256], m.to_scipy() @ B, rtol=1e-5,
                               atol=1e-5)


def test_bell_spmm_compact_multirow_padded_rows():
    """Padding block-rows (from pad_block_rows) produce zero output rows."""
    from sparta_tpu.parallel import pad_block_rows

    m = random_block_csr(80, 80, block=16, block_density=0.3,
                         intra_density=0.7, seed=11)
    bell = pad_block_rows(bell_from_csr(m, None, block_row_size=16), 4)
    assert bell.n_block_rows == 8
    B = np.random.default_rng(1).standard_normal((bell.shape[1], 32)).astype(
        np.float32)
    C = np.asarray(bell_spmm_triton(BellDevice.from_host(bell),
                                    jnp.asarray(B), interpret=True))
    np.testing.assert_allclose(C[:80], m.to_scipy() @ B[:80], rtol=1e-5,
                               atol=1e-5)
    assert np.all(C[80:] == 0)


@pytest.mark.parametrize("N", [1, 17, 48, 100])
def test_bell_spmm_compact_chunked(problem16, N):
    """Any operand width: N pads up to the column tile and slices back."""
    m, bell, B, C_ref = problem16
    Bn = np.random.default_rng(N).standard_normal((256, N)).astype(np.float32)
    C = np.asarray(bell_spmm_triton(BellDevice.from_host(bell),
                                    jnp.asarray(Bn), interpret=True))
    assert C.shape == (bell.shape[0], N)
    np.testing.assert_allclose(C[: m.rows], m.to_scipy() @ Bn, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("N", [16, 40, 64])
def test_bell_spmm_compact_unrolled(problem16, N):
    """Operands narrower than the column tile: one tile as wide as N (to
    the next power of two), padded and sliced back."""
    m, bell, _, _ = problem16
    B = np.random.default_rng(N).standard_normal((256, N)).astype(np.float32)
    C = np.asarray(bell_spmm_triton(BellDevice.from_host(bell),
                                    jnp.asarray(B), bm=16, interpret=True))
    np.testing.assert_allclose(C[: m.rows], m.to_scipy() @ B, rtol=1e-5,
                               atol=1e-5)


def test_bell_spmm_compact_gather():
    """Large K relative to the stored blocks (the old huge-K layouts): the
    kernel reads only the stripes its blocks name."""
    m = random_block_csr(64, 2048, block=16, block_density=0.02,
                         intra_density=0.8, seed=2)
    bell = bell_from_csr(m, None, block_row_size=16)
    B = np.random.default_rng(2).standard_normal((2048, 32)).astype(
        np.float32)
    C = np.asarray(bell_spmm_triton(BellDevice.from_host(bell),
                                    jnp.asarray(B), interpret=True))
    np.testing.assert_allclose(C[:64], m.to_scipy() @ B, rtol=1e-5,
                               atol=1e-5)


def test_bell_spmm_compact_gather_ragged():
    """Heavy-tailed row block counts, empty rows included."""
    bell, dense = _ragged_bell()
    B = np.random.default_rng(5).standard_normal((bell.shape[1], 32)).astype(
        np.float32)
    C = np.asarray(bell_spmm_triton(BellDevice.from_host(bell),
                                    jnp.asarray(B), interpret=True))
    np.testing.assert_allclose(C, dense @ B, rtol=1e-5, atol=1e-5)


def test_plan_spmm_selection_and_correctness(problem):
    from sparta_tpu.ops import plan_spmm

    m, bell, B, C_ref = problem
    # 8x8 blocks are not kernel-tileable -> XLA path
    plan = plan_spmm(bell, 64)
    assert plan.backend == "bell_xla"
    C = np.asarray(plan(jnp.asarray(B[:, :64])))
    np.testing.assert_allclose(C[: m.rows], C_ref[:, :64], rtol=1e-5, atol=1e-5)


def test_plan_spmm_unrolled_and_gather_paths(monkeypatch):
    """Every candidate builds and computes the same product; off the GPU
    the rule never picks the kernel."""
    import sparta_tpu.ops.select as sel

    m = random_block_csr(512, 512, block=128, block_density=0.3,
                         intra_density=0.3, seed=6)
    bell = bell_from_csr(m, None, block_row_size=128)
    B = np.random.default_rng(1).standard_normal((512, 128)).astype(np.float32)
    C_ref = m.to_scipy() @ B
    assert sel._candidates(bell, jnp.float32) == ["xla", "dense"]
    assert sel.plan_spmm(bell, 128).backend == "bell_xla"
    for kind in ("xla", "dense"):
        plan = sel._build_plan(bell, kind, jnp.float32)
        C = np.asarray(plan(jnp.asarray(pad_b_for_bell(B, bell))))
        np.testing.assert_allclose(C[:512], C_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend,bh,bw,interpret,want", [
    ("cpu", 128, 128, False, "xla"),
    ("cpu", 128, 128, True, "triton"),
    ("gpu", 128, 128, False, "triton"),
    ("gpu", 16, 64, False, "triton"),
    ("gpu", 8, 128, False, "xla"),
    ("gpu", 128, 96, False, "xla"),
    ("gpu", 3, 3, True, "xla"),
])
def test_spmm_route(monkeypatch, backend, bh, bw, interpret, want):
    """The one routing function: the kernel on the GPU (or when a test asks
    for the interpreter), XLA on the CPU and for untileable blocks."""
    import sparta_tpu.ops.blocked as blk

    monkeypatch.setattr(blk.jax, "default_backend", lambda: backend)
    assert blk.spmm_route(bh, bw, interpret) == want


def test_xla_route_overrides_gpu(monkeypatch):
    import sparta_tpu.ops.blocked as blk

    monkeypatch.setattr(blk.jax, "default_backend", lambda: "gpu")
    assert blk.spmm_route(128, 128) == "triton"
    with blk.xla_route():
        assert blk.spmm_route(128, 128) == "xla"
        assert blk.spmm_route(128, 128, interpret=True) == "triton"
    assert blk.spmm_route(128, 128) == "triton"


def test_plan_spmm_autotune_cache_roundtrip(tmp_path, monkeypatch):
    """Autotuned winners persist: the second plan_spmm for the same
    structure builds straight from the cache (no re-measurement), and a
    cached plan computes correctly."""
    import sparta_tpu.bench.timing as timing
    import sparta_tpu.ops.select as sel

    monkeypatch.setenv("SPARTA_TPU_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    m = random_block_csr(512, 512, block=128, block_density=0.3,
                         intra_density=0.3, seed=6)
    bell = bell_from_csr(m, None, block_row_size=128)
    B = np.random.default_rng(1).standard_normal((512, 128)).astype(
        np.float32)
    C_ref = m.to_scipy() @ B

    calls = []
    real_time_op = timing.time_op

    def counting_time_op(*a, **k):
        calls.append(1)
        return real_time_op(*a, **k)

    monkeypatch.setattr(timing, "time_op", counting_time_op)
    plan1 = sel.plan_spmm(bell, 128, autotune=True)
    assert len(calls) == 2, "both candidates (xla, dense) are measured"
    assert (tmp_path / "autotune.json").exists()

    calls.clear()
    plan2 = sel.plan_spmm(bell, 128, autotune=True)
    assert not calls, "second call must hit the cache"
    assert plan2.backend == plan1.backend
    C = np.asarray(plan2(jnp.asarray(pad_b_for_bell(B, bell))))
    np.testing.assert_allclose(C[:512], C_ref, rtol=1e-4, atol=1e-4)

    # a different N is a different key -> measures again
    sel.plan_spmm(bell, 256, autotune=True)
    assert calls


def test_autotune_off_gpu_by_default(monkeypatch):
    """plan_spmm measures only on the GPU unless asked."""
    import sparta_tpu.bench.timing as timing
    import sparta_tpu.ops.select as sel

    def boom(*a, **k):
        raise AssertionError("measured on the CPU")

    monkeypatch.setattr(timing, "time_op", boom)
    m = random_block_csr(256, 256, block=128, block_density=0.5, seed=2)
    bell = bell_from_csr(m, None, block_row_size=128)
    assert sel.plan_spmm(bell, 128).backend in ("bell_xla",
                                                "bell_densified_gemm")


@pytest.mark.parametrize("relu", [False, True])
def test_bell_spmm_unrolled_epilogue(problem16, relu):
    m, bell, B, C_ref = problem16
    bias = np.random.default_rng(9).standard_normal(bell.shape[0]).astype(
        np.float32)
    C = np.asarray(bell_spmm_triton(
        BellDevice.from_host(bell), jnp.asarray(B), bias=jnp.asarray(bias),
        relu=relu, interpret=True))
    want = C_ref + bias[: m.rows, None]
    if relu:
        want = np.maximum(want, 0)
    np.testing.assert_allclose(C[: m.rows], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["row", "col", "stripe"])
def test_epilogue_scales_match_xla(problem16, which):
    """row / column scales in the epilogue and per-(stripe, column) scales
    in the loop: the kernel and the plain XLA route agree."""
    from sparta_tpu.ops import blocked_spmm

    m, bell, B, C_ref = problem16
    rng = np.random.default_rng(3)
    kw = {"row": {"row_scale": rng.random(bell.shape[0])},
          "col": {"col_scale": rng.random(64)},
          "stripe": {"stripe_scale": rng.random((bell.n_block_cols, 64))},
          }[which]
    kw = {k: jnp.asarray(v, jnp.float32) for k, v in kw.items()}
    dev = BellDevice.from_host(bell)
    got = np.asarray(blocked_spmm(dev, jnp.asarray(B), interpret=True, **kw))
    want = np.asarray(blocked_spmm(dev, jnp.asarray(B), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bell_spmm_compact_chunked_requires_padding(problem16):
    """Mismatched operand dtypes are refused, not silently cast."""
    m, bell, B, C_ref = problem16
    with pytest.raises(ValueError, match="but B is"):
        bell_spmm_triton(BellDevice.from_host(bell),
                         jnp.asarray(B, jnp.bfloat16), interpret=True)


def test_int8_backend_falls_back_on_vmem(tmp_path):
    """-M 8 --dtype int8 runs the quantized blocked product at any K (no
    device-memory budget gates it any more)."""
    from sparta_tpu.bench.runner import make_backend
    from sparta_tpu.cli import parse_args
    from sparta_tpu.formats import random_uniform_csr
    from sparta_tpu.reorder import BlockingEngine

    K = 4096
    m = random_uniform_csr(256, K, density=0.002, seed=0)
    cfg = parse_args(["-M", "8", "-F", "1", "-a", "2", "-b", "128",
                      "-B", "128", "-c", "128", "--dtype", "int8"])
    eng = BlockingEngine.from_config(cfg)
    eng.get_grouping(m)
    fn, b_shape, name, flops = make_backend(cfg, m, eng)
    assert name == "bell_int8_rowcol"
    B = np.random.default_rng(0).standard_normal(b_shape).astype(np.float32)
    C = np.asarray(fn(jnp.asarray(B, jnp.bfloat16)), np.float32)
    assert C.shape[1] == b_shape[1] and np.isfinite(C).all()


@pytest.mark.parametrize("name", ["dense", "natbell128", "dedup",
                                  "dedup256"])
def test_csr_spmm_auto_regimes(name):
    """Every csr_spmm_auto candidate computes the product through the
    uniform contract: the logical [K, N] operand in, [M, N] out."""
    from sparta_tpu.ops.csr_spmm import csr_candidate_fn

    m = random_uniform_csr(64, 80, density=0.05, seed=5)
    B = np.random.default_rng(1).standard_normal((80, 128)).astype(np.float32)
    fn, flops = csr_candidate_fn(m, 128, name, with_flops=True)
    assert flops > 0
    C = np.asarray(fn(jnp.asarray(B)))
    np.testing.assert_allclose(C[: m.rows, :128], m.to_dense() @ B,
                               rtol=2e-5, atol=2e-5)


def test_csr_spmm_auto_picks_fewest_work(monkeypatch):
    """Without measuring, csr_spmm_auto runs the fewest-multiply-add
    candidate that fits; one that does not fit is never built."""
    import sparta_tpu.ops.csr_spmm as cs

    m = random_uniform_csr(64, 64, density=0.9, seed=1)
    table, aux = cs.csr_work_table(m, 128)
    assert aux["dedup256_n_uniq"] <= aux["dedup_n_uniq"]
    fn, name, flops = cs.csr_spmm_auto(m, 128)
    assert name == cs._backend_name(min(table, key=table.get))
    inf = float("inf")
    only_dense = {k: (1.0 if k == "dense" else inf) for k in table}
    monkeypatch.setattr(cs, "csr_work_table", lambda *a: (only_dense, aux))
    fn, name, flops = cs.csr_spmm_auto(m, 128)
    assert name == "csr_auto_dense" and flops == 2 * 64 * 64 * 128
    B = np.random.default_rng(0).standard_normal((64, 128)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(fn(jnp.asarray(B))),
                               m.to_dense() @ B, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("K", [1024, 2048])
def test_bell_spmm_compact_ksplit(K):
    """Wide contraction, blocks spread over the whole K range."""
    m = random_block_csr(128, K, block=16, block_density=0.05,
                         intra_density=0.5, seed=K)
    bell = bell_from_csr(m, None, block_row_size=16)
    B = np.random.default_rng(2).standard_normal((K, 32)).astype(np.float32)
    C = np.asarray(bell_spmm_triton(BellDevice.from_host(bell),
                                    jnp.asarray(B), interpret=True))
    np.testing.assert_allclose(C[:128], m.to_scipy() @ B, rtol=1e-4,
                               atol=1e-4)


def test_plan_spmm_ksplit_path(monkeypatch):
    """Densification is refused when the dense A would exceed the cap
    derived from device memory."""
    import sparta_tpu.ops.select as sel

    assert sel.densify_bytes_cap() > 0
    m = random_block_csr(256, 256, block=128, block_density=0.5, seed=9)
    bell = bell_from_csr(m, None, block_row_size=128)
    assert "dense" in sel._candidates(bell, jnp.float32)
    monkeypatch.setattr(sel, "densify_bytes_cap", lambda: 1)
    assert "dense" not in sel._candidates(bell, jnp.float32)


def test_plan_spmm_dense_fallback():
    # full block occupancy: the densified-GEMM candidate wins the rule and
    # is numerically correct
    import sparta_tpu.ops.select as sel

    m = random_uniform_csr(512, 512, density=0.2, seed=8)  # all blocks hit
    bell = bell_from_csr(m, None, block_row_size=128)
    assert bell.total_nzblocks == (512 // 128) ** 2
    plan = sel.plan_spmm(bell, 128)
    assert plan.backend == "bell_densified_gemm", plan.backend
    B = np.random.default_rng(4).standard_normal((512, 128)).astype(np.float32)
    C = np.asarray(plan(jnp.asarray(pad_b_for_bell(B, bell))))
    np.testing.assert_allclose(C[:512], m.to_scipy() @ B, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("rows_per_step", [2, 4])
def test_bell_spmm_compact_unrolled_multirow(rows_per_step):
    """Ragged rows with the block-row split over several programs."""
    bell, dense = _ragged_bell(b=64, seed=rows_per_step)
    B = np.random.default_rng(7).standard_normal((bell.shape[1], 48)).astype(
        np.float32)
    C = np.asarray(bell_spmm_triton(
        BellDevice.from_host(bell), jnp.asarray(B),
        bm=64 // rows_per_step, interpret=True))
    np.testing.assert_allclose(C, dense @ B, rtol=1e-4, atol=1e-4)


def test_bell_spmm_kernel_bf16_matches_xla(problem16):
    """bf16 storage, fp32 accumulation: kernel == XLA path within bf16
    output rounding."""
    m, bell, B, C_ref = problem16
    dev = BellDevice.from_host(bell, dtype=jnp.bfloat16)
    Bb = jnp.asarray(B, jnp.bfloat16)
    got = np.asarray(bell_spmm_triton(dev, Bb, interpret=True), np.float32)
    want = np.asarray(bell_spmm_xla(dev, Bb), np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    assert np.abs(got[: m.rows] - C_ref).max() / np.abs(C_ref).max() < 1e-2
