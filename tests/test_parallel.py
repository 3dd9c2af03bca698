"""Multi-chip SpMM tests on the 8-virtual-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparta_tpu.formats import bell_from_csr, random_block_csr
from sparta_tpu.ops import pad_b_for_bell
from sparta_tpu.parallel import (
    make_mesh,
    pad_block_rows,
    shard_bell_rowwise,
    spmm_colsplit_reduce_scatter,
    spmm_ring,
    spmm_rowsharded,
    split_bell_cols,
)


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


@pytest.fixture(scope="module")
def problem():
    m = random_block_csr(512, 512, block=16, block_density=0.12, intra_density=0.6,
                         seed=7, shuffle_rows=False)
    bell = bell_from_csr(m, None, block_row_size=16)
    B = np.random.default_rng(0).standard_normal((512, 64)).astype(np.float32)
    C_ref = m.to_scipy() @ B
    return m, bell, B, C_ref


def test_pad_block_rows(problem):
    _, bell, _, _ = problem
    p = pad_block_rows(bell, 7)
    assert p.n_block_rows % 7 == 0
    assert p.nb_row[bell.n_block_rows :].sum() == 0


def test_rowsharded(problem, mesh):
    m, bell, B, C_ref = problem
    dev = shard_bell_rowwise(bell, mesh)
    Bd = jax.device_put(pad_b_for_bell(B, bell),
                        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    C = spmm_rowsharded(dev, Bd)
    np.testing.assert_allclose(np.asarray(C)[: m.rows], C_ref, rtol=1e-4, atol=1e-4)
    # C must come out row-sharded
    assert "x" in str(C.sharding.spec) or C.sharding.spec[0] == "x"


def test_colsplit_reduce_scatter(problem, mesh):
    m, bell, B, C_ref = problem
    n = 8
    bell_p = pad_block_rows(bell, n)
    ci, nb, v, k_part = split_bell_cols(bell_p, n)
    Bp = pad_b_for_bell(B, bell_p)
    # slice B rows per part, pad K to n*k_part*bw
    bw = bell.block_col_size
    K_needed = n * k_part * bw
    Bp = jnp.pad(Bp, ((0, K_needed - Bp.shape[0]), (0, 0)))
    Bparts = Bp.reshape(n, k_part * bw, -1)
    C = spmm_colsplit_reduce_scatter(
        jnp.asarray(ci), jnp.asarray(nb), jnp.asarray(v), Bparts, mesh
    )
    np.testing.assert_allclose(np.asarray(C)[: m.rows], C_ref, rtol=1e-4, atol=1e-4)


def test_ring(problem, mesh):
    m, bell, B, C_ref = problem
    n = 8
    N = 64
    dev = shard_bell_rowwise(bell, mesh)
    Bd = jax.device_put(
        pad_b_for_bell(B, bell),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, "x")),
    )
    C = spmm_ring(dev, Bd, mesh)
    np.testing.assert_allclose(np.asarray(C)[: m.rows], C_ref, rtol=1e-4, atol=1e-4)


def test_scaling_consistency(problem, mesh):
    """All three layouts agree bit-for-bit-ish on the same problem."""
    m, bell, B, C_ref = problem
    dev = shard_bell_rowwise(bell, mesh)
    Brep = jax.device_put(pad_b_for_bell(B, bell),
                          jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    C1 = np.asarray(spmm_rowsharded(dev, Brep))
    Bcol = jax.device_put(pad_b_for_bell(B, bell),
                          jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, "x")))
    C2 = np.asarray(spmm_ring(dev, Bcol, mesh))
    np.testing.assert_allclose(C1, C2[: C1.shape[0]], rtol=1e-5, atol=1e-5)


def test_partitioned_reorder():
    from sparta_tpu.definitions import BlockingType
    from sparta_tpu.formats import random_block_csr, bell_from_csr
    from sparta_tpu.parallel import partitioned_reorder
    from sparta_tpu.reorder import BlockingEngine
    from sparta_tpu.utils import get_fixed_size_grouping, get_partition

    m = random_block_csr(256, 256, block=16, block_density=0.15,
                         intra_density=0.5, seed=9)
    eng = BlockingEngine(tau=0.4, col_block_size=16, row_block_size=16,
                         blocking_algo=BlockingType.iterative_clocked,
                         backend="numpy")
    g = partitioned_reorder(m, eng, n_parts=4)
    # every row grouped; parts stay in order (ids strictly increase by part)
    assert (g >= 0).all()
    part_of_row = np.repeat(np.arange(4), 64)
    order = np.argsort(g, kind="stable")
    assert np.all(np.diff(part_of_row[order]) >= 0)
    # grouping is usable downstream
    bell = bell_from_csr(m, get_fixed_size_grouping(g, 16), block_row_size=16)
    assert bell.total_nzblocks > 0


def test_vbr_from_partition():
    from sparta_tpu.formats import random_uniform_csr
    from sparta_tpu.formats.vbr import vbr_from_csr_partition

    m = random_uniform_csr(30, 30, 0.1, seed=2)
    v = vbr_from_csr_partition(m, np.array([0, 7, 15, 30]), col_block_size=8)
    np.testing.assert_allclose(v.to_dense_permuted()[:30, :30], m.to_dense())


@pytest.fixture(scope="module")
def problem128():
    # kernel-tileable blocks so the Triton path engages under shard_map
    m = random_block_csr(1024, 1024, block=128, block_density=0.3,
                         intra_density=0.4, seed=11, shuffle_rows=False)
    bell = bell_from_csr(m, None, block_row_size=128)
    B = np.random.default_rng(3).standard_normal((1024, 1024)).astype(np.float32)
    C_ref = m.to_scipy() @ B
    return m, bell, B, C_ref


def test_rowsharded_pallas_composition(problem128, mesh):
    # the blocked kernel composes with shard_map (the Pallas interpreter on
    # the CPU mesh; the same kernel trace the GPU compiles)
    m, bell, B, C_ref = problem128
    dev = shard_bell_rowwise(bell, mesh)
    Bd = jax.device_put(
        pad_b_for_bell(B, bell),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    C = spmm_rowsharded(dev, Bd, mesh=mesh, interpret=True)
    np.testing.assert_allclose(np.asarray(C)[: m.rows], C_ref,
                               rtol=1e-4, atol=1e-4)


def test_ring_pallas_composition(problem128, mesh):
    m, bell, B, C_ref = problem128
    dev = shard_bell_rowwise(bell, mesh)
    Bd = jax.device_put(
        pad_b_for_bell(B, bell),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, "x")))
    C = spmm_ring(dev, Bd, mesh, interpret=True)
    np.testing.assert_allclose(np.asarray(C)[: m.rows], C_ref,
                               rtol=1e-4, atol=1e-4)


def test_colsplit_pallas_composition(problem128, mesh):
    m, bell, B, C_ref = problem128
    n = 8
    bell_p = pad_block_rows(bell, n)
    ci, nb, v, k_part = split_bell_cols(bell_p, n)
    Bp = pad_b_for_bell(B, bell_p)
    bw = bell.block_col_size
    K_needed = n * k_part * bw
    Bp = jnp.pad(Bp, ((0, K_needed - Bp.shape[0]), (0, 0)))
    Bparts = Bp.reshape(n, k_part * bw, -1)
    C = spmm_colsplit_reduce_scatter(
        jnp.asarray(ci), jnp.asarray(nb), jnp.asarray(v), Bparts, mesh,
        interpret=True,
    )
    np.testing.assert_allclose(np.asarray(C)[: m.rows], C_ref,
                               rtol=1e-4, atol=1e-4)


def test_partitioned_reorder_quality_degradation():
    """Per-host reordering quality is bounded: when similar rows are local
    (unshuffled planted blocks) the partition cut costs a few percent; when
    clusters are scattered across parts (shuffled) the worst case is
    ~n_parts x (each part recovers its own slice of every cluster)."""
    from sparta_tpu.definitions import BlockingType
    from sparta_tpu.parallel import partitioned_reorder
    from sparta_tpu.reorder import BlockingEngine
    from sparta_tpu.utils import get_fixed_size_grouping

    def nzblocks(m, g, b):
        scorer = BlockingEngine(col_block_size=b, row_block_size=b,
                                blocking_algo=BlockingType.fixed_size)
        scorer.grouping_result = get_fixed_size_grouping(g, b)
        scorer.collect_blocking_info(m)
        return scorer.VBR_nzblocks_count

    n_parts, b = 4, 32
    for shuffle, bound in ((False, 1.15), (True, n_parts + 0.01)):
        m = random_block_csr(1024, 1024, block=32, block_density=0.1,
                             intra_density=0.4, seed=13,
                             shuffle_rows=shuffle)
        eng = lambda: BlockingEngine(
            tau=0.3, col_block_size=b, row_block_size=b,
            blocking_algo=BlockingType.iterative_clocked)
        g_global = eng().get_grouping(m)
        g_part = partitioned_reorder(m, eng(), n_parts=n_parts)
        ratio = nzblocks(m, g_part, b) / nzblocks(m, g_global, b)
        assert ratio <= bound, (shuffle, ratio)


def test_dedup_spmm_rowsharded_matches_oracle():
    """Fine-grained dedup path row-tile-sharded over the mesh: B stays
    replicated, no collectives, per-shard chunk-padded slot streams."""
    from sparta_tpu.formats.csr import rmat_csr
    from sparta_tpu.parallel import dedup_spmm_rowsharded, shard_dedup_rowwise

    m = rmat_csr(10, edge_factor=6, seed=3)
    mesh = make_mesh(8)
    sdev = shard_dedup_rowwise(m, mesh, dtype=jnp.float32, chunk=64)
    for N in (256, 1024):
        B = jnp.asarray(
            np.random.default_rng(0).standard_normal((m.cols, N)).astype(
                np.float32))
        C = np.asarray(dedup_spmm_rowsharded(sdev, B, mesh))
        ref = np.asarray(m.to_scipy() @ np.asarray(B))
        np.testing.assert_allclose(C, ref, rtol=1e-4, atol=1e-4)


def test_ring_kernel_in_shard_map_matches_xla_ring(problem, mesh):
    """The ppermute ring with the blocked kernel (Pallas interpreter) inside
    shard_map reproduces the scipy oracle and the same ring on XLA."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    m, bell, B, C_ref = problem
    dev = shard_bell_rowwise(bell, mesh)
    Bcol = jax.device_put(jnp.asarray(B),
                          NamedSharding(mesh, P(None, "x")))
    C = np.asarray(spmm_ring(dev, Bcol, mesh, interpret=True))
    np.testing.assert_allclose(C[: m.rows], C_ref, rtol=1e-4, atol=1e-4)
    C2 = np.asarray(spmm_ring(dev, Bcol, mesh))
    np.testing.assert_allclose(C[: m.rows], C2[: m.rows], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n,dt", [(2, jnp.float32), (4, jnp.float32),
                                  (8, jnp.bfloat16)])
def test_ring_sizes_and_dtype(n, dt):
    """Ring sizes 2, 4 and 8; bf16 storage with fp32 accumulation."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh(n)
    m = random_block_csr(16 * 4 * n, 16 * 4 * n, block=16,
                         block_density=0.3, seed=9, shuffle_rows=False)
    bell = bell_from_csr(m, None, block_row_size=16)
    dev = shard_bell_rowwise(bell, mesh, dtype=dt)
    N = 16 * n
    B = np.random.default_rng(1).standard_normal(
        (bell.shape[1], N)).astype(np.float32)
    Bcol = jax.device_put(jnp.asarray(B, dtype=dt),
                          NamedSharding(mesh, P(None, "x")))
    C = np.asarray(spmm_ring(dev, Bcol, mesh, interpret=True), np.float32)
    C_ref = (m.to_scipy() @ B[: m.cols]).astype(np.float32)
    tol = 1e-4 if dt == jnp.float32 else 0.15
    np.testing.assert_allclose(C[: m.rows], C_ref, rtol=tol, atol=tol)


def test_ring_rejects_indivisible_n(problem, mesh):
    m, bell, B, _ = problem
    dev = shard_bell_rowwise(bell, mesh)
    bad = jnp.asarray(B[:, :60])  # 60 % 8 != 0
    with pytest.raises(ValueError, match="divisible"):
        spmm_ring(dev, bad, mesh)


def test_colsplit_kernel_matches_oracle(problem, mesh):
    """Colsplit + psum_scatter with the kernel inside shard_map (Pallas
    interpreter) equals the scipy oracle and the XLA layout."""
    m, bell, B, C_ref = problem
    n = 8
    bell_p = pad_block_rows(bell, n)
    ci, nb, v, k_part = split_bell_cols(bell_p, n)
    N = B.shape[1]
    bw = bell.block_col_size
    Bp = np.zeros((n * k_part * bw, N), np.float32)
    Bp[: B.shape[0]] = B
    args = (jnp.asarray(ci), jnp.asarray(nb), jnp.asarray(v),
            jnp.asarray(Bp.reshape(n, k_part * bw, N)))
    C = np.asarray(spmm_colsplit_reduce_scatter(*args, mesh,
                                                interpret=True))
    np.testing.assert_allclose(C[: m.rows], C_ref, rtol=1e-4, atol=1e-4)
    C2 = np.asarray(spmm_colsplit_reduce_scatter(*args, mesh))
    np.testing.assert_allclose(C[: m.rows], C2[: m.rows], rtol=1e-5,
                               atol=1e-5)


def test_colsplit_rejects_unpadded_rows(mesh):
    ci = jnp.zeros((8, 3, 1), jnp.int32)  # 3 block rows, 8 devices
    nb = jnp.zeros((8, 3), jnp.int32)
    v = jnp.zeros((8, 3, 1, 16, 16), jnp.float32)
    B = jnp.zeros((8, 16, 32), jnp.float32)
    with pytest.raises(ValueError, match="pad_block_rows"):
        spmm_colsplit_reduce_scatter(ci, nb, v, B, mesh)
