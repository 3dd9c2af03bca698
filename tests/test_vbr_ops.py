"""Variable-height VBR device SpMM vs host oracle."""
import jax.numpy as jnp
import numpy as np
import pytest

from sparta_tpu.definitions import BlockingType
from sparta_tpu.formats import random_uniform_csr, vbr_from_csr
from sparta_tpu.ops.vbr_xla import VbrDevice, vbr_spmm_xla, vbr_spmm_xla_ba
from sparta_tpu.reorder import BlockingEngine
from sparta_tpu.utils import get_permutation


@pytest.fixture(scope="module")
def problem():
    m = random_uniform_csr(200, 180, 0.06, seed=17)
    eng = BlockingEngine(tau=0.6, col_block_size=16, row_block_size=16,
                         blocking_algo=BlockingType.iterative_clocked,
                         backend="numpy")
    g = eng.get_grouping(m)  # variable-height groups
    vbr = vbr_from_csr(m, g, col_block_size=16)
    assert len(np.unique(vbr.heights)) > 1, "want genuinely variable heights"
    return m, g, vbr


def test_vbr_spmm_xla(problem):
    m, g, vbr = problem
    dev = VbrDevice.from_host(vbr)
    B = np.random.default_rng(0).standard_normal((vbr.block_cols * 16, 24)).astype(np.float32)
    C = vbr_spmm_xla(dev, jnp.asarray(B))
    C_ref = (m.to_scipy() @ B[: m.cols])[get_permutation(g)]
    np.testing.assert_allclose(np.asarray(C)[: m.rows], C_ref, rtol=1e-4, atol=1e-4)


def test_vbr_spmm_xla_ba(problem):
    m, g, vbr = problem
    dev = VbrDevice.from_host(vbr)
    N = 24
    B = np.random.default_rng(1).standard_normal((N, vbr.shape[0])).astype(np.float32)
    C = vbr_spmm_xla_ba(dev, jnp.asarray(B))
    perm = get_permutation(g)
    # B columns are in permuted row space: unpermute for the oracle
    B_orig = np.zeros((N, m.rows), dtype=np.float32)
    B_orig[:, perm[: m.rows]] = B[:, : m.rows] if vbr.shape[0] >= m.rows else B
    C_ref = B_orig @ m.to_scipy()
    np.testing.assert_allclose(np.asarray(C)[:, : m.cols], C_ref, rtol=1e-4, atol=1e-4)


def test_vbr_bucketing_covers_all_blocks(problem):
    _, _, vbr = problem
    dev = VbrDevice.from_host(vbr)
    total = sum(int((b.cols_idx >= 0).sum()) for b in dev.buckets)
    assert total == vbr.total_nzblocks


def test_vbr_spmm_pallas_matches_oracle():
    """Height-bucketed VBR SpMM through the kernel (Pallas interpreter) ==
    scipy oracle (ragged heights padded to kernel tiles)."""
    import jax.numpy as jnp

    from sparta_tpu.formats import random_block_csr, vbr_from_csr
    from sparta_tpu.ops import vbr_kernel_device, vbr_spmm_pallas
    from sparta_tpu.reorder import BlockingEngine
    from sparta_tpu.utils import get_permutation

    m = random_block_csr(200, 200, block=8, block_density=0.2,
                         intra_density=0.6, seed=17)
    eng = BlockingEngine(tau=0.6, col_block_size=16, row_block_size=16)
    g = eng.get_grouping(m)
    vbr = vbr_from_csr(m, g, col_block_size=16)
    assert len(np.unique(vbr.heights)) > 1  # genuinely ragged
    dev = vbr_kernel_device(vbr)
    assert all(b.vals.shape[2] >= 16 for b in dev.buckets)
    K = vbr.block_cols * vbr.block_col_size
    B = np.zeros((K, 32), dtype=np.float32)
    B[: m.cols] = np.random.default_rng(3).standard_normal((m.cols, 32))
    C = np.asarray(vbr_spmm_pallas(dev, jnp.asarray(B), interpret=True))
    C_ref = (m.to_scipy() @ B[: m.cols])[get_permutation(g)]
    np.testing.assert_allclose(C[: m.rows], C_ref, rtol=1e-4, atol=1e-4)


def test_vbr_spmm_pallas_empty_height_bucket():
    """A height bucket whose block-rows are all empty contributes zeros."""
    import jax.numpy as jnp

    from sparta_tpu.formats import CSR
    from sparta_tpu.formats.vbr import vbr_from_csr_partition
    from sparta_tpu.ops import vbr_kernel_device, vbr_spmm_pallas

    # rows 8..20 are empty and form their own block-row (height 13)
    r = np.array([0, 3, 7, 22, 23])
    c = np.array([1, 9, 4, 2, 15])
    m = CSR.from_coo(r, c, np.ones(5, dtype=np.float32), (24, 16))
    vbr = vbr_from_csr_partition(m, np.array([0, 8, 21, 24]),
                                 col_block_size=16)
    dev = vbr_kernel_device(vbr)
    B = np.random.default_rng(0).standard_normal((16, 32)).astype(np.float32)
    C = np.asarray(vbr_spmm_pallas(dev, jnp.asarray(B), interpret=True))
    np.testing.assert_allclose(C[:24], m.to_scipy() @ B, rtol=1e-5, atol=1e-5)
