"""Property tests over random CSR matrices (SURVEY §4b mandate): every
device execution must satisfy

  - permutation invariance: spmm(P·A, B) == P-row-shuffle of spmm(A, B),
    and spmm(A·Pc, B) == spmm(A, Pc-row-shuffle of B)
  - padding identity: zero-padding B's columns (and the K dimension where
    the backend pads internally) never changes the real region
  - duplicate-entry semantics: stored (row, col) duplicates sum, matching
    the serial CSR.multiply oracle

across the fine-grained family, the blocked compact kernel and the ELL
baseline.  Reference analog: serial-oracle comparisons in
TEST_matrices.cpp:53-54 / TEST_cuda.cpp:179-232 (no property layer there
— this is the stronger harness SURVEY §4 prescribes)."""
import jax.numpy as jnp
import numpy as np
import pytest

from sparta_tpu.formats.csr import CSR, random_uniform_csr, rmat_csr


def _spmm_backends():
    """(name, factory(csr) -> fn(B_np) -> C_np[rows, N]) pairs."""
    from sparta_tpu.formats import bell_from_csr
    from sparta_tpu.ops import (
        DedupDevice,
        EllDevice,
        FellDevice,
        FineDevice,
        bell_spmm_xla,
        BellDevice,
        dedup_spmm,
        ell_spmm,
        fell_spmm,
        fine_spmm,
    )

    def fine(m):
        dev = FineDevice.from_csr(m, dtype=jnp.float32)
        return lambda B: np.asarray(fine_spmm(dev, jnp.asarray(B)))

    def dedup(m):
        dev = DedupDevice.from_csr(m, dtype=jnp.float32, chunk=128)
        return lambda B: np.asarray(dedup_spmm(dev, jnp.asarray(B)))

    def fell(m):
        dev = FellDevice.from_csr(m, width=8, dtype=jnp.float32)
        return lambda B: np.asarray(fell_spmm(dev, jnp.asarray(B)))

    def ell(m):
        dev = EllDevice.from_csr(m, dtype=jnp.float32)
        return lambda B: np.asarray(ell_spmm(dev, jnp.asarray(B)))

    def bell_natural(m):
        bell = bell_from_csr(m, None, block_row_size=128)
        dev = BellDevice.from_host(bell, dtype=jnp.float32)

        def run(B):
            Bp = np.zeros((bell.shape[1], B.shape[1]), B.dtype)
            Bp[: m.cols] = B
            return np.asarray(bell_spmm_xla(dev, jnp.asarray(Bp)))[: m.rows]

        return run

    def bell_triton(m):
        """The blocked Triton kernel (Pallas interpreter on the CPU)."""
        from sparta_tpu.ops import bell_spmm_triton

        bell = bell_from_csr(m, None, block_row_size=128)
        dev = BellDevice.from_host(bell, dtype=jnp.float32)

        def run(B):
            Bp = np.zeros((bell.shape[1], B.shape[1]), B.dtype)
            Bp[: m.cols] = B
            out = np.asarray(bell_spmm_triton(dev, jnp.asarray(Bp),
                                              interpret=True))
            return out[: m.rows]

        return run

    return [("fine", fine), ("dedup", dedup), ("fell", fell), ("ell", ell),
            ("bell_natural", bell_natural), ("bell_triton", bell_triton)]


BACKENDS = _spmm_backends()
IDS = [n for n, _ in BACKENDS]


@pytest.mark.parametrize("factory", [f for _, f in BACKENDS], ids=IDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_row_permutation_invariance(factory, seed):
    m = rmat_csr(8, edge_factor=5, seed=seed)
    rng = np.random.default_rng(seed + 10)
    B = rng.standard_normal((m.cols, 128)).astype(np.float32)
    perm = rng.permutation(m.rows)
    C = factory(m)(B)
    C_perm = factory(m.permute_rows(perm))(B)
    # row i of the permuted product is row perm[i] of the original
    np.testing.assert_allclose(C_perm, C[perm], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("factory", [f for _, f in BACKENDS], ids=IDS)
def test_col_permutation_invariance(factory):
    m = random_uniform_csr(200, 300, density=0.02, seed=3)
    rng = np.random.default_rng(4)
    B = rng.standard_normal((m.cols, 128)).astype(np.float32)
    perm = rng.permutation(m.cols)
    C = factory(m)(B)
    # column j of A moves to slot inv[j]; feeding B with rows shuffled the
    # same way must reproduce the original product
    C2 = factory(m.permute_cols(perm))(B[perm])
    np.testing.assert_allclose(C2, C, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("factory", [f for _, f in BACKENDS], ids=IDS)
def test_b_column_padding_identity(factory):
    m = rmat_csr(8, edge_factor=5, seed=2)
    rng = np.random.default_rng(5)
    B = rng.standard_normal((m.cols, 128)).astype(np.float32)
    C = factory(m)(B)
    Bp = np.concatenate([B, np.zeros((m.cols, 128), np.float32)], axis=1)
    Cp = factory(m)(Bp)
    np.testing.assert_allclose(Cp[:, :128], C, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(Cp[:, 128:], 0.0)


@pytest.mark.parametrize("factory", [f for _, f in BACKENDS], ids=IDS)
def test_duplicate_entries_sum(factory):
    rows = np.array([1, 1, 40, 40, 40, 200])
    cols = np.array([7, 7, 3, 3, 9, 100])
    vals = np.array([1.0, 2.0, 4.0, 8.0, 16.0, 32.0], np.float32)
    m = CSR.from_coo(rows, cols, vals, (256, 128))
    B = np.eye(128, dtype=np.float32)
    C = factory(m)(B)
    ref = m.multiply(B)  # serial oracle sums stored duplicates
    np.testing.assert_allclose(C[: m.rows], ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("factory", [f for _, f in BACKENDS], ids=IDS)
def test_empty_and_dense_rows(factory):
    """Empty rows produce zero rows; a full row produces the B column sum."""
    rows = np.concatenate([np.full(128, 5), [100]])
    cols = np.concatenate([np.arange(128), [0]])
    vals = np.ones(129, np.float32)
    m = CSR.from_coo(rows, cols, vals, (256, 128))
    B = np.random.default_rng(6).standard_normal((128, 128)).astype(
        np.float32)
    C = factory(m)(B)
    np.testing.assert_allclose(C[5], B.sum(axis=0), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(C[100], B[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(C[0], 0.0)


@pytest.mark.parametrize("seed", range(3))
def test_bell_padding_blocks_are_zero(seed):
    """CLAUDE.md invariant, value half: block-alignment padding never
    changes the result in the original range, padding blocks
    (cols_idx == -1) carry EXACTLY-zero values, and padded output rows are
    exactly zero (the gradient half lives in test_autodiff.py)."""
    from sparta_tpu.formats import bell_from_csr
    from sparta_tpu.ops import BellDevice, bell_spmm_xla, pad_b_for_bell

    rng = np.random.default_rng(seed)
    n = int(rng.integers(30, 100))  # deliberately NOT a block multiple
    m = random_uniform_csr(n, n, density=0.05, seed=seed + 7)
    bell = bell_from_csr(m, None, block_row_size=16)
    assert bell.shape[0] % 16 == 0 and bell.shape[0] >= n
    mask = np.asarray(bell.cols_idx) < 0
    assert np.all(np.asarray(bell.vals)[mask] == 0)
    B = rng.standard_normal((n, 16)).astype(np.float32)
    C = np.asarray(
        bell_spmm_xla(BellDevice.from_host(bell), pad_b_for_bell(B, bell)))
    np.testing.assert_allclose(C[:n], m.to_scipy() @ B, rtol=1e-4, atol=1e-4)
    assert np.all(C[n:] == 0)
