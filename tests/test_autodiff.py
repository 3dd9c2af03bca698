"""Custom VJP of the blocked SpMM vs autodiff through the XLA path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparta_tpu.formats import bell_from_csr, random_block_csr
from sparta_tpu.ops import BellDevice, bell_spmm_xla, pad_b_for_bell
from sparta_tpu.ops.autodiff import bell_spmm


def make_problem():
    m = random_block_csr(128, 128, block=16, block_density=0.25, intra_density=0.6,
                         seed=21, shuffle_rows=False)
    bell = bell_from_csr(m, None, block_row_size=16)
    dev = BellDevice.from_host(bell)
    B = jnp.asarray(
        np.random.default_rng(0).standard_normal((bell.shape[1], 32)).astype(np.float32)
    )
    return dev, B


def test_forward_matches_xla():
    dev, B = make_problem()
    C1 = bell_spmm(dev.cols_idx, dev.nb_row, dev.vals, B)
    C2 = bell_spmm_xla(dev, B)
    np.testing.assert_allclose(np.asarray(C1), np.asarray(C2), rtol=1e-5)
    C3 = bell_spmm(dev.cols_idx, dev.nb_row, dev.vals, B, True)
    np.testing.assert_allclose(np.asarray(C3), np.asarray(C2), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("interpret", [False, True])
def test_custom_vjp_matches_autodiff(interpret):
    """Gradients through the routed forward (the kernel under the Pallas
    interpreter, or XLA) equal autodiff through the XLA path."""
    dev, B = make_problem()

    def loss_custom(vals, B):
        C = bell_spmm(dev.cols_idx, dev.nb_row, vals, B, interpret)
        return jnp.sum(jnp.sin(C))

    def loss_auto(vals, B):
        C = bell_spmm_xla(BellDevice(dev.cols_idx, dev.nb_row, vals), B)
        return jnp.sum(jnp.sin(C))

    gv1, gb1 = jax.grad(loss_custom, argnums=(0, 1))(dev.vals, B)
    gv2, gb2 = jax.grad(loss_auto, argnums=(0, 1))(dev.vals, B)
    np.testing.assert_allclose(np.asarray(gv1), np.asarray(gv2), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gb1), np.asarray(gb2), rtol=1e-4, atol=1e-5)


def test_padding_blocks_get_zero_grad():
    dev, B = make_problem()
    pad_mask = np.asarray(dev.cols_idx) < 0
    assert pad_mask.any()

    def loss(vals):
        return jnp.sum(bell_spmm(dev.cols_idx, dev.nb_row, vals, B) ** 2)

    gv = np.asarray(jax.grad(loss)(dev.vals))
    assert np.all(gv[pad_mask] == 0)
