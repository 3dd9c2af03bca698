"""Int8 / fp8 quantized blocked SpMM: accuracy against the fp32 product,
the kernel (Pallas interpreter) against the plain XLA path, and the exact
dequantized math."""
import jax.numpy as jnp
import numpy as np
import pytest

from sparta_tpu.formats import bell_from_csr, random_block_csr
from sparta_tpu.ops import pad_b_for_bell
from sparta_tpu.ops.quant import (
    QBellDevice,
    bell_spmm_quant,
    int32_overflow_possible,
    quantize_b_cols,
    quantize_b_global_cols,
)

QDTYPES = [jnp.int8, jnp.float8_e4m3fn]


def _problem(seed=11, intra=0.8, n=256):
    m = random_block_csr(n, n, block=16, block_density=0.2,
                         intra_density=intra, seed=seed, shuffle_rows=False)
    bell = bell_from_csr(m, None, block_row_size=16)
    B = np.random.default_rng(0).standard_normal((n, 64)).astype(np.float32)
    return m, bell, pad_b_for_bell(B, bell), np.asarray(m.to_scipy() @ B)


def _rel(got, ref, rows):
    got = np.asarray(got, np.float32)[:rows]
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)


def test_int8_spmm_matched_accuracy():
    """Per-row A and per-(stripe, column) B scales: within the 1e-2 gate."""
    m, bell, Bp, C_ref = _problem()
    q = QBellDevice.from_bell(bell)
    Bq, bscale = quantize_b_cols(Bp, bell.block_col_size)
    assert _rel(bell_spmm_quant(q, Bq, bscale), C_ref, m.rows) < 1e-2


@pytest.mark.parametrize("dtype,tol", [(jnp.int8, 1e-2),
                                       (jnp.float8_e4m3fn, 8e-2)])
def test_int8_roundtrip_quantization(dtype, tol):
    m = random_block_csr(64, 64, block=16, block_density=0.5, seed=3,
                         shuffle_rows=False)
    bell = bell_from_csr(m, None, block_row_size=16)
    q = QBellDevice.from_bell(bell, dtype=dtype)
    nbr, max_nb, bh, bw = q.q_vals.shape
    scales = np.asarray(q.row_scales).reshape(nbr, 1, bh, 1)
    deq = np.asarray(q.q_vals, dtype=np.float32) * scales
    vals = np.asarray(bell.vals, np.float32)
    # e4m3 keeps 3 mantissa bits (~6% step); int8 ~1/254 of the row amax
    assert np.abs(deq - vals).max() / (np.abs(vals).max() + 1e-9) < tol


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("per_col", [False, True])
def test_int8_unrolled_matches_xla_int8(dtype, per_col):
    """The kernel (Pallas interpreter) == the XLA path, same quantized
    math, for both scale schemes and both 8-bit dtypes."""
    m, bell, Bp, C_ref = _problem(seed=21, intra=0.6)
    q = QBellDevice.from_bell(bell, dtype=dtype)
    Bq, bs = (quantize_b_global_cols(Bp, dtype=dtype) if per_col
              else quantize_b_cols(Bp, bell.block_col_size, dtype=dtype))
    got = np.asarray(bell_spmm_quant(q, Bq, bs, interpret=True))
    want = np.asarray(bell_spmm_quant(q, Bq, bs))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert _rel(got, C_ref, m.rows) < (2e-2 if dtype == jnp.int8 else 8e-2)


def test_fp8_spmm_accuracy_and_bound():
    """fp8(e4m3): correct within the e4m3 error bound, and int8 with the
    same scale scheme is at least as accurate."""
    m, bell, Bp, C_ref = _problem()
    q8 = QBellDevice.from_bell(bell, dtype=jnp.float8_e4m3fn)
    Bq8, bs8 = quantize_b_cols(Bp, 16, dtype=jnp.float8_e4m3fn)
    rel_fp8 = _rel(bell_spmm_quant(q8, Bq8, bs8), C_ref, m.rows)
    # e4m3: 3 mantissa bits -> ~6% elementwise; accumulation averages it out
    assert rel_fp8 < 8e-2, rel_fp8
    qi = QBellDevice.from_bell(bell)
    Bqi, bsi = quantize_b_cols(Bp, 16)
    rel_int8 = _rel(bell_spmm_quant(qi, Bqi, bsi), C_ref, m.rows)
    assert rel_int8 <= rel_fp8 * 1.05


def test_fp8_roundtrip_quantization():
    """B's fp8 quantization round-trips within the e4m3 step."""
    B = np.random.default_rng(2).standard_normal((64, 32)).astype(np.float32)
    q, s = quantize_b_cols(jnp.asarray(B), 16, dtype=jnp.float8_e4m3fn)
    deq = (np.asarray(q, np.float32).reshape(4, 16, 32)
           * np.asarray(s)[:, None, :]).reshape(64, 32)
    assert np.abs(deq - B).max() / np.abs(B).max() < 8e-2


def test_int8_rowcol_accuracy_beats_per_stripe():
    """Per-(stripe, column) B scales are at least as accurate as one scale
    per column (the headline gate depends on the finer scheme)."""
    m, bell, Bp, C_ref = _problem(seed=13, intra=0.3)
    q = QBellDevice.from_bell(bell)
    Bqr, bsr = quantize_b_cols(Bp, bell.block_col_size)
    assert bsr.shape == (Bp.shape[0] // bell.block_col_size, 64)
    rel_rc = _rel(bell_spmm_quant(q, Bqr, bsr), C_ref, m.rows)
    Bqg, bsg = quantize_b_global_cols(Bp)
    rel_g = _rel(bell_spmm_quant(q, Bqg, bsg), C_ref, m.rows)
    assert rel_rc < 2e-2, rel_rc
    assert rel_rc <= rel_g * 1.05, (rel_rc, rel_g)


def _dequant_oracle(q, Bq, bs, per_col):
    """The exact dequantized math in numpy from the same quantized arrays."""
    cols = np.asarray(q.cols_idx)
    nb = np.asarray(q.nb_row)
    qv = np.asarray(q.q_vals, dtype=np.int64)
    nbr, _, bh, bw = qv.shape
    N = Bq.shape[1]
    Bqn = np.asarray(Bq, dtype=np.int64).reshape(-1, bw, N)
    bsn = np.asarray(bs, np.float64)
    out = np.zeros((nbr, bh, N))
    for i in range(nbr):
        for t in range(int(nb[i])):
            d = (qv[i, t] @ Bqn[cols[i, t]]).astype(np.float64)
            out[i] += d if per_col else d * bsn[cols[i, t]][None, :]
    out = out.reshape(nbr * bh, N) * np.asarray(q.row_scales)[:, None]
    return out * bsn[None, :] if per_col else out


@pytest.mark.parametrize("interpret", [False, True])
def test_int8_rowcol_matches_dequant_oracle(interpret):
    m, bell, Bp, _ = _problem(seed=23, intra=0.7, n=128)
    q = QBellDevice.from_bell(bell)
    Bq, bs = quantize_b_cols(Bp, 16)
    got = np.asarray(bell_spmm_quant(q, Bq, bs, interpret=interpret))
    np.testing.assert_allclose(got, _dequant_oracle(q, Bq, bs, False),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("interpret", [False, True])
def test_int8_global_matches_dequant_oracle_and_accuracy(interpret):
    """Per-column B scales: a pure int32 dot-accumulate with the scales in
    the epilogue, equal to the exact dequantized math."""
    m, bell, Bp, C_ref = _problem(seed=31, intra=0.5)
    q = QBellDevice.from_bell(bell)
    Bq, bs = quantize_b_global_cols(Bp)
    assert bs.shape == (64,)
    got = np.asarray(bell_spmm_quant(q, Bq, bs, interpret=interpret))
    np.testing.assert_allclose(got, _dequant_oracle(q, Bq, bs, True),
                               rtol=1e-5, atol=1e-5)
    assert _rel(got, C_ref, m.rows) < 2e-2


def test_int8_global_overflow_guard():
    """A structure whose worst row could overflow int32 accumulation is
    rejected, not silently wrong."""
    m = random_block_csr(128, 128, block=128, block_density=1.0,
                         intra_density=1.0, seed=1)
    bell = bell_from_csr(m, None, block_row_size=128)
    q = QBellDevice.from_bell(bell)
    assert not int32_overflow_possible(q)
    # forge the host-side block count (the real thing needs ~1000 blocks)
    q = QBellDevice(q.cols_idx, q.nb_row, q.q_vals, q.row_scales,
                    nb_max=2**31 // (128 * 127 * 127) + 1)
    assert int32_overflow_possible(q)
    with pytest.raises(ValueError, match="overflow"):
        bell_spmm_quant(q, jnp.zeros((128, 128), jnp.int8),
                        jnp.ones((128,), jnp.float32))


def test_quant_dtype_mismatch_rejected():
    m, bell, Bp, _ = _problem(n=64)
    q = QBellDevice.from_bell(bell, dtype=jnp.int8)
    Bq, bs = quantize_b_cols(Bp, 16, dtype=jnp.float8_e4m3fn)
    with pytest.raises(ValueError, match="but B is"):
        bell_spmm_quant(q, Bq, bs)
