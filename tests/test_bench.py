"""Bench harness tests (CPU): full experiment pipeline per backend + CSV."""
import csv

import numpy as np
import pytest

from sparta_tpu.bench.runner import REFERENCE_COLUMNS, run_experiment
from sparta_tpu.cli import Config, parse_args
from sparta_tpu.formats import random_block_csr


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("bench") / "blocky.el"
    m = random_block_csr(128, 128, block=16, block_density=0.25, seed=21)
    m.save_to_edgelist(p)
    return str(p)


def base_cfg(matrix_file, tmp_path, **kw):
    cfg = Config(
        filename=matrix_file,
        outfile=str(tmp_path / "out.csv"),
        blocking_algo=2,
        row_block_size=16,
        col_block_size=16,
        b_cols=32,
        warmup=1,
        exp_repetitions=2,
        inner_iters=2,
        verbose=0,
    )
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.mark.parametrize("m_algo", [1, 2, 3, 6, 7, 8])
def test_run_experiment_backends(matrix_file, tmp_path, m_algo):
    cfg = base_cfg(matrix_file, tmp_path, multiplication_algo=m_algo)
    row = run_experiment(cfg)
    assert row["avg_time_multiply"] > 0
    assert row["nnz_per_s"] > 0
    if m_algo in (3, 6, 7, 8):
        assert row["VBR_nzblocks_count"] > 0


def test_blocking_only_run(matrix_file, tmp_path):
    cfg = base_cfg(matrix_file, tmp_path, multiplication_algo=0, blocking_algo=5,
                   tau=0.5, force_fixed_size=True)
    row = run_experiment(cfg)
    assert row["avg_time_multiply"] == 0
    assert row["VBR_nzcount"] > 0
    assert (tmp_path / "out.csv.g").exists()


def test_csv_schema(matrix_file, tmp_path):
    cfg = base_cfg(matrix_file, tmp_path, multiplication_algo=3)
    run_experiment(cfg)
    with open(tmp_path / "out.csv") as f:
        rows = list(csv.reader(f))
    header = [h for h in rows[0] if h]
    assert header[: len(REFERENCE_COLUMNS)] == REFERENCE_COLUMNS
    assert len(rows[1]) == len(rows[0])


def test_reordering_beats_natural_blocking(matrix_file, tmp_path):
    natural = run_experiment(base_cfg(matrix_file, tmp_path, multiplication_algo=0))
    reordered = run_experiment(
        base_cfg(matrix_file, tmp_path, multiplication_algo=0, blocking_algo=5,
                 tau=0.6, force_fixed_size=True)
    )
    # the planted-block matrix was row-shuffled; reordering must densify
    assert reordered["VBR_nzcount"] < natural["VBR_nzcount"]


def test_cli_parse_reference_flags():
    cfg = parse_args(["-a", "5", "-F", "1", "-M", "6", "-t", "0.2", "-b", "128",
                      "-B", "128", "-c", "2048", "-f", "x.el"])
    assert cfg.blocking_algo == 5
    assert cfg.force_fixed_size is True
    assert cfg.multiplication_algo == 6
    assert cfg.tau == pytest.approx(0.2)
    assert cfg.col_block_size == 128 and cfg.row_block_size == 128
    assert cfg.b_cols == 2048 and cfg.filename == "x.el"


def test_cli_main_smoke(matrix_file, tmp_path, capsys):
    from sparta_tpu.cli import main

    row = main(["-f", matrix_file, "-o", str(tmp_path / "r.csv"), "-a", "2",
                "-B", "16", "-b", "16", "-M", "3", "-c", "16", "-x", "1",
                "--inner-iters", "1", "-v", "0"])
    assert row["VBR_nzblocks_count"] > 0


@pytest.mark.parametrize("m_algo", [4, 6])
def test_variable_height_vbr_backends(matrix_file, tmp_path, m_algo):
    """-M 4/6 with a reordering grouping and NO -F: bucketed VBR path."""
    cfg = base_cfg(matrix_file, tmp_path, multiplication_algo=m_algo,
                   blocking_algo=3, tau=0.5)
    row = run_experiment(cfg)
    assert row["backend"].startswith("vbr_xla")
    assert row["avg_time_multiply"] > 0


def test_inverted_transposed_backend_matches_oracle(tmp_path):
    """-M 6 (C=B*A) via the transpose trick == scipy oracle."""
    import dataclasses

    import jax.numpy as jnp

    from sparta_tpu.bench.runner import make_backend
    from sparta_tpu.cli import Config
    from sparta_tpu.formats.csr import random_block_csr
    from sparta_tpu.reorder import BlockingEngine
    from sparta_tpu.utils import get_fixed_size_grouping, get_permutation

    m = random_block_csr(96, 96, block=8, block_density=0.3,
                         intra_density=0.6, seed=13)
    cfg = Config(multiplication_algo=6, force_fixed_size=True,
                 blocking_algo=5, row_block_size=8, col_block_size=8,
                 b_cols=128, tau=0.5, dtype="float32")
    eng = BlockingEngine.from_config(cfg)
    eng.get_grouping(m)
    fn, b_shape, name, _ = make_backend(cfg, m, eng)
    assert name.startswith("ba_transposed"), name
    B = np.random.default_rng(7).standard_normal(b_shape).astype(np.float32)
    C = np.asarray(fn(jnp.asarray(B)))
    g = get_fixed_size_grouping(eng.grouping_result, 8)
    perm = get_permutation(g)
    A_r = m.permute_rows(perm).to_scipy()
    C_ref = B[:, : m.rows] @ A_r
    np.testing.assert_allclose(C[:, : m.cols], C_ref, rtol=1e-4, atol=1e-4)


def test_variable_inverted_retiled_backend_matches_oracle(tmp_path):
    """-M 11 WITHOUT -F (variable-height VBR inverted): the re-tiled
    transpose path == scipy oracle in the variable-grouping row
    order."""
    import jax.numpy as jnp

    from sparta_tpu.bench.runner import make_backend
    from sparta_tpu.cli import Config
    from sparta_tpu.formats.csr import random_block_csr
    from sparta_tpu.reorder import BlockingEngine
    from sparta_tpu.utils import get_permutation

    m = random_block_csr(200, 200, block=8, block_density=0.3,
                         intra_density=0.6, seed=17)
    cfg = Config(multiplication_algo=11, force_fixed_size=False,
                 blocking_algo=3, row_block_size=8, col_block_size=8,
                 b_cols=128, tau=0.5, dtype="float32")
    eng = BlockingEngine.from_config(cfg)
    eng.get_grouping(m)
    fn, b_shape, name, _ = make_backend(cfg, m, eng)
    assert "retiled" in name, name
    B = np.random.default_rng(7).standard_normal(b_shape).astype(np.float32)
    C = np.asarray(fn(jnp.asarray(B)))
    perm = get_permutation(eng.grouping_result)  # variable grouping, no chop
    A_r = m.permute_rows(perm).to_scipy()
    C_ref = B[:, : m.rows] @ A_r
    np.testing.assert_allclose(C[:, : m.cols], C_ref, rtol=1e-4, atol=1e-4)


def test_sweep_extract_error_line():
    from sparta_tpu.bench.sweep import _extract_error_line

    jax_err = (
        "Traceback (most recent call last):\n"
        '  File "x.py", line 3, in <module>\n'
        "jaxlib.xla_extension.XlaRuntimeError: INTERNAL: remote_compile "
        "HTTP 500\n"
        "For simplicity, JAX has removed its internal frames from the "
        "traceback of the following exception. Set JAX_TRACEBACK_FILTERING"
        "=off to include these."
    )
    line = _extract_error_line(jax_err)
    assert "XlaRuntimeError" in line and "HTTP 500" in line
    assert "JAX_TRACEBACK_FILTERING" not in line
    assert _extract_error_line("") == "?"
    assert _extract_error_line("just noise\nno exceptions here") \
        == "just noise | no exceptions here"


def test_fp8_fallthrough_times_bf16_b(matrix_file, tmp_path, monkeypatch):
    """fp8 configs quantize a bf16 B: the timed operand must be bf16 (the
    runner's dtype rule mirrors make_backend's)."""
    import jax.numpy as jnp

    import sparta_tpu.bench.runner as runner_mod

    captured = {}
    orig = runner_mod.time_op

    def spy(fn, B, **kw):
        captured["dtype"] = B.dtype
        return orig(fn, B, **kw)

    monkeypatch.setattr(runner_mod, "time_op", spy)
    cfg = base_cfg(matrix_file, tmp_path, multiplication_algo=8, dtype="fp8")
    run_experiment(cfg)
    assert captured["dtype"] == jnp.bfloat16


def test_config_hash_stable_across_new_default_fields(tmp_path):
    """Adding a defaults-only field to Config must not change cell hashes
    (cached sweep results stay valid across schema growth)."""
    import dataclasses

    from sparta_tpu.bench.sweep import config_hash

    cfg = Config(filename="m.el", tau=0.3, blocking_algo=5)
    h = config_hash(cfg)
    # defaults-only fields do not contribute: the same explicit knobs give
    # the same hash regardless of untouched fields
    cfg2 = Config(filename="m.el", tau=0.3, blocking_algo=5,
                  csr_impl="auto", autotune=False)  # explicit defaults
    assert config_hash(cfg2) == h
    # a real knob change does change the hash
    assert config_hash(dataclasses.replace(cfg, tau=0.4)) != h
    # outfile/verbose never contribute
    assert config_hash(dataclasses.replace(cfg, outfile="x", verbose=2)) == h


def test_quantized_run_emits_rel_err(tmp_path):
    """int8/fp8 runner rows must carry an end-to-end rel_err vs the fp32
    oracle on the same structure (the matched-accuracy evidence)."""
    from sparta_tpu.bench.runner import run_experiment
    from sparta_tpu.formats import random_block_csr

    m = random_block_csr(256, 256, block=128, block_density=0.5,
                         intra_density=0.4, seed=3)
    path = tmp_path / "q.el"
    m.save_to_edgelist(path)
    cfg = Config(filename=str(path), blocking_algo=2, force_fixed_size=True,
                 multiplication_algo=8, row_block_size=128,
                 col_block_size=128, b_cols=256, dtype="int8",
                 exp_repetitions=2, warmup=0, inner_iters=2,
                 outfile=str(tmp_path / "q.csv"))
    row = run_experiment(cfg)
    assert "int8" in row["backend"]
    assert 0 < row["rel_err"] < 5e-2
    header = (tmp_path / "q.csv").read_text().splitlines()[0]
    assert "rel_err" in header


@pytest.mark.parametrize("impl", ["fine", "dedup", "fell"])
def test_csr_impl_fine_family(tmp_path, impl):
    """--csr-impl {fine,dedup,fell} forces the named fine-grained kernel
    for -M 2 and stays numerically correct."""
    from sparta_tpu.bench.runner import run_experiment

    cfg = Config(filename="tests/fixtures/TEST_matrix_weighted.el",
                 blocking_algo=2, force_fixed_size=True,
                 multiplication_algo=2, b_cols=128, csr_impl=impl,
                 exp_repetitions=2, warmup=0, inner_iters=2,
                 outfile=str(tmp_path / "c.csv"))
    row = run_experiment(cfg)
    assert row["backend"] == f"csr_{impl}"
    assert row["avg_time_multiply"] > 0


def test_quantized_csr_auto_rel_err_family_pinned(tmp_path, monkeypatch):
    """-M 2 int8 with csr_impl=auto: the fp32 rel_err oracle must rebuild
    the SAME csr family the quantized run resolved to, even when a
    dtype-dependent pick would flip at float32 (which can change the
    expected B layout and crash, or silently compare across
    executions)."""
    from sparta_tpu.bench import runner as runner_mod
    from sparta_tpu.bench.runner import run_experiment
    from sparta_tpu.formats.csr import rmat_csr

    m = rmat_csr(10, edge_factor=4, seed=6)
    path = tmp_path / "g.el"
    m.save_to_edgelist(path)
    # without measuring, the auto pick is the fine family (fewest
    # multiply-adds), so the pin is exercised

    picks = []
    orig = runner_mod.make_backend

    def spy(cfg, mm, engine):
        out = orig(cfg, mm, engine)
        picks.append((cfg.dtype, cfg.csr_impl, out[2]))
        return out

    monkeypatch.setattr(runner_mod, "make_backend", spy)
    cfg = Config(filename=str(path), blocking_algo=2, force_fixed_size=True,
                 multiplication_algo=2, row_block_size=128,
                 col_block_size=128, b_cols=256, dtype="int8",
                 exp_repetitions=2, warmup=0, inner_iters=2)
    row = run_experiment(cfg)
    assert 0 <= row["rel_err"] < 5e-2
    # the oracle rebuild must target the family the quantized run picked
    (qdtype, _, qname), (odtype, oimpl, oname) = picks[-2:]
    assert odtype == "float32"
    assert "csr_auto_fine[" in qname, qname  # the pin must be exercised
    fam = qname.split("[")[1].rstrip("]")
    assert oimpl == fam
    assert oname.startswith(("csr_fine", "csr_dedup", "csr_fell"))


def test_sweep_adopts_legacy_hash_cells(matrix_file, tmp_path):
    """A config_hash scheme change must not re-run cached cells or leave
    duplicate rows behind: run_sweep renames a cached cell whose row
    CONTENT matches the config from its legacy hash to the current one."""
    import json

    from sparta_tpu.bench.sweep import config_hash, run_sweep

    base = Config(exp_name="legacy", multiplication_algo=0, b_cols=128,
                  tau=0.2, row_block_size=3, col_block_size=3)
    # first run populates the cache under the CURRENT scheme
    rows = run_sweep([matrix_file], {}, tmp_path, base=base)
    assert len(rows) == 1
    cfg = Config(**{**base.__dict__, "filename": str(matrix_file)})
    h = config_hash(cfg)
    stem = matrix_file.rsplit("/", 1)[-1].rsplit(".", 1)[0]
    cur = tmp_path / f"{stem}_{h}.json"
    assert cur.exists()
    # simulate a legacy scheme: move every artifact to a different hash
    for ext in (".json", ".csv", ".csv.json", ".csv.g"):
        p = tmp_path / f"{stem}_{h}{ext}"
        if p.exists():
            p.rename(tmp_path / f"{stem}_00legacyhash00{ext}")
    t0 = json.loads((tmp_path / f"{stem}_00legacyhash00.json").read_text())
    # resume: the legacy cell must be ADOPTED (renamed), not re-run
    rows2 = run_sweep([matrix_file], {}, tmp_path, base=base)
    assert cur.exists()
    assert not (tmp_path / f"{stem}_00legacyhash00.json").exists()
    assert rows2[0]["avg_time_multiply"] == t0["avg_time_multiply"]
    # exactly one .json cell (+ .csv.json sidecar) — no duplicates
    cells = [p for p in tmp_path.glob(f"{stem}_*.json")
             if not p.name.endswith(".csv.json")]
    assert len(cells) == 1
    # a DIFFERENT config must not adopt it
    other = Config(**{**base.__dict__, "tau": 0.5})
    rows3 = run_sweep([matrix_file], {}, tmp_path, base=other)
    assert cur.exists() and len(rows3) == 1


def test_adoption_distinguishes_late_knobs(matrix_file, tmp_path):
    """A cell differing ONLY in csr_impl/tile_n/inner_iters/
    autotune/dtype must never be adopted (renamed) as a sibling's cache —
    a grid over csr_impl=[fine,dedup] would otherwise record one impl's
    results under the other's hash and delete the first's artifacts."""
    import dataclasses
    import json

    from sparta_tpu.bench.sweep import _row_matches, config_hash, run_sweep

    base = Config(exp_name="lateknob", multiplication_algo=0, b_cols=128,
                  tau=0.2, row_block_size=3, col_block_size=3,
                  csr_impl="fine")
    rows = run_sweep([matrix_file], {}, tmp_path, base=base)
    assert rows and rows[0]["csr_impl"] == "fine"
    stem = matrix_file.rsplit("/", 1)[-1].rsplit(".", 1)[0]
    cfg_fine = dataclasses.replace(base, filename=str(matrix_file))
    fine_cell = tmp_path / f"{stem}_{config_hash(cfg_fine)}.json"
    assert fine_cell.exists()
    # the sibling config differing only in a late knob must NOT match
    row = json.loads(fine_cell.read_text())
    for variant in (dataclasses.replace(cfg_fine, csr_impl="dedup"),
                    dataclasses.replace(cfg_fine, tile_n=256),
                    dataclasses.replace(cfg_fine, inner_iters=4),
                    dataclasses.replace(cfg_fine, autotune=True),
                    dataclasses.replace(cfg_fine, dtype="bfloat16")):
        assert not _row_matches(row, variant)
    assert _row_matches(row, cfg_fine)
    # a LEGACY row (pre-knob schema) is adopted only by the default config
    legacy = {k: v for k, v in row.items()
              if k not in ("csr_impl", "tile_n", "inner_iters", "autotune",
                           "dtype")}
    assert not _row_matches(legacy, cfg_fine)          # non-default knob
    cfg_default = dataclasses.replace(cfg_fine, csr_impl="auto")
    assert _row_matches(legacy, cfg_default)
    # end-to-end: the dedup sibling run leaves the fine cell untouched
    rows2 = run_sweep([matrix_file], {"csr_impl": ["dedup"]}, tmp_path,
                      base=base)
    assert fine_cell.exists()
    assert rows2[0]["csr_impl"] == "dedup"


@pytest.mark.parametrize("impl", ["fine", "dedup"])
def test_csr_impl_int8_gathered(tmp_path, impl):
    """-M 2 --dtype int8 with an explicit fine-family impl runs the
    int8-GATHERED B variant, reported as csr_<impl>_int8 with the
    quantized-accuracy rel_err column populated."""
    from sparta_tpu.bench.runner import run_experiment
    from sparta_tpu.formats.csr import rmat_csr

    m = rmat_csr(9, edge_factor=4, seed=8)
    path = tmp_path / "g.el"
    m.save_to_edgelist(path)
    cfg = Config(filename=str(path), blocking_algo=2, force_fixed_size=True,
                 multiplication_algo=2, b_cols=256, csr_impl=impl,
                 dtype="int8", exp_repetitions=2, warmup=0, inner_iters=2,
                 outfile=str(tmp_path / "c.csv"))
    row = run_experiment(cfg)
    assert row["backend"] == f"csr_{impl}_int8"
    assert 0 < row["rel_err"] < 1e-2
