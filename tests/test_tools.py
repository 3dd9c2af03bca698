"""Tools/sweep/plots layer tests."""
import json

import numpy as np
import pytest

from sparta_tpu.bench.sweep import collect_csvs, config_hash, run_sweep
from sparta_tpu.cli import Config
from sparta_tpu.formats import random_block_csr, write_grouping
from sparta_tpu.tools import main as tools_main


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("tools") / "m.el"
    random_block_csr(96, 96, block=16, block_density=0.3, seed=5).save_to_edgelist(p)
    return str(p)


def test_analyze_matches_engine(matrix_file, capsys):
    tools_main(["analyze", matrix_file, "16"])
    out = capsys.readouterr().out.split()
    assert len(out) == 4 and int(out[0]) > 0


def test_analyze_external_grouping(matrix_file, tmp_path, capsys):
    from sparta_tpu.formats import read_matrix

    rows = read_matrix(matrix_file).rows
    g = np.random.default_rng(0).integers(0, 6, rows)
    gf = tmp_path / "ext.g"
    write_grouping(gf, g)
    tools_main(["analyze", matrix_file, "16", str(gf)])
    n1 = int(capsys.readouterr().out.split()[0])
    tools_main(["analyze", matrix_file, "16", str(gf), "--symmetric"])
    n2 = int(capsys.readouterr().out.split()[0])
    assert n1 > 0 and n2 > 0


def test_reorder_tool(matrix_file, tmp_path, capsys):
    tools_main(["reorder", matrix_file, "--block-size", "16",
                "--taus", "0.5,0.2", "--out", str(tmp_path / "g.g"),
                "--out-matrix", str(tmp_path / "r.el")])
    out = capsys.readouterr().out
    assert "best tau" in out
    assert (tmp_path / "g.g").exists() and (tmp_path / "r.el").exists()


def test_similarity_tool(matrix_file, capsys):
    tools_main(["similarity", matrix_file, "0", "1", "--block-size", "16"])
    out = capsys.readouterr().out
    assert "jaccard" in out and "hamming_alt" in out


def test_sweep_resume(matrix_file, tmp_path):
    grid = {"tau": [0.3, 0.6], "blocking_algo": [2, 3]}
    base = Config(multiplication_algo=0, row_block_size=16, col_block_size=16,
                  verbose=0)
    r1 = run_sweep([matrix_file], grid, tmp_path / "sw", base=base)
    assert len(r1) == 4
    # resume: all cells cached, results identical
    r2 = run_sweep([matrix_file], grid, tmp_path / "sw", base=base)
    assert [round(x["VBR_nzcount"]) for x in r1] == [
        round(x["VBR_nzcount"]) for x in r2
    ]
    n = collect_csvs(tmp_path / "sw", tmp_path / "all.csv")
    assert n == 4


def test_config_hash_stability():
    c1, c2 = Config(tau=0.3), Config(tau=0.3)
    assert config_hash(c1) == config_hash(c2)
    assert config_hash(Config(tau=0.4)) != config_hash(c1)


def test_plots(matrix_file, tmp_path):
    grid = {"tau": [0.3, 0.6], "blocking_algo": [2, 3],
            "multiplication_algo": [0]}
    base = Config(row_block_size=16, col_block_size=16, verbose=0)
    run_sweep([matrix_file], grid, tmp_path / "sw", base=base)
    collect_csvs(tmp_path / "sw", tmp_path / "all.csv")
    tools_main(["plot", str(tmp_path / "all.csv"), "--out-dir", str(tmp_path / "im")])
    assert (tmp_path / "im" / "blocking_quality.png").exists()
    assert (tmp_path / "im" / "spmm_times.png").exists()


def test_derived_metrics():
    from sparta_tpu.bench.plots import add_derived_metrics, load_results
    import pandas as pd

    df = pd.DataFrame({
        "matrix": ["m", "m"], "rows": [100, 100], "cols": [100, 100],
        "nonzeros": [500, 500], "VBR_nzcount": [5000, 2500],
        "blocking_algo": [2, 5], "row_block_size": [16, 16],
        "col_block_size": [16, 16], "b_cols": [64, 64],
        "avg_time_multiply": [1.0, 0.5],
    })
    out = add_derived_metrics(df)
    assert out["density"].iloc[0] == pytest.approx(0.05)
    assert out["block_density"].iloc[1] == pytest.approx(0.2)
    assert out["relative_dense_amp"].iloc[1] == pytest.approx(2.0)


def test_blocking_cache(matrix_file, tmp_path):
    from sparta_tpu.bench.cache import cached_grouping
    from sparta_tpu.definitions import BlockingType
    from sparta_tpu.formats import read_matrix
    from sparta_tpu.reorder import BlockingEngine

    m = read_matrix(matrix_file)
    e1 = BlockingEngine(tau=0.4, col_block_size=16, row_block_size=16,
                        blocking_algo=BlockingType.iterative_clocked)
    g1 = cached_grouping(m, e1, tmp_path / "cache")
    assert e1.merge_counter > 0
    # second engine: cache hit restores grouping + counters without running
    e2 = BlockingEngine(tau=0.4, col_block_size=16, row_block_size=16,
                        blocking_algo=BlockingType.iterative_clocked)
    g2 = cached_grouping(m, e2, tmp_path / "cache")
    np.testing.assert_array_equal(g1, g2)
    assert e2.merge_counter == e1.merge_counter
    # different tau -> different cache cell
    e3 = BlockingEngine(tau=0.9, col_block_size=16, row_block_size=16,
                        blocking_algo=BlockingType.iterative_clocked)
    g3 = cached_grouping(m, e3, tmp_path / "cache")
    assert len(list((tmp_path / "cache").glob("*.npz"))) == 2


def test_profiling_subsystem():
    from sparta_tpu.profiling import PhaseTimer, annotate

    t = PhaseTimer()
    with t.phase("compare"):
        with annotate("sparta_compare"):
            sum(range(1000))
    with t.phase("compare"):
        pass
    assert t.us("compare") > 0


def test_synthetic_suite():
    from sparta_tpu.datasets import banded_csr, synthetic_suite

    suite = synthetic_suite("small")
    assert set(suite) == {"uniform_sparse", "uniform_denser", "blocked_shuffled",
                          "banded", "rmat", "fem_2d", "fem_3d"}
    for name, m in suite.items():
        assert m.nnz > 0, name
    b = banded_csr(64, 4, density=1.0)
    d = b.to_dense()
    assert d[0, 10] == 0 and d[10, 10] != 0


def test_config_argv_roundtrip():
    import dataclasses

    from sparta_tpu.cli import Config, config_to_argv, parse_args

    cfg = Config(multiplication_algo=8, force_fixed_size=True, blocking_algo=5,
                 row_block_size=128, col_block_size=128, b_cols=2048, tau=0.25,
                 dtype="bfloat16", exp_name="X", filename="m.el",
                 outfile="o.csv")
    back = parse_args(config_to_argv(cfg))
    for f in dataclasses.fields(Config):
        if f.name in ("reader_delimiter", "save_grouping"):
            continue  # no CLI flag
        assert getattr(back, f.name) == getattr(cfg, f.name), f.name


def test_run_sweep_isolated(matrix_file, tmp_path):
    import dataclasses

    from sparta_tpu.bench.sweep import run_sweep
    from sparta_tpu.cli import Config

    base = Config(multiplication_algo=3, force_fixed_size=True,
                  blocking_algo=2, row_block_size=3, col_block_size=3,
                  b_cols=8, tau=0.5, verbose=0)
    rows = run_sweep([matrix_file], {}, tmp_path / "sw", base=base,
                     isolate=True)
    assert len(rows) == 1
    assert rows[0]["avg_time_multiply"] > 0


def test_analysis_layer(tmp_path):
    # method-comparison semantics: geomeans, tie-to-original win counts
    import pandas as pd

    from sparta_tpu.bench.analysis import (
        best_method_counts,
        geomean_improvements,
        method_comparison_table,
        plot_improvement_violin,
        plot_method_comparison,
        plot_tau_curves,
    )

    rows = []
    for mat, (orig, sim, deg) in {
        "m1": (100, 50, 100),   # similarity 2x better; degree ties original
        "m2": (80, 80, 40),     # degree 2x better; similarity ties
    }.items():
        for method, v in (("original", orig), ("similarity", sim),
                          ("degree", deg)):
            rows.append(dict(matrix=mat, method=method, tau=0.1,
                             row_block_size=64, col_block_size=64,
                             VBR_nzcount=v, VBR_nzblocks_count=v // 10 + 1,
                             rows=10, cols=10, nonzeros=20))
    df = pd.DataFrame(rows)
    g = geomean_improvements(df, "VBR_nzcount")
    assert g["original"] == pytest.approx(1.0)
    assert g["similarity"] == pytest.approx(2 ** 0.5)  # geomean(2, 1)
    assert g["degree"] == pytest.approx(2 ** 0.5)
    c = best_method_counts(df, "VBR_nzcount")
    # ties go to original: m1 -> similarity wins, m2 -> degree wins
    assert c == {"original": 0, "similarity": 1, "degree": 1}
    t = method_comparison_table(df, "VBR_nzcount")
    assert set(t["method"]) == {"original", "similarity", "degree"}
    plot_method_comparison(df, tmp_path / "mc.png")
    plot_improvement_violin(df, tmp_path / "vi.png")
    plot_tau_curves(df[df["method"] == "similarity"], tmp_path / "tc.png")
    assert (tmp_path / "mc.png").exists()
    assert (tmp_path / "vi.png").exists()
    assert (tmp_path / "tc.png").exists()


def test_compare_command(tmp_path):
    from sparta_tpu.formats import random_block_csr
    from sparta_tpu.tools import main as tools_main

    m = random_block_csr(128, 128, block=16, block_density=0.2,
                         intra_density=0.6, seed=21)
    el = tmp_path / "blocky.el"
    m.save_to_edgelist(el)
    tools_main([
        "compare", str(el), "--block-sizes", "16", "--taus", "0.5,0.2",
        "--out-dir", str(tmp_path / "cmp"),
    ])
    import pandas as pd

    table = pd.read_csv(tmp_path / "cmp" / "method_table.csv")
    sim = table[table["method"] == "similarity"]["geomean_improvement"].iloc[0]
    scr = table[table["method"] == "scramble"]["geomean_improvement"].iloc[0]
    # on a planted-block matrix similarity must beat the scramble baseline
    assert sim > scr
    assert (tmp_path / "cmp" / "method_comparison.png").exists()
    assert (tmp_path / "cmp" / "tau_curves.png").exists()


def test_analyze_csv_append(tmp_path):
    # the CLUBS collect step: external scores accumulate into one CSV
    from sparta_tpu.formats import random_uniform_csr
    from sparta_tpu.tools import main as tools_main

    m = random_uniform_csr(40, 40, 0.1, seed=3)
    el = tmp_path / "u.el"
    m.save_to_edgelist(el)
    csv_out = tmp_path / "scores.csv"
    for label in ("original", "external1"):
        tools_main(["analyze", str(el), "8", "--csv", str(csv_out),
                    "--exp-name", label])
    import pandas as pd

    df = pd.read_csv(csv_out)
    assert len(df) == 2 and set(df["method"]) == {"original", "external1"}


def test_collect_csvs_merges_mixed_schemas(tmp_path):
    """Cells written by different framework versions carry different
    EXTRA column tails; collation must merge BY NAME, never paste raw
    rows under a mismatched header."""
    d = tmp_path / "cells"
    d.mkdir()
    (d / "a_old.csv").write_text("exp_name,rows,backend\nfoo,10,bell\n")
    (d / "b_new.csv").write_text(
        "exp_name,rows,backend,rel_err,counter_domain\n"
        "bar,20,fine,0.001,full\n")
    n = collect_csvs(d, tmp_path / "all.csv")
    assert n == 2
    import csv

    rows = list(csv.DictReader((tmp_path / "all.csv").open()))
    assert rows[0]["backend"] == "bell" and rows[0]["counter_domain"] == ""
    assert rows[1]["rel_err"] == "0.001"


def test_plan_subcommand(matrix_file, capsys):
    from sparta_tpu.tools import main

    main(["plan", matrix_file, "-c", "256", "-b", "3"])
    out = capsys.readouterr().out
    assert "unstructured (csr_spmm_auto) candidates" in out
    assert "<- fewest" in out
    main(["plan", matrix_file, "-c", "256", "-b", "3", "-t", "0.5"])
    out = capsys.readouterr().out
    assert "reordered blocking (algo 3, tau=0.5)" in out


def test_plan_audit_writes_provenance_json(tmp_path, monkeypatch):
    """tools plan --audit measures every candidate, names a measured
    winner, and writes a provenance-stamped JSON that a CPU run reroutes
    to *_cpu.json (never the canonical hardware path)."""
    import json

    from sparta_tpu.formats import random_uniform_csr
    from sparta_tpu.tools import main as tools_main

    m = random_uniform_csr(64, 64, 0.05, seed=9)
    el = tmp_path / "aud.el"
    m.save_to_edgelist(el)
    monkeypatch.chdir(tmp_path)
    tools_main(["plan", str(el), "-c", "128", "--audit"])
    p = tmp_path / "results" / "plan_audit_aud_cpu.json"
    assert p.exists(), "CPU audit must land at *_cpu.json"
    doc = json.loads(p.read_text())
    assert doc["_provenance"]["backend"] == "cpu"
    assert doc["measured_pick"] in doc["candidates"]
    assert "mispick" in doc
    measured = [c for c in doc["candidates"].values() if "measured_ms" in c]
    assert len(measured) >= 2  # at least two candidates actually timed
