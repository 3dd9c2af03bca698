"""Full experiment campaign on the GPU: the L5/L6 workflow end-to-end.

Mirrors the reference's multiplication-experiment campaign
(run_multiplication_experiments_fixed_cluster.sh): generate the synthetic
matrix suite, run the named flag bundles (BCSR_reord / BCSR_no_reord / CSR /
GEMM / PALLAS_blocked) over it with skip-if-exists resume, collate the
per-run CSVs, and render the comparison plots.

Usage: python scripts/campaign.py [--scale medium] [--out results/campaign]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="medium")
    ap.add_argument("--out", default="results/campaign")
    ap.add_argument("--b-cols", type=int, default=2048)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--bundles", default="BCSR_reord,BCSR_no_reord,CSR,GEMM,PALLAS_blocked")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--autotune", action="store_true")
    args = ap.parse_args()

    from sparta_tpu.runtime import require_gpu, setup_compile_cache

    setup_compile_cache()
    require_gpu()
    from sparta_tpu.bench.sweep import EXPERIMENT_BUNDLES, collect_csvs, run_sweep
    from sparta_tpu.cli import Config
    from sparta_tpu.datasets import synthetic_suite

    out = Path(args.out)
    mat_dir = out / "matrices"
    mat_dir.mkdir(parents=True, exist_ok=True)

    t0 = time.time()
    suite = synthetic_suite(args.scale)
    matrices = []
    for name, m in suite.items():
        p = mat_dir / f"{name}.el"
        if not p.exists():
            m.save_to_edgelist(p)
        matrices.append(str(p))
    log(f"suite ({args.scale}): {len(matrices)} matrices "
        f"({time.time()-t0:.0f}s)")

    all_rows = []
    for bundle in args.bundles.split(","):
        flags = EXPERIMENT_BUNDLES[bundle]
        base = Config(exp_name=bundle, b_cols=args.b_cols,
                      row_block_size=args.block, col_block_size=args.block,
                      tau=0.3, dtype=args.dtype, autotune=args.autotune)
        for k, v in flags.items():
            setattr(base, k, v)

        def on_result(row, bundle=bundle):
            # avg_time_multiply is already in ms (reference schema)
            log(f"{bundle:18s} {Path(row.get('matrix','?')).stem:18s} "
                f"avg {row.get('avg_time_multiply', float('nan')):9.3f} ms  "
                f"backend {row.get('backend','?')}")

        t0 = time.time()
        rows = run_sweep(matrices, {}, out / "cells", base=base,
                         on_result=on_result, isolate=True)
        log(f"bundle {bundle}: {len(rows)} cells ({time.time()-t0:.0f}s)")
        all_rows.extend(rows)

    n = collect_csvs(out / "cells", out / "campaign.csv")
    log(f"collected {n} csv rows -> {out/'campaign.csv'}")

    try:
        from sparta_tpu.bench.plots import (
            load_results,
            plot_blocking_quality,
            plot_speedup_heatmap,
            plot_spmm_times,
        )

        df = load_results(out / "campaign.csv")
        plot_blocking_quality(df, out / "blocking_quality.png")
        plot_spmm_times(df, out / "spmm_times.png")
        plot_speedup_heatmap(df, out / "speedup_heatmap.png")
        log(f"plots -> {out}")
    except Exception as e:  # noqa: BLE001 — plots are best-effort
        log(f"plotting failed: {type(e).__name__}: {e}")

    # summary: per matrix, blocked time vs CSR
    by = {}
    for r in all_rows:
        key = Path(str(r.get("matrix", "?"))).stem
        by.setdefault(key, {})[r.get("exp_name")] = r.get("avg_time_multiply")
    summary = {}
    for mname, d in sorted(by.items()):
        csr = d.get("CSR")
        blocked = min(
            (v for k, v in d.items()
             if k in ("BCSR_reord", "PALLAS_blocked") and v), default=None)
        if csr and blocked:
            summary[mname] = round(csr / blocked, 2)
    print(json.dumps({"speedup_vs_csr_by_matrix": summary}), flush=True)


if __name__ == "__main__":
    main()
