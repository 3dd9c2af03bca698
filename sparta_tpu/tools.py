"""Companion tools — counterparts of the reference's driver
programs (SURVEY §2.5), as subcommands:

  analyze     ≡ Matrix_Analysis   : score a grouping (own or external .g)
  reorder     ≡ reorder_matrix    : tau sweep -> save reordered matrix
  similarity  ≡ TEST_similarities : distance functions on a row pair
  blocking    ≡ Matrix_Blocking   : blocking-only experiment (CSV + .g)
  sweep                           : grid sweep with skip-if-exists resume
  collect     ≡ collect_experiments.sh : concatenate per-run CSVs
  plot                            : blocking-quality / SpMM-time figures
  plan                            : explain the kernel selector's choice

Usage: python -m sparta_tpu.tools <subcommand> [args]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def cmd_analyze(args):
    """Score a (possibly external) grouping: reorder, fixed-block, print the
    4 stats (reference Matrix_Analysis.cpp:36-99, used to score
    METIS/PaToH/CLUBS orderings)."""
    from .definitions import BlockingType
    from .formats import read_grouping, read_matrix
    from .reorder import BlockingEngine

    m = read_matrix(args.matrix)
    if args.grouping:
        g = read_grouping(args.grouping, expected_rows=m.rows)
        if args.symmetric:
            if m.rows != m.cols:  # 2d reorder needs a square matrix
                n = max(m.rows, m.cols)
                m = m.with_shape((n, n))
                if g.size < n:  # padding rows become their own groups
                    extra = g.max() + 1 + np.arange(n - g.size)
                    g = np.concatenate((g, extra))
            m = m.reorder2d(g)
        else:
            m = m.reorder(g)
    eng = BlockingEngine(
        col_block_size=args.block_size, row_block_size=args.block_size,
        blocking_algo=BlockingType.fixed_size,
    )
    eng.get_grouping(m)
    eng.collect_blocking_info(m)
    print(f"{eng.VBR_nzcount} {eng.VBR_nzblocks_count} "
          f"{eng.VBR_average_height} {eng.VBR_longest_row}")
    if args.csv:
        # append a schema row so externally scored orderings feed the same
        # method-comparison layer (the CLUBS collect step)
        import csv as csvmod

        row = dict(
            matrix=args.matrix, rows=m.rows, cols=m.cols, nonzeros=m.nnz,
            method=args.exp_name or "external", exp_name=args.exp_name or "external",
            tau=0.0, row_block_size=args.block_size,
            col_block_size=args.block_size,
            VBR_nzcount=eng.VBR_nzcount,
            VBR_nzblocks_count=eng.VBR_nzblocks_count,
            VBR_average_height=eng.VBR_average_height,
            VBR_longest_row=eng.VBR_longest_row,
        )
        p = Path(args.csv)
        p.parent.mkdir(parents=True, exist_ok=True)
        new = not p.exists()
        with open(p, "a", newline="") as f:
            w = csvmod.DictWriter(f, fieldnames=list(row))
            if new:
                w.writeheader()
            w.writerow(row)


def cmd_reorder(args):
    """Tau sweep; save the best reordered matrix and grouping
    (reference reorder_matrix.cpp:17-57)."""
    from .bench.tau import search_tau
    from .formats import read_matrix, write_grouping

    m = read_matrix(args.matrix, pattern_only=args.pattern_only)
    res = search_tau(
        m, args.block_size, args.block_size,
        taus=[float(t) for t in args.taus.split(",")],
        force_fixed_size=not args.variable,
    )
    print(f"best tau: {res.best_tau}  nzblocks {res.natural_nzblocks} -> "
          f"{res.nzblocks}")
    stem = Path(args.matrix)
    if res.grouping is None:
        # tau = -1 sentinel: natural blocking wins, nothing to save
        # (reference collect_taus.py:38-43 semantics)
        print("natural blocking is best; no reordered matrix saved")
    if res.grouping is not None:
        write_grouping(args.out or f"{stem.stem}.g", res.grouping)
        reordered = m.reorder(res.grouping)
        out_el = args.out_matrix or f"{stem.stem}_reordered.el"
        reordered.save_to_edgelist(out_el)
        print(f"saved {out_el}")


def cmd_similarity(args):
    """All four distance functions on a row pair
    (reference TEST_similarities.cpp:14-36)."""
    from .definitions import SimMeasure
    from .formats import read_matrix
    from .reorder import distance_pair
    from .reorder.signatures import block_signatures

    m = read_matrix(args.matrix)
    sigs = block_signatures(m, args.block_size)
    i, j = args.row_a, args.row_b
    ea = int(m.row_nnz[i])
    eb = int(m.row_nnz[j])
    for meas in SimMeasure:
        d = distance_pair(meas, sigs[i], sigs[j], elems_a=ea, elems_b=eb)
        print(f"{meas.name:12s}: {d:.6f}")


def cmd_blocking(args):
    """Blocking-only experiment (reference Matrix_Blocking.cpp)."""
    from .cli import main as cli_main

    cli_main([
        "-f", args.matrix, "-o", args.out, "-a", str(args.algo),
        "-t", str(args.tau), "-b", str(args.block_size),
        "-B", str(args.block_size), "-M", "0",
        "-F", "1" if args.force_fixed else "0", "-v", str(args.verbose),
    ])


def _ordering_grouping(method: str, m, seed: int = 123) -> np.ndarray:
    """Row grouping induced by an EXTERNAL ordering method.

    The CLUBS workflow scores orderings produced outside the blocking engine
    (reference utils/collect_results_clubs.sh:70 feeds METIS/PaToH/Saad .g
    files to Matrix_Analysis).  Here the external producers are classic
    orderings available in-image: degree sort and scipy's reverse
    Cuthill-McKee (the METIS-style bandwidth/locality reduction stand-in).
    Returns grouping = new position per original row (inverse permutation).
    """
    if method == "degree":
        perm = np.argsort(-m.row_nnz, kind="stable")
    elif method == "rcm":
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        n = max(m.rows, m.cols)
        a = m.with_shape((n, n)).to_scipy().tocsr()
        sym = ((a + a.T) != 0).astype(np.int8).tocsr()
        perm = np.asarray(reverse_cuthill_mckee(sym, symmetric_mode=True))
        perm = perm[perm < m.rows]
    elif method == "scramble":
        perm = np.random.default_rng(seed).permutation(m.rows)
    else:
        raise ValueError(f"unknown ordering method {method}")
    g = np.empty(m.rows, dtype=np.int64)
    g[perm] = np.arange(m.rows)
    return g


def cmd_compare(args):
    """Method-comparison workflow end-to-end (the reference's CLUBS
    pipeline): score {original, similarity-reordered, degree, rcm, scramble}
    on each matrix x block size through the SAME fixed-block scorer
    (Matrix_Analysis semantics), then emit the geomean-improvement /
    best-method-count tables, violins, and tau curves from one command
    (images_utils.py:31-62, curves_plots.py)."""
    import pandas as pd

    from .bench.analysis import (
        method_comparison_table,
        plot_improvement_violin,
        plot_method_comparison,
        plot_tau_curves,
    )
    from .bench.tau import search_tau
    from .definitions import BlockingType
    from .formats import read_matrix
    from .reorder import BlockingEngine

    taus = [float(t) for t in args.taus.split(",")]
    blocks = [int(b) for b in args.block_sizes.split(",")]
    methods = args.methods.split(",")
    rows = []

    def score(m, name, label, b, tau=0.0):
        eng = BlockingEngine(
            col_block_size=b, row_block_size=b,
            blocking_algo=BlockingType.fixed_size,
        )
        eng.get_grouping(m)
        eng.collect_blocking_info(m)
        rows.append(dict(
            matrix=name, rows=m.rows, cols=m.cols, nonzeros=m.nnz,
            method=label, exp_name=label, tau=tau,
            row_block_size=b, col_block_size=b,
            VBR_nzcount=eng.VBR_nzcount,
            VBR_nzblocks_count=eng.VBR_nzblocks_count,
            VBR_average_height=eng.VBR_average_height,
            VBR_longest_row=eng.VBR_longest_row,
        ))

    for path in args.matrices:
        m = read_matrix(path, pattern_only=True)
        name = Path(path).stem
        for b in blocks:
            for method in methods:
                if method == "original":
                    score(m, name, "original", b)
                elif method == "similarity":
                    # fixed-size blocks like every other method's scorer
                    res = search_tau(m, b, b, taus=taus,
                                     force_fixed_size=True)
                    # per-tau rows feed the tau curves; the comparison layer
                    # then takes the best row per (method, matrix)
                    for tau, st in res.per_tau_stats.items():
                        rows.append(dict(
                            matrix=name, rows=m.rows, cols=m.cols,
                            nonzeros=m.nnz, method="similarity",
                            exp_name="similarity", tau=tau,
                            row_block_size=b, col_block_size=b,
                            **st,
                        ))
                else:
                    g = _ordering_grouping(method, m)
                    score(m.reorder(g), name, method, b)
        print(f"scored {name}", file=sys.stderr)

    df = pd.DataFrame(rows)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    df.to_csv(out / "method_comparison.csv", index=False)
    table = method_comparison_table(df, metric=args.metric)
    table.to_csv(out / "method_table.csv", index=False)
    print(table.to_string(index=False))
    plot_method_comparison(df, out / "method_comparison.png", metric=args.metric)
    plot_improvement_violin(df, out / "improvement_violin.png", metric=args.metric)
    sim = df[df["method"] == "similarity"]
    if len(sim):
        plot_tau_curves(sim, out / "tau_curves.png")
    print(f"wrote comparison artifacts to {out}")


def _plan_audit(args, m, N, dtype, table, chosen):
    """Measure every feasible csr_work_table candidate on the current
    backend: measured time beside the work count, and a MISPICK flag when
    the fewest-work choice is >1.5x slower (measured) than the true winner.
    Writes results/plan_audit_<stem>.json with provenance (meaningful
    numbers need the GPU; a CPU run is rerouted to *_cpu.json)."""
    import numpy as np

    import jax.numpy as jnp

    from .bench.results import write_result
    from .bench.timing import time_op
    from .ops.csr_spmm import csr_candidate_fn

    B = jnp.asarray(
        np.random.default_rng(0).standard_normal((m.cols, N)), dtype=dtype)
    print("\naudit (measured on this backend):")
    audit = {"matrix": args.matrix, "rows": m.rows, "cols": m.cols,
             "nnz": m.nnz, "b_cols": N, "dtype": args.dtype,
             "work_pick": chosen, "candidates": {}}
    measured = {}
    for name, work in sorted(table.items(), key=lambda kv: kv[1]):
        if work == float("inf"):
            audit["candidates"][name] = {"status": "does not fit"}
            continue
        fn = csr_candidate_fn(m, N, name, dtype=dtype)
        avg, std, _ = time_op(fn, B, warmup=1, reps=2)
        measured[name] = avg
        audit["candidates"][name] = {"macs": work, "measured_ms": avg * 1e3}
        print(f"  {name:12s} {work:14.4g} MACs  measured {avg*1e3:9.3f} ms")
        del fn
    true_win = min(measured, key=measured.get)
    audit["measured_pick"] = true_win
    mispick = (chosen in measured and true_win != chosen
               and measured[chosen] > 1.5 * measured[true_win])
    audit["mispick"] = bool(mispick)
    print(f"  measured winner: {true_win}"
          + (f"  ** MISPICK: work count chose {chosen} "
             f"({measured[chosen]/measured[true_win]:.2f}x slower) **"
             if mispick else ""))
    stem = Path(args.matrix).stem
    p = write_result(f"results/plan_audit_{stem}.json", audit, hw_only=True)
    print(f"  audit -> {p}")


def cmd_plan(args):
    """Explain what the selectors would run for a matrix: the unstructured
    csr_spmm_auto candidate table (multiply-adds per call, the count it
    ranks when it does not measure) and plan_spmm's blocked candidates on
    the natural (or reordered) blocking."""
    import jax.numpy as jnp

    from .formats import bell_from_csr, read_matrix
    from .ops.csr_spmm import csr_work_table
    from .ops.select import _candidates, _rule

    m = read_matrix(args.matrix, pattern_only=True)
    dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
             "int8": jnp.bfloat16, "fp8": jnp.bfloat16}[args.dtype]
    N = args.b_cols
    print(f"{args.matrix}: {m.rows}x{m.cols} nnz={m.nnz} "
          f"fill={m.nnz / max(m.rows * m.cols, 1):.4%}  N={N} {args.dtype}")

    table, aux = csr_work_table(m, N, dtype)
    chosen = min(table, key=table.get)
    print(f"\nunstructured (csr_spmm_auto) candidates "
          f"[natural-128 nzblocks={aux['natural_nzblocks']}, "
          f"dedup distinct pairs={aux['dedup_n_uniq']}]:")
    for name, work in sorted(table.items(), key=lambda kv: kv[1]):
        mark = " <- fewest" if name == chosen else ""
        val = "does not fit" if work == float("inf") else f"{work:14.4g} MACs"
        print(f"  {name:12s} {val}{mark}")

    if getattr(args, "audit", False):
        _plan_audit(args, m, N, dtype, table, chosen)

    grouping = None
    if args.tau is not None:
        from .definitions import BlockingType
        from .reorder import BlockingEngine

        eng = BlockingEngine(tau=args.tau, col_block_size=args.block,
                             row_block_size=args.block,
                             blocking_algo=BlockingType(args.algo),
                             force_fixed_size=True)
        grouping = eng.get_grouping(m)
        print(f"\nreordered blocking (algo {args.algo}, tau={args.tau}):")
    else:
        print("\nnatural blocking (pass --tau to reorder first):")
    bell = bell_from_csr(m, grouping, block_row_size=args.block,
                         block_col_size=args.block)
    kinds = _candidates(bell, dtype)
    pick = _rule(bell, kinds)
    print(f"  {bell.total_nzblocks} nonzero {args.block}-blocks; candidates "
          f"(measured on the GPU): {', '.join(kinds)}; without measuring: "
          f"{pick}")


def cmd_sweep(args):
    from .bench.sweep import run_sweep
    from .cli import Config

    spec = json.loads(Path(args.spec).read_text())
    base = Config()
    for k, v in spec.get("base", {}).items():
        setattr(base, k, v)
    results = run_sweep(
        spec["matrices"], spec["grid"], args.out_dir, base=base,
        resume=not args.no_resume,
    )
    print(f"{len(results)} experiments complete")


def cmd_collect(args):
    from .bench.sweep import collect_csvs

    n = collect_csvs(args.out_dir, args.dest)
    print(f"collected {n} rows -> {args.dest}")


def cmd_plot(args):
    from .bench.plots import (
        load_results,
        plot_blocking_quality,
        plot_speedup_heatmap,
        plot_spmm_times,
    )

    df = load_results(args.csv)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    plot_blocking_quality(df, out / "blocking_quality.png")
    plot_spmm_times(df, out / "spmm_times.png")
    if (df["exp_name"] == "CSR").any():
        plot_speedup_heatmap(df, out / "speedup_heatmap.png")
    # method-comparison figures when several methods share matrices
    mcol = "method" if "method" in df.columns else "exp_name"
    if df[mcol].nunique() > 1 and {"original", "similarity"} & set(df[mcol]):
        from .bench.analysis import (
            plot_improvement_violin,
            plot_method_comparison,
            plot_tau_curves,
        )

        base = "original" if (df[mcol] == "original").any() else df[mcol].iloc[0]
        plot_method_comparison(df, out / "method_comparison.png", baseline=base)
        plot_improvement_violin(df, out / "improvement_violin.png", baseline=base)
        if (df["tau"] > 0).any():
            plot_tau_curves(df[df["tau"] > 0], out / "tau_curves.png")
    print(f"wrote plots to {out}")


def build_parser():
    p = argparse.ArgumentParser(prog="sparta_tpu.tools", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("analyze", help="score a grouping (Matrix_Analysis)")
    a.add_argument("matrix")
    a.add_argument("block_size", type=int)
    a.add_argument("grouping", nargs="?", default=None)
    a.add_argument("--symmetric", action="store_true")
    a.add_argument("--csv", default=None,
                   help="append a schema row for the comparison layer")
    a.add_argument("--exp-name", default=None, dest="exp_name")
    a.set_defaults(fn=cmd_analyze)

    cp = sub.add_parser(
        "compare",
        help="method comparison: original vs similarity vs external "
        "orderings (the CLUBS workflow)")
    cp.add_argument("matrices", nargs="+")
    cp.add_argument("--block-sizes", default="64,128")
    cp.add_argument("--taus", default="0.5,0.2,0.1,0.05,0.01")
    cp.add_argument("--methods",
                    default="original,similarity,degree,rcm,scramble")
    cp.add_argument("--metric", default="VBR_nzcount")
    cp.add_argument("--out-dir", default="results/compare")
    cp.set_defaults(fn=cmd_compare)

    r = sub.add_parser("reorder", help="tau sweep + save reordered matrix")
    r.add_argument("matrix")
    r.add_argument("--block-size", type=int, default=128)
    r.add_argument("--taus", default="0.9,0.7,0.5,0.3,0.2,0.1,0.05,0.01")
    r.add_argument("--variable", action="store_true")
    r.add_argument("--pattern-only", action="store_true")
    r.add_argument("--out", default=None)
    r.add_argument("--out-matrix", default=None)
    r.set_defaults(fn=cmd_reorder)

    s = sub.add_parser("similarity", help="distances on a row pair")
    s.add_argument("matrix")
    s.add_argument("row_a", type=int)
    s.add_argument("row_b", type=int)
    s.add_argument("--block-size", type=int, default=3)
    s.set_defaults(fn=cmd_similarity)

    b = sub.add_parser("blocking", help="blocking-only experiment")
    b.add_argument("matrix")
    b.add_argument("--out", default="results/blocking.csv")
    b.add_argument("--algo", type=int, default=3)
    b.add_argument("--tau", type=float, default=0.1)
    b.add_argument("--block-size", type=int, default=128)
    b.add_argument("--force-fixed", action="store_true")
    b.add_argument("--verbose", type=int, default=1)
    b.set_defaults(fn=cmd_blocking)

    w = sub.add_parser("sweep", help="grid sweep (resumable)")
    w.add_argument("spec", help="JSON: {matrices: [...], grid: {...}, base: {...}}")
    w.add_argument("--out-dir", default="results/sweep")
    w.add_argument("--no-resume", action="store_true")
    w.set_defaults(fn=cmd_sweep)

    c = sub.add_parser("collect", help="concatenate per-run CSVs")
    c.add_argument("out_dir")
    c.add_argument("dest")
    c.set_defaults(fn=cmd_collect)

    pl = sub.add_parser("plot", help="render analysis figures")
    pl.add_argument("csv")
    pl.add_argument("--out-dir", default="results/plots")
    pl.set_defaults(fn=cmd_plot)

    pn = sub.add_parser("plan", help="explain the kernel selector's choice")
    pn.add_argument("matrix")
    pn.add_argument("-c", "--b-cols", type=int, default=2048)
    pn.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16", "int8", "fp8"])
    pn.add_argument("-b", "--block", type=int, default=128)
    pn.add_argument("-t", "--tau", type=float, default=None,
                    help="reorder first (algo --algo) at this tau")
    pn.add_argument("-a", "--algo", type=int, default=3)
    pn.add_argument("--audit", action="store_true",
                    help="measure every candidate; flag a fewest-work pick "
                         ">1.5x slower (results/plan_audit_<stem>.json)")
    pn.set_defaults(fn=cmd_plan)
    return p


def main(argv=None):
    from .runtime import setup_compile_cache

    setup_compile_cache()
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
