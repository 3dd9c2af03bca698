"""Headline benchmark: reordered blocked SpMM vs unstructured execution of
the same matrix, on one GPU.

Mirrors BASELINE config 1 ("A sparse 10k x 10k, ~1% nnz synthetic blocked
matrix, B dense n x 256, greedy reordering"): the matrix has planted
128-blocks, rows shuffled; the pipeline must (1) recover the block structure
by similarity reordering, (2) run the blocked SpMM, and beat every
UNSTRUCTURED execution of the same matrix — the scatter-CSR library path,
natural (unreordered) blocking, and densify + GEMM.  The headline is the
speedup over the best of those three; per-baseline ratios are extra fields.
Reference analog: BCSR 0.541 ms vs cuSPARSE-CSR 6.579 ms (12.2x) but vs ITS
best unstructured (dense GEMM 0.093 ms) = 0.172x (A100, BASELINE.md).

Prints ONE JSON line naming the device; the detail table goes to stderr.
Runs only on a GPU (``--quick`` also runs on the CPU, as a smoke of the
control flow that measures nothing).  Any failed leg fails the run.

    python bench.py [--quick] [--b-cols N] [--dtype bfloat16|float32]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_mini_suite(dtype, N: int, reps: int, quick: bool, peak) -> dict:
    """Two extra structure classes (fem_2d stencil, rmat power-law) and a
    banded matrix through the same reorder -> block -> SpMM pipeline, each
    scored against the csr_spmm_auto library-call baseline."""
    import jax.numpy as jnp

    from sparta_tpu.bench.tau import search_tau
    from sparta_tpu.bench.timing import time_op
    from sparta_tpu.datasets import banded_csr, stencil_csr
    from sparta_tpu.formats import bell_from_csr
    from sparta_tpu.formats.csr import rmat_csr
    from sparta_tpu.ops import csr_spmm_auto, plan_spmm

    if quick:
        mats = {"fem_2d": stencil_csr((24, 24), pattern="box", seed=5),
                "rmat": rmat_csr(9, edge_factor=4, seed=4),
                "banded": banded_csr(2048, bandwidth=64, seed=8)}
        taus = (0.3,)
    else:
        mats = {"fem_2d": stencil_csr((90, 90), pattern="box", seed=5),
                "rmat": rmat_csr(13, edge_factor=8, seed=4),
                "banded": banded_csr(8192, bandwidth=192, seed=8)}
        taus = (0.3, 0.1)
    suite = {}
    for name, m in mats.items():
        res = search_tau(m, 128, 128, taus=taus)
        bell = bell_from_csr(m, res.grouping, block_row_size=128)
        plan = plan_spmm(bell, N, dtype=dtype)
        Bs = jnp.asarray(
            np.random.default_rng(1).standard_normal((m.cols, N)), dtype=dtype)
        # plan.fn wants B padded to the bell's K grid; auto takes the
        # logical operand
        Bp = jnp.pad(Bs, ((0, bell.shape[1] - m.cols), (0, 0)))
        t_blk, _, _ = time_op(plan.fn, Bp, warmup=1, reps=reps)
        fn, picked, _fl = csr_spmm_auto(m, N, dtype=dtype)
        t_auto, _, _ = time_op(fn, Bs, warmup=1, reps=reps)
        # FLOPs actually issued by the blocked execution
        blk_tfs = 2 * bell.total_nzblocks * 128 * 128 * N / t_blk / 1e12
        row = {"rows": m.rows, "nnz": m.nnz,
               "blocked_ms": t_blk * 1e3, "blocked_backend": plan.backend,
               "blocked_tfs": blk_tfs,
               "unstructured_ms": t_auto * 1e3,
               "unstructured_backend": picked, "speedup": t_auto / t_blk}
        if peak:
            row["roofline_pct"] = 100 * blk_tfs * 1e12 / peak
        log(f"suite {name:8s}: blocked {t_blk*1e3:8.3f} ms "
            f"({plan.backend}, {blk_tfs:.1f} TF/s) vs {picked} "
            f"{t_auto*1e3:8.3f} ms -> {t_auto/t_blk:.2f}x")
        suite[name] = row
    return suite


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="small shapes (smoke)")
    ap.add_argument("--b-cols", type=int, default=0)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--no-suite", action="store_true",
                    help="skip the fem_2d/rmat/banded suite rows")
    args = ap.parse_args()

    from sparta_tpu.runtime import device_info, require_gpu, setup_compile_cache

    setup_compile_cache()
    import jax
    import jax.numpy as jnp

    device = device_info()
    log(f"device: {device}")
    peak = None
    if not args.quick or device["platform"] == "gpu":
        require_gpu()
        from sparta_tpu.bench.peaks import peak_flops

        peak = peak_flops(device["kind"], args.dtype)

    from sparta_tpu.bench.timing import time_op
    from sparta_tpu.formats import bell_from_csr, random_block_csr
    from sparta_tpu.ops import (
        BellDevice,
        QBellDevice,
        bcoo_spmm,
        bell_spmm_quant,
        bell_spmm_triton,
        bell_spmm_xla,
        csr_to_bcoo,
        dense_matmul,
        plan_spmm,
        quantize_b_cols,
        quantize_b_global_cols,
        spmm_route,
    )
    from sparta_tpu.ops.quant import int32_overflow_possible

    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    if args.quick:
        n, block, bdens, intra, N = 2048, 128, 0.05, 0.35, 512
        reps = 2
    else:
        n, block, bdens, intra, N = 10240, 128, 0.08, 0.13, args.b_cols or 2048
        reps = 5

    t0 = time.perf_counter()
    m = random_block_csr(n, n, block=block, block_density=bdens,
                         intra_density=intra, seed=7)
    log(f"matrix: {n}x{n} nnz={m.nnz} density={m.nnz/n/n:.4f} "
        f"({time.perf_counter()-t0:.1f}s)")

    # ---- reorder: greedy similarity blocking with tau search (the
    # reference's reorder_matrix flow) ----
    from sparta_tpu.bench.tau import search_tau

    t0 = time.perf_counter()
    taus = (0.3, 0.1) if args.quick else (0.5, 0.3, 0.1, 0.05)
    res = search_tau(m, block, block, taus=taus)
    t_block = time.perf_counter() - t0
    log(f"blocking: {t_block:.2f}s  tau*={res.best_tau}  nzblocks "
        f"{res.natural_nzblocks} -> {res.nzblocks} "
        f"({res.natural_nzblocks/max(res.nzblocks,1):.2f}x fewer)")

    bell = bell_from_csr(m, res.grouping, block_row_size=block)
    dev = BellDevice.from_host(bell, dtype=dtype)
    B = jnp.asarray(
        np.random.default_rng(0).standard_normal((bell.shape[1], N)),
        dtype=dtype)
    flops = 2 * bell.total_nzblocks * block * block * N
    results = {}

    def bench(name, fn, Bx, fl):
        avg, std, _ = time_op(fn, Bx, warmup=1, reps=reps)
        results[name] = avg
        log(f"{name:16s}: {avg*1e3:9.3f} ms  ({fl/avg/1e12:6.2f} "
            f"TFLOP/s eff, std {std*1e3:.3f})")
        return avg

    bench("bell_xla", lambda b: bell_spmm_xla(dev, b), B, flops)
    if spmm_route(block, block) == "triton":
        bench("bell_triton", lambda b: bell_spmm_triton(dev, b), B, flops)
    plan = plan_spmm(bell, N, dtype=dtype)
    log(f"plan_spmm picks {plan.backend}")

    # quantized legs (8-bit tensor cores): reported beside the bf16
    # headline when their end-to-end error vs the fp32 oracle on the same
    # structure meets the matched-accuracy gate (<= 1e-2 relative)
    devf = BellDevice.from_host(bell, dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(bell_spmm_xla(devf, B.astype(jnp.float32)))
    del devf
    refmax = np.abs(ref).max() + 1e-9
    quant = {}
    for qname, qdtype, per_col in (("int8_global", jnp.int8, True),
                                   ("int8_rowcol", jnp.int8, False),
                                   ("fp8_rowcol", jnp.float8_e4m3fn, False)):
        qdev = QBellDevice.from_bell(bell, dtype=qdtype)
        if per_col and int32_overflow_possible(qdev):
            log(f"{qname:16s}: skipped (int32 accumulator may overflow)")
            continue
        if per_col:
            Bq, bs = quantize_b_global_cols(B, dtype=qdtype)
        else:
            Bq, bs = quantize_b_cols(B, block, dtype=qdtype)
        fn = lambda b, qdev=qdev, bs=bs: bell_spmm_quant(qdev, b, bs)  # noqa: E731
        err = float(np.abs(np.asarray(fn(Bq), np.float32) - ref).max()
                    / refmax)
        avg = bench(qname, fn, Bq, flops)
        gate = "PASS" if err <= 1e-2 else "FAIL"
        log(f"{'':16s}  rel_err {err:.3e} [accuracy gate {gate}]")
        quant[qname] = {"ms": avg * 1e3, "rel_err": err, "gate": gate}

    # --- unstructured baselines (no reordering) ---
    bcoo = csr_to_bcoo(m, dtype=dtype)
    Bc = B[: m.cols]
    bench("csr_bcoo", lambda b: bcoo_spmm(bcoo, b), Bc, 2 * m.nnz * N)
    nat_bell = bell_from_csr(m, None, block_row_size=block)
    nat_flops = 2 * nat_bell.total_nzblocks * block * block * N
    nat_plan = plan_spmm(nat_bell, N, dtype=dtype)
    bench("natural_blocked", nat_plan.fn, B, nat_flops)
    A = jnp.asarray(m.to_dense(), dtype=dtype)
    bench("dense", lambda b: dense_matmul(A, b), Bc, 2 * m.rows * m.cols * N)
    del A

    blocked_name = min((k for k in results if k.startswith("bell")),
                       key=results.get)
    blocked = results[blocked_name]
    unstructured = {k: results[k]
                    for k in ("csr_bcoo", "natural_blocked", "dense")}
    best_name = min(unstructured, key=unstructured.get)
    speedup = unstructured[best_name] / blocked
    out = {
        "metric": "reordered_blocked_spmm_speedup_vs_best_unstructured",
        "value": speedup,
        "unit": "x",
        "vs_baseline": speedup / 0.172,
        "device": device,
        "dtype": args.dtype,
        "b_cols": N,
        "blocked_backend": blocked_name,
        "blocked_ms": blocked * 1e3,
        "plan_backend": plan.backend,
        "natural_plan_backend": nat_plan.backend,
        "best_unstructured": best_name,
        "host_reorder_s": t_block,
        "legs_ms": {k: v * 1e3 for k, v in results.items()},
        "quantized": quant,
    }
    if peak:
        out["blocked_roofline_pct"] = 100 * flops / blocked / peak
    for k, v in unstructured.items():
        out[f"vs_{k}"] = v / blocked
    if not args.no_suite:
        out["suite"] = run_mini_suite(dtype, N, reps, args.quick, peak)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
