"""Experiment runner: read -> (reorder) -> block -> SpMM -> CSV.

The counterpart of the reference's main harness (test/cuda/cuda_multiply.cpp):
one process = one experiment config, emitting a 2-line CSV (header + values)
with the reference's exact 31-column schema (src/general/utilities.cpp:175-245)
plus this framework's extras appended, so the reference's collation/plotting
layer applies unchanged.
"""
from __future__ import annotations

import functools
import os
import time
from pathlib import Path

import numpy as np

from ..definitions import MultiplicationAlgo, round_up
from ..formats import bell_from_csr, read_matrix, write_grouping
from ..formats.csr import CSR
from ..reorder import BlockingEngine
from ..utils import get_fixed_size_grouping
from .timing import time_op

# columns in the reference's exact order (utilities.cpp:186-231)
REFERENCE_COLUMNS = [
    "matrix", "rows", "cols", "nonzeros", "symmetrize",
    "blocking_algo", "tau", "row_block_size", "col_block_size",
    "use_pattern", "sim_use_groups", "sim_measure", "reorder", "exp_name",
    "b_cols", "warmup", "exp_repetitions", "multiplication_algo", "n_streams",
    "time_to_block", "time_to_merge", "time_to_compare",
    "VBR_nzcount", "VBR_nzblocks_count", "VBR_average_height", "VBR_longest_row",
    "merge_counter", "comparison_counter", "average_merge_tau", "average_row_distance",
    "avg_time_multiply", "std_time_multiply",
]
# append-only: consumers key by name (see CLAUDE.md invariants)
EXTRA_COLUMNS = ["backend", "dtype", "gflops", "nnz_per_s",
                 "effective_tflops", "rel_err", "counter_domain",
                 "csr_impl", "tile_n", "inner_iters", "autotune"]

BELL_ALGOS = {
    MultiplicationAlgo.bell_xla,
    MultiplicationAlgo.bell_pallas,
    MultiplicationAlgo.bell_pallas_batched,
}
BLOCKED_ALGOS = BELL_ALGOS | {
    MultiplicationAlgo.no_mult,
    MultiplicationAlgo.vbr_xla,
    MultiplicationAlgo.vbr_xla_fixed,
    MultiplicationAlgo.vbr_xla_inverted,
    MultiplicationAlgo.vbr_xla_batched,
    MultiplicationAlgo.vbr_pallas,
    MultiplicationAlgo.vbr_pallas_inverted,
}


def load_matrix(cfg) -> CSR:
    m = read_matrix(
        cfg.filename,
        fmt=cfg.mat_fmt,
        pattern_only=bool(cfg.pattern_only),
        symmetrize=bool(cfg.symmetrize),
    )
    # pre-reorder pass (-r; reference matrices.h:70-81)
    if cfg.reorder == 1:
        m = m.reorder_by_degree(descending=True)
    elif cfg.reorder == -1:
        m = m.reorder_by_degree(descending=False)
    elif cfg.reorder == 2:
        m = m.scramble(seed=cfg.seed)
    return m


def make_backend(cfg, m: CSR, engine: BlockingEngine):
    """Returns (fn(B)->C, B_shape, backend_name, flops_per_call)."""
    import jax.numpy as jnp

    from ..ops import (
        BellDevice,
        bcoo_spmm,
        bell_spmm_xla,
        bell_spmm_xla_ba,
        bell_spmm_xla_unrolled,
        csr_to_bcoo,
        dense_matmul,
    )

    algo = MultiplicationAlgo(cfg.multiplication_algo)
    # int8/fp8 run the quantized blocked path for -M 8; other backends use
    # bf16 storage for them (the reference's Z_/Q_ type-switch analog)
    dtype = jnp.bfloat16 if cfg.dtype in ("bfloat16", "int8", "fp8") \
        else jnp.float32
    N = cfg.b_cols

    autotune = True if getattr(cfg, "autotune", False) else None

    if algo in (MultiplicationAlgo.dense_xla, MultiplicationAlgo.dense_pallas):
        # -M 9 (the former hand-written dense kernel) is the same GEMM:
        # XLA hands it to cuBLAS on the GPU
        A = jnp.asarray(m.to_dense(), dtype=dtype)
        return (lambda B: dense_matmul(A, B)), (m.cols, N), "dense_xla", 2 * m.rows * m.cols * N

    if algo == MultiplicationAlgo.csr_spmm:
        impl = getattr(cfg, "csr_impl", "auto")
        if impl == "bcoo":
            A = csr_to_bcoo(m, dtype=dtype)
            return (lambda B: bcoo_spmm(A, B)), (m.cols, N), "csr_bcoo", 2 * m.nnz * N
        if impl in ("fine", "dedup", "dedup256", "fell"):
            from ..ops import fine as _fine

            Np = round_up(N, 128)
            # --dtype int8 on the fine family = int8-GATHERED B (the
            # gather is the dominant cost there); fell has no int8 leg
            q = cfg.dtype == "int8" and impl != "fell"
            if impl == "fell":
                fdev = _fine.FellDevice.from_csr(m, dtype=dtype)
                run = _fine.fell_spmm
            elif impl in ("dedup", "dedup256"):
                fdev = _fine.DedupDevice.from_csr(
                    m, dtype=dtype,
                    tile_rows=256 if impl == "dedup256" else 128)
                run = functools.partial(_fine.dedup_spmm, b_int8=q)
            else:
                fdev = _fine.FineDevice.from_csr(m, dtype=dtype)
                run = functools.partial(_fine.fine_spmm, b_int8=q)
            return ((lambda B: run(fdev, B)), (m.cols, Np),
                    f"csr_{impl}" + ("_int8" if q else ""), 2 * m.nnz * Np)
        from ..ops.csr_spmm import csr_spmm_auto

        fn, name, flops = csr_spmm_auto(m, N, dtype=dtype, autotune=autotune)
        # every csr_spmm_auto leg takes the logical [K, N] operand
        return fn, (m.cols, N), name, flops

    grouping = engine.grouping_result
    vbr_family = {
        MultiplicationAlgo.vbr_xla, MultiplicationAlgo.vbr_xla_fixed,
        MultiplicationAlgo.vbr_xla_inverted, MultiplicationAlgo.vbr_xla_batched,
        MultiplicationAlgo.vbr_pallas, MultiplicationAlgo.vbr_pallas_inverted,
    }

    # variable-height VBR path: vbr-family algos without forced fixed blocks
    # (the bucketed device layout keeps the reference's -M 4/6 semantics)
    if algo in vbr_family and not cfg.force_fixed_size and grouping is not None:
        from ..formats import vbr_from_csr
        from ..ops import VbrDevice, vbr_spmm_xla, vbr_spmm_xla_ba

        vbr = vbr_from_csr(m, grouping, col_block_size=cfg.col_block_size)
        flops = 2 * int((np.diff(vbr.block_ptr)).sum()) * N
        K = vbr.block_cols * vbr.block_col_size
        # blocked-kernel path for -M 10: height-bucketed products
        # (vbr_pallas.py). The inverted product stays on the XLA path —
        # transposing a row-grouped VBR yields variable block WIDTHS, which
        # no kernel layout here supports.
        if algo == MultiplicationAlgo.vbr_pallas:
            from ..ops import vbr_kernel_device, vbr_spmm_pallas

            pdev = vbr_kernel_device(vbr, dtype=dtype)
            return (lambda B: vbr_spmm_pallas(pdev, B), (K, N),
                    "vbr_pallas_bucketed", flops)
        # -M 11 without -F: variable-height inverted product.  Any direct
        # VBR layout would contract over the VARIABLE dimension (group
        # heights), so instead we permute rows by the variable grouping and
        # RE-TILE the transpose on the fixed 128 grid, then run the forward
        # blocked product: C = (A^T B^T)^T.  Numerically
        # identical (padding blocks are zero); the variable grouping still
        # determines the permutation and the reported VBR stats.
        # Reference analog: cublas_blockmat_multiplyBA's rectangular path
        # (cuda_utilities.cpp:553-721).
        if algo == MultiplicationAlgo.vbr_pallas_inverted and N % 128 == 0:
            from ..formats.csr import CSR as _CSR
            from ..ops import plan_spmm
            from ..utils import get_permutation

            m_r = m.permute_rows(get_permutation(grouping))
            mt = _CSR.from_scipy(m_r.to_scipy().T.tocsr())
            bell_t = bell_from_csr(mt, None, block_row_size=128,
                                   block_col_size=128)
            plan = plan_spmm(bell_t, N, dtype=dtype, autotune=autotune)
            return (
                lambda B: plan(B.T).T,
                (N, bell_t.shape[1]),
                f"vbr_var_ba_retiled_{plan.backend}",
                flops,
            )
        vdev = VbrDevice.from_host(vbr, dtype=dtype)
        if algo in (MultiplicationAlgo.vbr_xla_inverted,
                    MultiplicationAlgo.vbr_pallas_inverted):
            return (
                lambda B: vbr_spmm_xla_ba(vdev, B),
                (N, vbr.shape[0]),
                "vbr_xla_ba",
                flops,
            )
        return (lambda B: vbr_spmm_xla(vdev, B)), (K, N), "vbr_xla_bucketed", flops

    # fixed-size blocked paths (the reference forces square fixed blocks for
    # every bellpack/BCSR experiment, cuda_multiply.cpp:51-62)
    bell = bell_from_csr(
        m,
        None if grouping is None else get_fixed_size_grouping(grouping, cfg.row_block_size),
        block_row_size=cfg.row_block_size,
        block_col_size=cfg.col_block_size,
    )
    dev = BellDevice.from_host(bell, dtype=dtype)
    flops = 2 * bell.total_nzblocks * bell.block_row_size * bell.block_col_size * N

    if algo in (MultiplicationAlgo.bell_xla, MultiplicationAlgo.vbr_xla,
                MultiplicationAlgo.vbr_xla_fixed):
        return (lambda B: bell_spmm_xla(dev, B)), (bell.shape[1], N), "bell_xla", flops

    if algo in (MultiplicationAlgo.vbr_xla_inverted, MultiplicationAlgo.vbr_pallas_inverted):
        # inverted product: the reference computes C = B*A directly (one
        # GemmEx per block, stream per block-column,
        # cuda_utilities.cpp:553-721) because CUDA stream write-ordering
        # made that layout natural. Here (A^T B^T)^T runs through the
        # forward blocked product instead — same result.
        if N % 128 == 0:
            from ..formats.csr import CSR as _CSR
            from ..ops import plan_spmm
            from ..utils import get_permutation

            m_r = m if grouping is None else m.permute_rows(
                get_permutation(get_fixed_size_grouping(grouping, cfg.row_block_size)))
            mt = _CSR.from_scipy(m_r.to_scipy().T.tocsr())
            bell_t = bell_from_csr(mt, None,
                                   block_row_size=cfg.col_block_size,
                                   block_col_size=cfg.row_block_size)
            plan = plan_spmm(bell_t, N, dtype=dtype, autotune=autotune)
            return (
                lambda B: plan(B.T).T,
                (N, bell_t.shape[1]),
                f"ba_transposed_{plan.backend}",
                flops,
            )
        nbc = bell.n_block_cols
        return (
            lambda B: bell_spmm_xla_ba(dev, B, n_block_cols=nbc),
            (N, bell.shape[0]),
            "bell_xla_ba",
            flops,
        )

    if algo == MultiplicationAlgo.vbr_xla_batched:
        return (
            lambda B: bell_spmm_xla_unrolled(dev, B),
            (bell.shape[1], N),
            "bell_xla_unrolled",
            flops,
        )

    if algo in (MultiplicationAlgo.bell_pallas,
                MultiplicationAlgo.bell_pallas_batched,
                MultiplicationAlgo.vbr_pallas):
        # fixed-size -M 10 gets the same blocked family as -M 8
        # (matches the CUTLASS-VBR analog documented in PARITY.md)
        Np = round_up(N, 128)
        fl = 2 * bell.total_nzblocks * bell.block_row_size * bell.block_col_size * Np

        if cfg.dtype in ("int8", "fp8"):
            # quantized blocked product: per-row A scales, per-(stripe,
            # column) B scales (ops/quant.py)
            from ..ops import QBellDevice, bell_spmm_quant, quantize_b_cols

            qdtype = jnp.int8 if cfg.dtype == "int8" else jnp.float8_e4m3fn
            dev_q = QBellDevice.from_bell(bell, dtype=qdtype)
            bw = bell.block_col_size

            def fnq(B, dev_q=dev_q, bw=bw, qdtype=qdtype):
                Bq, bscale = quantize_b_cols(B, bw, dtype=qdtype)
                return bell_spmm_quant(dev_q, Bq, bscale)

            return fnq, (bell.shape[1], Np), f"bell_{cfg.dtype}_rowcol", fl

        from ..ops import plan_spmm

        plan = plan_spmm(bell, Np, dtype=dtype, autotune=autotune)
        return plan.fn, (bell.shape[1], Np), plan.backend, fl

    raise ValueError(f"no backend for multiplication algo {algo}")


def run_experiment(cfg) -> dict:
    import jax.numpy as jnp

    m = load_matrix(cfg)
    engine = BlockingEngine.from_config(cfg)
    engine.backend = getattr(cfg, "backend", "auto")

    algo = MultiplicationAlgo(cfg.multiplication_algo)
    run_blocking = algo in BLOCKED_ALGOS or algo == MultiplicationAlgo.no_mult
    if run_blocking:
        engine.get_grouping(m)
        engine.collect_blocking_info(m)

    row: dict = {}
    avg = std = 0.0
    backend_name = "none"
    flops = 0
    if algo != MultiplicationAlgo.no_mult:
        fn, b_shape, backend_name, flops = make_backend(cfg, m, engine)
        # must mirror make_backend's dtype rule (quantized structures are
        # built around a bf16 B before quantization)
        dtype = jnp.bfloat16 if cfg.dtype in ("bfloat16", "int8", "fp8") \
            else jnp.float32
        rng = np.random.default_rng(cfg.seed)
        B = jnp.asarray(rng.standard_normal(b_shape).astype(np.float32), dtype=dtype)
        avg, std, _ = time_op(
            fn, B, warmup=cfg.warmup, reps=cfg.exp_repetitions,
            inner_iters=getattr(cfg, "inner_iters", 10),
        )
        engine.multiplication_timer_avg = avg * 1e3  # ms, schema parity
        engine.multiplication_timer_std = std * 1e3

    row.update(
        matrix=cfg.filename,
        rows=m.rows, cols=m.cols, nonzeros=m.nnz,
        symmetrize=int(cfg.symmetrize),
        blocking_algo=cfg.blocking_algo, tau=cfg.tau,
        row_block_size=cfg.row_block_size, col_block_size=cfg.col_block_size,
        use_pattern=int(cfg.sim_use_pattern), sim_use_groups=int(cfg.sim_use_groups),
        sim_measure=cfg.sim_measure, reorder=cfg.reorder, exp_name=cfg.exp_name,
        b_cols=cfg.b_cols, warmup=cfg.warmup, exp_repetitions=cfg.exp_repetitions,
        multiplication_algo=cfg.multiplication_algo, n_streams=cfg.n_streams,
        time_to_block=engine.timer_total, time_to_merge=engine.timer_merges,
        time_to_compare=engine.timer_comparisons,
        VBR_nzcount=engine.VBR_nzcount, VBR_nzblocks_count=engine.VBR_nzblocks_count,
        VBR_average_height=engine.VBR_average_height,
        VBR_longest_row=engine.VBR_longest_row,
        merge_counter=engine.merge_counter, comparison_counter=engine.comparison_counter,
        average_merge_tau=engine.average_merge_tau,
        average_row_distance=engine.average_row_distance,
        avg_time_multiply=engine.multiplication_timer_avg,
        std_time_multiply=engine.multiplication_timer_std,
    )
    # extras (reference derived-metric definitions, multiplication_barplots.py:515)
    row["backend"] = backend_name
    row["dtype"] = cfg.dtype
    # late-added knobs stamped so sweep-cell adoption can tell apart cells
    # that differ only in these (sweep._LATE_IDENTITY)
    row["csr_impl"] = getattr(cfg, "csr_impl", "auto")
    row["tile_n"] = int(getattr(cfg, "tile_n", 0))
    row["inner_iters"] = int(getattr(cfg, "inner_iters", 0))
    row["autotune"] = int(bool(getattr(cfg, "autotune", False)))
    # hash_greedy (extension algo 7) counts comparisons/merges on its
    # dedup-reduced problem, so its counter columns are NOT comparable
    # with algos 0-5's full-domain counts; flag the domain per row
    row["counter_domain"] = (
        "dedup" if int(cfg.blocking_algo) == 7 else "full")
    row["gflops"] = (
        cfg.b_cols * engine.VBR_nzcount / (row["avg_time_multiply"] * 1e9)
        if row["avg_time_multiply"] else 0.0
    )
    row["nnz_per_s"] = m.nnz / avg if avg else 0.0
    row["effective_tflops"] = flops / avg / 1e12 if avg else 0.0
    if (cfg.dtype in ("int8", "fp8") and avg
            and getattr(cfg, "measure_accuracy", True)):
        # end-to-end quantized error (A blocks + B both quantized) vs the
        # fp32 oracle on the SAME backend/structure/row order — the
        # matched-accuracy evidence the quantized CSV rows carry
        # (reference type-switch family, cuda_utilities.cpp:24-32)
        import dataclasses as _dc
        import re as _re

        cfg32 = _dc.replace(cfg, dtype="float32", outfile="")
        # csr_spmm_auto's choice may depend on the dtype, so the fp32
        # rebuild could pick a DIFFERENT family with a different B layout;
        # pin the family the quantized run resolved to
        fam = _re.search(r"csr_auto_fine\[(\w+)\]", backend_name)
        if fam:
            cfg32 = _dc.replace(cfg32, csr_impl=fam.group(1))
        fn32, shape32, _, _ = make_backend(cfg32, m, engine)
        Bq = np.asarray(B, np.float32)
        # the contraction dim (K) must not shrink: computing the fp32
        # reference on a truncated B would make rel_err silently
        # meaningless rather than erroring
        if shape32[0] < Bq.shape[0]:
            raise ValueError(
                f"rel_err oracle: fp32 backend B rows {shape32[0]} < "
                f"quantized backend B rows {Bq.shape[0]} — contraction "
                "dims must match")
        B32 = np.zeros(shape32, np.float32)
        B32[: min(shape32[0], Bq.shape[0]),
            : min(shape32[1], Bq.shape[1])] = Bq[: shape32[0], : shape32[1]]
        ref = np.asarray(fn32(jnp.asarray(B32)), np.float32)
        got = np.asarray(fn(B), np.float32)
        nr = min(got.shape[0], ref.shape[0], m.rows)
        nc = min(got.shape[1], ref.shape[1])
        row["rel_err"] = float(
            np.abs(got[:nr, :nc] - ref[:nr, :nc]).max()
            / (np.abs(ref[:nr, :nc]).max() + 1e-9))

    if cfg.outfile:
        save_csv(cfg.outfile, row)
        # machine-readable row for subprocess-isolated sweeps
        import json

        Path(str(cfg.outfile) + ".json").write_text(
            json.dumps(row, default=float))
        if run_blocking and getattr(cfg, "save_grouping", True):
            write_grouping(str(cfg.outfile) + ".g", engine.grouping_result)
    return row


def save_csv(path: str | Path, row: dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    cols = REFERENCE_COLUMNS + EXTRA_COLUMNS
    header = ",".join(cols) + ","
    values = ",".join(_fmt(row.get(c, "")) for c in cols) + ","
    path.write_text(header + "\n" + values + "\n")


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6f}"
    return str(v)
