"""BASELINE config 3 + the reference's RMAT headline: power-law graph
blocked SpMM, 128x128 tiles, one GPU.

Defaults mirror the reference's headline matrix (RMAT N13: 8192 nodes,
~664k nnz, B_cols=8192 — its BCSR took 0.541 ms vs 6.58 ms cuSPARSE-CSR on
A100, BASELINE.md). No network egress in this image, so com-Orkut-class
runs use larger --scale with a smaller --edge-factor; NOTE measured here:
raw power-law graphs at low average degree block very poorly (0.04%% block
fill at scale 17 / ef 8 — 147k blocks from 1M nnz), which is exactly why
the reference's blocked experiments use dense RMATs and SuiteSparse FEM
matrices. Pipeline: hash-greedy blocking (algo 7, scales to large n) ->
Blocked-ELL -> the blocked Triton kernel, vs unstructured CSR BCOO, dense
GEMM and the fine-grained dedup path.

Usage: python scripts/graph_bench.py [--scale 13] [--feat 8192]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=13)   # reference RMAT N13
    ap.add_argument("--edge-factor", type=int, default=81)
    ap.add_argument("--feat", type=int, default=8192)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--tau", type=float, default=0.7)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args()

    import jax

    from sparta_tpu.runtime import require_gpu, setup_compile_cache

    setup_compile_cache()
    require_gpu()
    import jax.numpy as jnp

    from sparta_tpu.bench.timing import time_op
    from sparta_tpu.definitions import BlockingType
    from sparta_tpu.formats import bell_from_csr
    from sparta_tpu.formats.csr import rmat_csr
    from sparta_tpu.ops import (
        BellDevice,
        bcoo_spmm,
        bell_spmm_triton,
        csr_to_bcoo,
    )
    from sparta_tpu.reorder import BlockingEngine

    log(f"devices: {jax.devices()}")
    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    block, N = args.block, args.feat

    t0 = time.perf_counter()
    m = rmat_csr(args.scale, edge_factor=args.edge_factor, seed=1)
    n = m.rows
    log(f"RMAT scale={args.scale}: {n} nodes, nnz={m.nnz} "
        f"({time.perf_counter()-t0:.1f}s)")

    # hash-greedy blocking (exact-signature dedup; scales to large n)
    t0 = time.perf_counter()
    eng = BlockingEngine(
        tau=args.tau, col_block_size=block, row_block_size=block,
        blocking_algo=BlockingType.hash_greedy, force_fixed_size=True,
    )
    grouping = eng.get_grouping(m)
    t_block = time.perf_counter() - t0
    bell = bell_from_csr(m, grouping, block_row_size=block)
    # natural-blocking stats straight from the pattern (materializing the
    # natural value-padded ELL of a power-law graph can need tens of GiB)
    ri = np.repeat(np.arange(m.rows), np.diff(m.indptr)) // block
    ci = m.indices // block
    nat_pairs = np.unique(ri.astype(np.int64) * ((m.cols // block) + 1) + ci)
    nat_nb = np.bincount(nat_pairs // ((m.cols // block) + 1))
    log(f"blocking: {t_block:.1f}s  nzblocks {nat_pairs.size} -> "
        f"{bell.total_nzblocks}  max_nb {int(nat_nb.max())} -> "
        f"{int(bell.nb_row.max())}")

    dev = BellDevice.from_host(bell, dtype=dtype)
    B = jnp.asarray(
        np.random.default_rng(0).standard_normal((bell.shape[1], N)),
        dtype=dtype,
    )
    flops = 2 * bell.total_nzblocks * block * block * N
    results = {"nodes": n, "nnz": m.nnz, "nzblocks": int(bell.total_nzblocks),
               "blocking_s": round(t_block, 2)}

    avg, std, _ = time_op(lambda b: bell_spmm_triton(dev, b), B, reps=3)
    log(f"blocked_triton : {avg*1e3:9.3f} ms ({flops/avg/1e12:6.2f} TF/s eff, "
        f"{m.nnz/avg/1e9:.2f} Gnnz/s, std {std*1e3:.3f})")
    results["blocked_ms"] = round(avg * 1e3, 3)
    results["blocked_gnnz_per_s"] = round(m.nnz / avg / 1e9, 3)

    # dense GEMM baseline (reference -M 1)
    A_dense = jnp.asarray(m.to_dense(), dtype=dtype)
    avg_d, std_d, _ = time_op(lambda b: A_dense @ b, B[: m.cols], reps=3)
    log(f"dense_gemm     : {avg_d*1e3:9.3f} ms (std {std_d*1e3:.3f})")
    results["dense_ms"] = round(avg_d * 1e3, 3)

    bcoo = csr_to_bcoo(m, dtype=dtype)
    avg_c, std_c, _ = time_op(lambda b: bcoo_spmm(bcoo, b), B[: m.cols],
                              reps=3)
    log(f"csr_bcoo       : {avg_c*1e3:9.3f} ms ({m.nnz/avg_c/1e9:.2f} Gnnz/s, "
        f"std {std_c*1e3:.3f})")
    results["csr_ms"] = round(avg_c * 1e3, 3)
    results["speedup_vs_csr"] = round(avg_c / avg, 2)
    del bcoo

    # fine-grained dedup path (no blocking/reordering) — the execution
    # that replaces "blocked formats lose here" for low-fill power-law
    # graphs (r3; ops/fine.py)
    try:
        from sparta_tpu.ops import DedupDevice, dedup_spmm

        ddev = DedupDevice.from_csr(m, dtype=dtype)
        avg_f, std_f, _ = time_op(lambda b: dedup_spmm(ddev, b),
                                  B[: m.cols], reps=3)
        log(f"fine_dedup     : {avg_f*1e3:9.3f} ms "
            f"({m.nnz/avg_f/1e9:.2f} Gnnz/s, std {std_f*1e3:.3f})")
        results["fine_dedup_ms"] = round(avg_f * 1e3, 3)
        results["fine_dedup_vs_csr"] = round(avg_c / avg_f, 2)
    except Exception as e:  # noqa: BLE001
        log(f"fine_dedup     : FAILED {type(e).__name__}: {str(e)[:160]}")

    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
