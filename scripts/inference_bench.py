"""BASELINE config 4: pruned BERT-style 4096x4096 block-sparse weight
matrices, 80-95% sparse, SpMM batch inference on one chip.

A dense weight is pruned to block-sparse by block Frobenius norm
(BlockSparseLinear.from_dense), then y = x @ W^T runs on the blocked
kernel; compared against the dense GEMM at each sparsity, and against
running the same pruned weights as unstructured CSR.

Usage: python scripts/inference_bench.py [--dim 4096] [--batch 1024]
Prints one detail line per (sparsity, path) to stderr and a JSON summary
line to stdout.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args()

    import jax

    from sparta_tpu.runtime import require_gpu, setup_compile_cache

    setup_compile_cache()
    require_gpu()
    import jax.numpy as jnp

    from sparta_tpu.bench.timing import time_op
    from sparta_tpu.models.layers import BlockSparseLinear
    from sparta_tpu.ops import bcoo_spmm

    from jax.experimental.sparse import BCOO

    log(f"devices: {jax.devices()}")
    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    d, batch, block = args.dim, args.batch, args.block
    rng = np.random.default_rng(0)
    W = rng.standard_normal((d, d)).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((batch, d)), dtype=dtype)

    dense_flops = 2 * d * d * batch

    def bench(name, fn, arg, fl):
        avg, std, _ = time_op(fn, arg, warmup=1, reps=3)
        log(f"{name:28s}: {avg*1e3:8.3f} ms  {fl/avg/1e12:7.2f} TFLOP/s eff  "
            f"(std {std*1e3:.3f})")
        return avg

    t_dense = bench(
        "dense matmul",
        lambda v: (v @ jnp.asarray(W.T, dtype=dtype)),
        x, dense_flops,
    )

    results = {"dense_ms": round(t_dense * 1e3, 4)}
    for sparsity in (0.80, 0.90, 0.95):
        layer, params = BlockSparseLinear.from_dense(
            W, block=block, block_density=1 - sparsity)
        params = {k: v.astype(dtype) for k, v in params.items()}
        eff_flops = 2 * layer.cols_idx.shape[0] * layer.max_nb * block * block * batch
        t_bs = bench(
            f"block-sparse {sparsity:.0%}",
            lambda v, L=layer, p=params: L.apply(p, v),
            x, eff_flops,
        )
        frozen = layer.freeze(params, batch_hint=batch, dtype=dtype)
        t_fz = bench(f"frozen       {sparsity:.0%}", frozen, x, eff_flops)
        t_bs = min(t_bs, t_fz)

        # same pruned weights as unstructured CSR (the "don't exploit
        # block structure" baseline)
        nbr = layer.cols_idx.shape[0]
        Wp = np.zeros((d, d), dtype=np.float32)
        cols = np.asarray(layer.cols_idx)
        vals = np.asarray(params["vals"], dtype=np.float32)
        for r in range(nbr):
            for t in range(int(layer.nb_row[r])):
                jb = int(cols[r, t])
                Wp[r*block:(r+1)*block, jb*block:(jb+1)*block] = vals[r, t]
        import scipy.sparse as sp
        S = sp.csr_matrix(Wp)
        bcoo = BCOO.from_scipy_sparse(S.tocoo()).update_layout(n_batch=0)
        bcoo = BCOO((bcoo.data.astype(dtype), bcoo.indices), shape=bcoo.shape)
        t_csr = bench(
            f"csr (unstructured) {sparsity:.0%}",
            lambda v, b=bcoo: bcoo_spmm(b, v.T).T,
            x, 2 * S.nnz * batch,
        )
        results[f"bs_{int(sparsity*100)}_ms"] = round(t_bs * 1e3, 4)
        results[f"csr_{int(sparsity*100)}_ms"] = round(t_csr * 1e3, 4)
        results[f"speedup_vs_dense_{int(sparsity*100)}"] = round(t_dense / t_bs, 2)
        results[f"speedup_vs_csr_{int(sparsity*100)}"] = round(t_csr / t_bs, 2)

    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
