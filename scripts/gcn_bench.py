"""GCN training/inference bench on a large FEM-mesh graph (one chip).

The model-family counterpart of graph_bench: a 3-D stencil mesh (the
SuiteSparse-FEM structure class), relabeled once by similarity reordering,
adjacency in Blocked-ELL, every layer's aggregation on the bell SpMM
(custom VJP: Triton-kernel forward on the GPU, XLA backward).

Usage: python scripts/gcn_bench.py [--grid 32] [--feat 256]
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
    ap.add_argument("--grid", type=int, default=32)   # 32^3 = 32768 nodes
    ap.add_argument("--feat", type=int, default=256)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--block", type=int, default=128)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import optax

    from sparta_tpu.runtime import require_gpu, setup_compile_cache

    setup_compile_cache()
    require_gpu()
    from sparta_tpu.bench.timing import time_op
    from sparta_tpu.datasets import stencil_csr
    from sparta_tpu.models import GCN, GCNConfig, make_gcn_train_step

    log(f"devices: {jax.devices()}")
    t0 = time.time()
    adj = stencil_csr((args.grid,) * 3, pattern="box", seed=0)
    n = adj.rows
    log(f"mesh graph: {n} nodes, nnz={adj.nnz} ({time.time()-t0:.1f}s)")

    cfg = GCNConfig(in_dim=args.feat, hidden_dim=args.hidden,
                    out_dim=args.classes, n_layers=2, block=args.block,
                    tau=0.2, dtype="bfloat16")
    t0 = time.time()
    model = GCN.create(adj, cfg)
    t_create = time.time() - t0
    nbr, max_nb, bh, bw = model.adj_vals.shape
    log(f"GCN.create: {t_create:.1f}s  adjacency blocks: {nbr} rows x "
        f"max {max_nb} (avg {float(np.asarray(model.nb_row).mean()):.1f})")

    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((n, args.feat)), dtype=jnp.float32)
    labels = jnp.asarray(rng.integers(0, args.classes, n))
    mask = jnp.ones(n, dtype=jnp.float32)

    t_f, _, _ = time_op(lambda x: model.apply(params, x), X, reps=3)
    log(f"forward: {t_f*1e3:.1f} ms ({n/t_f/1e6:.2f} Mnodes/s)")

    opt = optax.adam(1e-3)
    step = make_gcn_train_step(model, opt)
    opt_state = opt.init(params)
    step(params, opt_state, X, labels, mask)  # compile
    t0 = time.perf_counter()
    p, o = params, opt_state
    for _ in range(10):
        p, o, loss = step(p, o, X, labels, mask)
    loss = float(loss)  # waits for the last step
    t_s = (time.perf_counter() - t0) / 10
    log(f"train step: {t_s*1e3:.1f} ms  loss={loss:.4f}")

    print(json.dumps({
        "nodes": n, "nnz": adj.nnz, "adj_blocks": int(np.asarray(model.nb_row).sum()),
        "create_s": round(t_create, 2), "fwd_ms": round(t_f * 1e3, 2),
        "train_step_ms": round(t_s * 1e3, 2), "loss": round(loss, 4),
    }), flush=True)


if __name__ == "__main__":
    main()
