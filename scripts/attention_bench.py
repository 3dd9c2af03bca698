"""Block-sparse vs dense attention on real hardware (serving shapes).

Measures ops/attention.py at long-context shapes where the block pattern
pays: dense attention is O(T^2) in both FLOPs and the [H, T, T] score
tensor; the local-window pattern is O(window * T).  Reports ms and the
speedup at each T, plus a correctness check vs the dense-masked oracle
at the smallest shape.

Writes results/attention_bench.json.
Usage: python scripts/attention_bench.py [--quick]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sparta_tpu.bench.results import write_result  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="results/attention_bench.json")
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--dhead", type=int, default=64)
    ap.add_argument("--window", type=int, default=4)
    args = ap.parse_args()

    import jax

    from sparta_tpu.runtime import require_gpu, setup_compile_cache

    setup_compile_cache()
    require_gpu()
    import jax.numpy as jnp

    from sparta_tpu.bench.timing import time_op
    from sparta_tpu.ops.attention import (
        block_sparse_attention,
        build_block_mask,
        dense_mask_from_block_mask,
    )

    log(f"devices: {jax.devices()}")
    H, D, W = args.heads, args.dhead, args.window
    Ts = (512,) if args.quick else (2048, 4096, 8192)
    rng = np.random.default_rng(0)
    out = {"heads": H, "d_head": D, "window": W, "dtype": "bfloat16"}

    @jax.jit
    def dense_attn(q, k, v):
        s = jnp.einsum("htd,hsd->hts", q, k,
                       preferred_element_type=jnp.float32) / np.sqrt(D)
        T = q.shape[1]
        tri = jnp.tril(jnp.ones((T, T), dtype=bool))
        s = jnp.where(tri, s, -jnp.inf)
        p = jax.nn.softmax(s, axis=-1).astype(v.dtype)
        return jnp.einsum("hts,hsd->htd", p, v,
                          preferred_element_type=jnp.float32).astype(q.dtype)

    # correctness at the smallest shape (fp32, vs the dense-masked oracle)
    T0 = 512
    mask0 = build_block_mask(T0, T0, 128, window=W, causal=True,
                             global_blocks=1)
    q0, k0, v0 = (rng.standard_normal((2, T0, D)).astype(np.float32)
                  for _ in range(3))
    got = np.asarray(block_sparse_attention(
        jnp.asarray(q0), jnp.asarray(k0), jnp.asarray(v0), mask0))
    mb = dense_mask_from_block_mask(mask0)
    s = (q0 @ k0.swapaxes(-1, -2)) / np.sqrt(D)
    s = np.where(mb, s, -np.inf)
    s -= s.max(-1, keepdims=True)
    p = np.exp(s)
    ref = (p / p.sum(-1, keepdims=True)) @ v0
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
    assert err < 5e-3, f"correctness {err:.2e}"
    log(f"correctness vs oracle at T={T0}: rel_err {err:.2e}")

    for T in Ts:
        mask = build_block_mask(T, T, 128, window=W, causal=True,
                                global_blocks=1)
        q, k, v = (jnp.asarray(rng.standard_normal((H, T, D)),
                               dtype=jnp.bfloat16) for _ in range(3))
        row = {"n_blocks": mask.n_blocks, "density": round(mask.density, 4)}
        # sparse flops: SDD + PV over the block list
        fl_sp = 2 * 2 * H * mask.n_blocks * 128 * 128 * D
        fl_d = 2 * 2 * H * T * T * D

        def cell(tag, fn, fl):
            try:
                avg, std, _ = time_op(fn, q, reps=3)
                log(f"T={T} {tag:7}: {avg*1e3:8.3f} ms "
                    f"({fl/avg/1e12:6.2f} TF/s, std {std*1e3:.3f})")
                row[tag] = {"ms": round(avg * 1e3, 3),
                            "tflops": round(fl / avg / 1e12, 2)}
                return avg
            except Exception as e:  # noqa: BLE001
                log(f"T={T} {tag:7}: FAILED {type(e).__name__}: "
                    f"{str(e)[:160]}")
                row[tag] = {"error": str(e)[:160]}
                return None

        t_sp = cell("sparse_xla", lambda x: block_sparse_attention(
            x, k, v, mask), fl_sp)
        t_d = cell("dense", lambda x: dense_attn(x, k, v), fl_d) \
            if T <= 4096 else None

        # backward at train shapes
        def g(fn):
            gr = jax.jit(jax.grad(
                lambda x, kk, vv: fn(x, kk, vv).astype(jnp.float32).sum(),
                argnums=(0, 1, 2)))
            return lambda x: gr(x, k, v)[0]

        cell("grad_sparse_xla", g(lambda x, kk, vv: block_sparse_attention(
            x, kk, vv, mask)), 3 * fl_sp)
        if T <= 4096:
            cell("grad_dense", g(dense_attn), 3 * fl_d)
        if t_sp and t_d:
            row["speedup"] = round(t_d / t_sp, 2)
            log(f"T={T} speedup (sparse vs dense): {row['speedup']}x")
        out[f"T{T}"] = row
        write_result(args.out, out, quick=args.quick, hw_only=True)

    print(json.dumps(out))


if __name__ == "__main__":
    main()


