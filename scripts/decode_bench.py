"""Serving decode throughput: tokens/s through the KV-cache decode step.

Measures the block-sparse transformer's decode_step at a serving-ish
config (dense vs local block-sparse attention), with the token loop run
as ONE lax.scan inside jit so a timing prices a whole generation, not
per-token dispatches.  Writes results/decode_bench.json.

Usage: python scripts/decode_bench.py [--quick]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="results/decode_bench.json")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--gen", type=int, default=0, help="tokens to generate")
    args = ap.parse_args()

    import jax

    from sparta_tpu.runtime import require_gpu, setup_compile_cache

    setup_compile_cache()
    require_gpu()
    import jax.numpy as jnp

    from sparta_tpu.bench.timing import time_op
    from sparta_tpu.models import BlockSparseTransformer, TransformerConfig

    log(f"devices: {jax.devices()}")
    if args.quick:
        base = TransformerConfig(
            vocab=512, d_model=256, n_heads=4, n_layers=2, d_ff=1024,
            max_seq=256, block=128, ffn_block_density=0.25, dtype="bfloat16")
        gen = args.gen or 32
    else:
        base = TransformerConfig(
            vocab=32768, d_model=1024, n_heads=16, n_layers=8, d_ff=4096,
            max_seq=2048, block=128, ffn_block_density=0.2, dtype="bfloat16")
        gen = args.gen or 256
    if gen > base.max_seq:
        log(f"--gen {gen} capped to max_seq={base.max_seq} "
            f"(the KV cache holds max_seq slots)")
        gen = base.max_seq
    out = {"batch": args.batch, "gen_tokens": gen,
           "d_model": base.d_model, "n_layers": base.n_layers,
           "max_seq": base.max_seq}

    # third cell: local attention + MoE FFN — E full-width experts, top-1
    # routed, so ACTIVE FLOPs per token match the dense-FFN local config
    # (E x the parameters); measures the routing/dispatch overhead of
    # serving a conditional-compute model
    n_exp = 4 if args.quick else 8
    modes = [
        ("dense", {}),
        ("local", {}),
        ("local_moe", {"moe_experts": n_exp, "moe_capacity": 2.0}),
    ]
    for mode, extra in modes:
        cfg = dataclasses.replace(base,
                                  attention="dense" if mode == "dense"
                                  else "local",
                                  attn_window=4, attn_global_blocks=1,
                                  **extra)
        model = BlockSparseTransformer.create(cfg, jax.random.key(0))
        params = model.init(jax.random.key(1))
        cache0 = model.init_cache(batch=args.batch)

        def generate(tok0, params=params, model=model, cache0=cache0):
            def body(carry, _):
                tok, cache = carry
                logits, cache = model.decode_step(params, tok, cache)
                return (jnp.argmax(logits, -1).astype(jnp.int32), cache), \
                    logits.sum()
            (_, _), sums = jax.lax.scan(
                body, (tok0, cache0), None, length=gen)
            return sums  # [gen] checksum keeps every step live

        tok0 = jnp.zeros((args.batch,), jnp.int32)
        try:
            avg, std, _ = time_op(generate, tok0, warmup=1, reps=3)
            tps = gen * args.batch / avg
            log(f"{mode:6}: {avg*1e3:9.2f} ms/{gen} tokens "
                f"({tps:,.0f} tok/s, std {std*1e3:.2f})")
            out[mode] = {"ms": round(avg * 1e3, 2),
                         "tokens_per_s": round(tps, 1)}
        except Exception as e:  # noqa: BLE001
            log(f"{mode:6}: FAILED {type(e).__name__}: {str(e)[:160]}")
            out[mode] = {"error": str(e)[:160]}

    if "ms" in out.get("dense", {}) and "ms" in out.get("local", {}):
        out["local_speedup"] = round(
            out["dense"]["ms"] / out["local"]["ms"], 2)
    from sparta_tpu.bench.results import write_result
    write_result(args.out, out, quick=args.quick, hw_only=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
