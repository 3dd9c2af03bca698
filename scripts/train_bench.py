"""End-to-end transformer TRAINING throughput on real hardware.

The model-level composition bench: full train steps (loss + grads +
adamw update) through the block-sparse FFN SpMM custom-VJP kernels and
the block-sparse attention (XLA), vs the dense-attention baseline.  Reports
tokens/s and ms/step per configuration:

  dense_T2048   full causal attention (baseline)
  local_T2048   block-sparse local attention (window 4 + 1 global)
  local_T4096   same at 2x context (dense at 4k would materialize
                multi-GB score tensors; the block pattern is the point)
  moe_T2048     local attention + 4-expert block-sparse MoE FFN

The timed function folds a full reduction of every UPDATED param leaf
into the checksum (1e-9-scaled) — without it XLA dead-code-eliminates
the optimizer update; the extra reduction pass is <5% of a step and is
included in the reported time (honest end-to-end cost).

Writes results/train_bench.json.  Usage: python scripts/train_bench.py
[--quick]
"""
from __future__ import annotations

import argparse
import dataclasses
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
    ap.add_argument("--out", default="results/train_bench.json")
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()

    import jax

    from sparta_tpu.runtime import require_gpu, setup_compile_cache

    setup_compile_cache()
    require_gpu()
    import jax.numpy as jnp
    import optax

    from sparta_tpu.bench.timing import time_op
    from sparta_tpu.models import BlockSparseTransformer, TransformerConfig
    from sparta_tpu.models.train import lm_loss

    log(f"devices: {jax.devices()}")
    B = args.batch
    if args.quick:
        base = TransformerConfig(
            vocab=512, d_model=256, n_heads=4, n_layers=2, d_ff=1024,
            max_seq=256, block=128, ffn_block_density=0.25,
            dtype="bfloat16", attn_window=4, attn_global_blocks=1)
        cells = [("local_T256", {"attention": "local"}),
                 ("dense_T256", {"attention": "dense"})]
    else:
        base = TransformerConfig(
            vocab=4096, d_model=1024, n_heads=16, n_layers=4, d_ff=4096,
            max_seq=2048, block=128, ffn_block_density=0.15,
            dtype="bfloat16", attn_window=4, attn_global_blocks=1)
        cells = [
            ("dense_T2048", {"attention": "dense"}),
            ("local_T2048", {"attention": "local"}),
            ("local_T4096", {"attention": "local", "max_seq": 4096}),
            ("moe_T2048", {"attention": "local", "moe_experts": 4,
                           "moe_capacity": 1.5}),
        ]
    out = {"batch": B, "d_model": base.d_model, "n_layers": base.n_layers,
           "d_ff": base.d_ff, "vocab": base.vocab, "dtype": base.dtype,
           "ffn_block_density": base.ffn_block_density}

    rng = np.random.default_rng(0)
    opt = optax.adamw(1e-3)
    for name, extra in cells:
        cfg = dataclasses.replace(base, **extra)
        T = cfg.max_seq
        model = BlockSparseTransformer.create(cfg, jax.random.key(0))
        params = model.init(jax.random.key(1))
        opt_state = opt.init(params)
        n_params = model.param_count(params)
        tokens = jnp.asarray(
            rng.integers(0, cfg.vocab, (B, T)), jnp.int32)

        def step_loss(tok, params=params, opt_state=opt_state, model=model):
            loss, grads = jax.value_and_grad(
                lambda p: lm_loss(model, p, tok))(params)
            updates, _ = opt.update(grads, opt_state, params)
            new_params = optax.apply_updates(params, updates)
            chk = sum(jnp.sum(leaf.astype(jnp.float32))
                      for leaf in jax.tree.leaves(new_params))
            return loss + 1e-9 * chk  # keeps the update un-DCE'd

        try:
            avg, std, _ = time_op(step_loss, tokens, warmup=1, reps=3)
            tps = B * T / avg
            row = {"T": T, "ms": round(avg * 1e3, 2),
                   "tokens_per_s": round(tps),
                   "params_m": round(n_params / 1e6, 1),
                   "std_ms": round(std * 1e3, 3)}
            log(f"{name:12}: {avg*1e3:8.2f} ms/step  {tps:10,.0f} tok/s  "
                f"({n_params/1e6:.1f}M params, std {std*1e3:.2f})")
        except Exception as e:  # noqa: BLE001
            row = {"T": T, "error": str(e)[:200]}
            log(f"{name:12}: FAILED {type(e).__name__}: {str(e)[:160]}")
        out[name] = row
        write_result(args.out, out, quick=args.quick, hw_only=True)

    if "dense_T2048" in out and "local_T2048" in out and \
            "ms" in out.get("dense_T2048", {}) and \
            "ms" in out.get("local_T2048", {}):
        out["local_vs_dense_T2048"] = round(
            out["dense_T2048"]["ms"] / out["local_T2048"]["ms"], 2)
        write_result(args.out, out, quick=args.quick, hw_only=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
