"""Smoke test of the main paths on one GPU, through the entry points a user
calls, at real sizes.

    python chip_smoke.py          # one card: device, SpMM, train, GCN
    python chip_smoke.py --four   # four cards: the sharded SpMM layouts
                                  # and the dp x tp train step, each
                                  # against its one-card result

Every phase compares with a plain reference: ``jax.numpy`` in float32 under
``jax.default_matmul_precision("highest")``, or scipy on the host.  Each
check prints its max relative error (max |got - ref| / max |ref|), its
tolerance and the reason for it.  Any failed check exits non-zero.  The
last line of standard output is one JSON object naming the device.  With
no GPU the script exits non-zero before any phase.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

BF16_TOL = 1e-2  # bf16 storage, fp32 accumulation: the matched-accuracy gate
BF16_WHY = "bf16 storage with fp32 accumulation (matched-accuracy gate)"


class SmokeFailure(Exception):
    pass


def log(*a):
    print(*a, flush=True)


def rel_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


def check(name: str, got, ref, tol: float, why: str) -> float:
    err = rel_err(got, ref)
    ok = np.isfinite(err) and err <= tol
    log(f"  {name}: max rel err {err:.3e}  tol {tol:g}  ({why})  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{name}: {err:.3e} > {tol:g}")
    return err


# --------------------------------------------------------------- phases ---
def phase_spmm(n: int = 10240, N: int = 2048, taus=(0.5, 0.3, 0.1, 0.05),
               suite_sizes=((90, 90), 13, 8192)):
    """Reorder -> block -> plan_spmm at the headline shape with every blocked
    candidate and the quantized legs; csr_spmm_auto on the suite."""
    import jax
    import jax.numpy as jnp

    from sparta_tpu.bench.tau import search_tau
    from sparta_tpu.datasets import banded_csr, stencil_csr
    from sparta_tpu.formats import bell_from_csr, random_block_csr
    from sparta_tpu.formats.csr import rmat_csr
    from sparta_tpu.ops import (
        BellDevice,
        QBellDevice,
        bell_spmm_quant,
        bell_spmm_triton,
        csr_spmm_auto,
        plan_spmm,
        quantize_b_cols,
        quantize_b_global_cols,
        spmm_route,
    )
    from sparta_tpu.ops.blocked import xla_route
    from sparta_tpu.ops.select import _build_plan, _candidates

    log(f"[spmm] headline: {n}^2 planted 128-blocks, bf16, B_cols {N}")
    m = random_block_csr(n, n, block=128, block_density=0.08,
                         intra_density=0.13, seed=7)
    t0 = time.perf_counter()
    res = search_tau(m, 128, 128, taus=taus)
    log(f"  search_tau {time.perf_counter() - t0:.1f}s: nzblocks "
        f"{res.natural_nzblocks} -> {res.nzblocks} (tau {res.best_tau})")
    bell = bell_from_csr(m, res.grouping, block_row_size=128)
    Bf = np.random.default_rng(0).standard_normal(
        (bell.shape[1], N)).astype(np.float32)
    B = jnp.asarray(Bf, jnp.bfloat16)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jnp.dot(jnp.asarray(bell.to_dense_permuted()),
                                 B.astype(jnp.float32)))

    kinds = _candidates(bell, jnp.bfloat16)
    if spmm_route(128, 128) != "triton" or "triton" not in kinds:
        raise SmokeFailure("the blocked kernel is not routed on this device")
    for kind in kinds:
        plan = _build_plan(bell, kind, jnp.bfloat16)
        check(f"candidate {plan.backend}", plan(B), ref, BF16_TOL, BF16_WHY)
        del plan
    plan = plan_spmm(bell, N, dtype=jnp.bfloat16)
    check(f"plan_spmm pick ({plan.backend})", plan(B), ref, BF16_TOL,
          BF16_WHY)
    del plan

    dev = BellDevice.from_host(bell, dtype=jnp.bfloat16)
    bias = jnp.asarray(np.random.default_rng(1).standard_normal(
        bell.shape[0]).astype(np.float32))
    check("kernel bias+relu epilogue",
          bell_spmm_triton(dev, B, bias=bias, relu=True),
          np.maximum(ref + np.asarray(bias)[:, None], 0), BF16_TOL, BF16_WHY)
    f32 = BellDevice.from_host(bell, dtype=jnp.float32)
    check("kernel float32 (TF32 dots, as XLA's default)",
          bell_spmm_triton(f32, B.astype(jnp.float32)), ref, 5e-3,
          "TF32 keeps ~10 mantissa bits; XLA's float32 default is TF32 too")
    del f32

    for name, qdtype, per_col, tol, why in (
            ("int8_rowcol", jnp.int8, False, 2e-2,
             "int8 storage of both operands, ~1/254 per element"),
            ("int8_global", jnp.int8, True, 2e-2,
             "int8 with one B scale per column (coarser than rowcol)"),
            ("fp8_rowcol", jnp.float8_e4m3fn, False, 8e-2,
             "e4m3 keeps 3 mantissa bits: ~6% per element")):
        qdev = QBellDevice.from_bell(bell, dtype=qdtype)
        Bq, bs = (quantize_b_global_cols(B, dtype=qdtype) if per_col
                  else quantize_b_cols(B, 128, dtype=qdtype))
        got = bell_spmm_quant(qdev, Bq, bs)
        err = check(f"{name} vs float32", got, ref, tol, why)
        log(f"    {name} 1e-2 accuracy gate: "
            f"{'PASS' if err <= 1e-2 else 'FAIL'}")
        with xla_route():
            plain = jax.jit(lambda q, b, s: bell_spmm_quant(q, b, s))(
                qdev, Bq, bs)
        check(f"{name} kernel vs XLA route", got, plain, 1e-4,
              "same quantized math, fp32 sums in another order")
        del qdev, Bq

    stem, rmat_scale, band_n = suite_sizes
    suite = {"fem_2d": stencil_csr(stem, pattern="box", seed=5),
             "rmat": rmat_csr(rmat_scale, edge_factor=8, seed=4),
             "banded": banded_csr(band_n, bandwidth=192, seed=8)}
    for name, sm in suite.items():
        Bs = np.random.default_rng(1).standard_normal(
            (sm.cols, N)).astype(np.float32)
        Bb = jnp.asarray(Bs, jnp.bfloat16)
        fn, picked, _ = csr_spmm_auto(sm, N, dtype=jnp.bfloat16)
        sref = sm.to_scipy() @ np.asarray(Bb, np.float32)
        check(f"csr_spmm_auto {name} ({picked})", fn(Bb), sref, BF16_TOL,
              BF16_WHY)


def phase_train(d_model=1024, n_heads=16, n_layers=4, d_ff=4096, T=2048,
                batch=2, vocab=4096, steps=3):
    """train_bench's full config: FFN SpMM forward/backward, local
    block-sparse attention, adamw."""
    import jax
    import jax.numpy as jnp
    import optax

    from sparta_tpu.models import BlockSparseTransformer, TransformerConfig
    from sparta_tpu.models.train import lm_loss, make_train_step
    from sparta_tpu.ops.blocked import xla_route

    cfg = TransformerConfig(
        vocab=vocab, d_model=d_model, n_heads=n_heads, n_layers=n_layers,
        d_ff=d_ff, max_seq=T, block=128, ffn_block_density=0.15,
        dtype="bfloat16", attention="local", attn_window=4,
        attn_global_blocks=1)
    log(f"[train] d_model {d_model}, {n_heads} heads, {n_layers} layers, "
        f"d_ff {d_ff}, T {T}, batch {batch}, bf16, local attention")
    model = BlockSparseTransformer.create(cfg, jax.random.key(0))
    params = model.init(jax.random.key(1))
    tokens = jnp.asarray(np.random.default_rng(0).integers(
        0, vocab, (batch, T)), jnp.int32)

    def grad_fn():
        return jax.jit(jax.value_and_grad(
            lambda p, t: lm_loss(model, p, t)))

    loss_k, g_k = grad_fn()(params, tokens)
    with xla_route():
        loss_x, g_x = grad_fn()(params, tokens)
    tol, why = 5e-2, ("bf16 activations through 4 layers; the two routes "
                      "sum in another order")
    check("step-1 loss, kernel vs XLA route", loss_k, loss_x, tol, why)
    worst = max(rel_err(a, b) for a, b in zip(jax.tree.leaves(g_k),
                                              jax.tree.leaves(g_x)))
    check_value("step-1 gradients, kernel vs XLA route (worst leaf)",
                worst, tol, why)
    del g_k, g_x

    opt = optax.adamw(1e-3)
    step = make_train_step(model, opt)
    opt_state = opt.init(params)
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state, tokens)
        loss = float(loss)
        log(f"  adamw step {i + 1}: loss {loss:.4f}")
        if not np.isfinite(loss):
            raise SmokeFailure(f"non-finite loss at step {i + 1}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use', 'n/a')}")


def check_value(name: str, err: float, tol: float, why: str) -> None:
    ok = np.isfinite(err) and err <= tol
    log(f"  {name}: max rel err {err:.3e}  tol {tol:g}  ({why})  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{name}: {err:.3e} > {tol:g}")


def phase_gcn(grid=32, feat=256, hidden=256, classes=16):
    """gcn_bench's shape: one training step on a 32^3-node FEM graph."""
    import jax
    import jax.numpy as jnp
    import optax

    from sparta_tpu.datasets import stencil_csr
    from sparta_tpu.models import GCN, GCNConfig, make_gcn_train_step
    from sparta_tpu.models.gcn import normalize_adjacency

    adj = stencil_csr((grid,) * 3, pattern="box", seed=0)
    n = adj.rows
    log(f"[gcn] {n} nodes, nnz {adj.nnz}, {feat} features, 2 layers")
    cfg = GCNConfig(in_dim=feat, hidden_dim=hidden, out_dim=classes,
                    n_layers=2, block=128, tau=0.2, dtype="float32")
    model = GCN.create(adj, cfg)
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, feat)).astype(np.float32)
    labels = jnp.asarray(rng.integers(0, classes, n))
    mask = jnp.ones(n, dtype=jnp.float32)

    # the forward against scipy: relu(A (X W0 + b0) ...) with the same
    # normalized adjacency, on the host
    A = normalize_adjacency(adj).to_scipy()
    H = X
    for i, lp in enumerate(params["layers"]):
        H = A @ H
        H = H @ np.asarray(lp["w"], np.float32) + np.asarray(lp["b"])
        if i < len(params["layers"]) - 1:
            H = np.maximum(H, 0)
    got = model.apply(params, jnp.asarray(X))
    check("GCN forward vs scipy", got, H, 2e-3,
          "float32 storage; TF32 dots in the dense transforms")
    opt = optax.adam(1e-3)
    step = make_gcn_train_step(model, opt)
    params, _, loss = step(params, opt.init(params), jnp.asarray(X), labels,
                           mask)
    loss = float(loss)
    log(f"  train step loss {loss:.4f}")
    if not np.isfinite(loss):
        raise SmokeFailure("non-finite GCN loss")


def phase_four(n=10240, N=2048, d_model=1024, n_heads=16, n_layers=4,
               d_ff=4096, T=2048, vocab=4096):
    """Four cards: row-sharded, ring and colsplit SpMM with the kernel inside
    shard_map, and the dp x tp train step — each against one card."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sparta_tpu.formats import bell_from_csr, random_block_csr
    from sparta_tpu.models import BlockSparseTransformer, TransformerConfig
    from sparta_tpu.models.train import make_sharded_train_step, make_train_step
    from sparta_tpu.ops import BellDevice, bell_spmm_triton
    from sparta_tpu.parallel import (
        make_mesh,
        make_mesh_2d,
        shard_bell_rowwise,
        spmm_colsplit_reduce_scatter,
        spmm_ring,
        spmm_rowsharded,
        split_bell_cols,
    )

    nd = len(jax.devices())
    if nd < 4:
        raise SmokeFailure(f"--four needs 4 devices, found {nd}")
    mesh = make_mesh(4)
    log(f"[four] {n}^2 planted 128-blocks, bf16, B_cols {N}, mesh {mesh.shape}")
    m = random_block_csr(n, n, block=128, block_density=0.08,
                         intra_density=0.13, seed=7)
    bell = bell_from_csr(m, None, block_row_size=128)
    B = jnp.asarray(np.random.default_rng(0).standard_normal(
        (bell.shape[1], N)), jnp.bfloat16)
    one = np.asarray(bell_spmm_triton(BellDevice.from_host(
        bell, dtype=jnp.bfloat16), B), np.float32)
    tol, why = 1e-2, "bf16 output rounding; sums split across devices"

    devp = shard_bell_rowwise(bell, mesh, dtype=jnp.bfloat16)
    rows = bell.shape[0]
    got = spmm_rowsharded(devp, B, mesh=mesh)
    check("spmm_rowsharded vs one card", np.asarray(got)[:rows], one, tol,
          why)
    Bcol = jax.device_put(B, NamedSharding(mesh, P(None, "x")))
    got = spmm_ring(devp, Bcol, mesh)
    check("spmm_ring vs one card", np.asarray(got)[:rows], one, tol, why)
    ci, nb, vals, k_part = split_bell_cols(bell, 4)
    Kp = 4 * k_part * 128
    Bk = jnp.pad(B, ((0, Kp - B.shape[0]), (0, 0))).reshape(4, k_part * 128, N)
    rows4 = -(-bell.n_block_rows // 4) * 4
    pad = rows4 - bell.n_block_rows
    ci = np.pad(ci, ((0, 0), (0, pad), (0, 0)), constant_values=-1)
    nb = np.pad(nb, ((0, 0), (0, pad)))
    vals = np.pad(vals, ((0, 0), (0, pad), (0, 0), (0, 0), (0, 0)))
    sh = NamedSharding(mesh, P("x"))
    got = spmm_colsplit_reduce_scatter(
        jax.device_put(jnp.asarray(ci, jnp.int32), sh),
        jax.device_put(jnp.asarray(nb, jnp.int32), sh),
        jax.device_put(jnp.asarray(vals, jnp.bfloat16), sh),
        jax.device_put(Bk, sh), mesh)
    check("spmm_colsplit_reduce_scatter vs one card",
          np.asarray(got)[:rows], one, tol, why)

    cfg = TransformerConfig(
        vocab=vocab, d_model=d_model, n_heads=n_heads, n_layers=n_layers,
        d_ff=d_ff, max_seq=T, block=128, ffn_block_density=0.15,
        dtype="bfloat16", attention="local", attn_window=4,
        attn_global_blocks=1)
    model = BlockSparseTransformer.create(cfg, jax.random.key(0))
    tokens = jnp.asarray(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, cfg.max_seq)), jnp.int32)
    # one SGD step at learning rate 1 moves each parameter by exactly minus
    # its gradient, so comparing the moves checks the dp gradient reduction
    # and the tp gradient exchange, which the loss alone does not see
    opt = optax.sgd(1.0)
    params = model.init(jax.random.key(1))
    before = [np.asarray(x, np.float32) for x in jax.tree.leaves(params)]
    p1, _, loss1 = make_train_step(model, opt)(params, opt.init(params),
                                               tokens)
    init, step = make_sharded_train_step(model, opt, make_mesh_2d((2, 2)))
    p, o, t = init(jax.random.key(1), tokens)
    p4, _, loss4 = step(p, o, t)
    tol, why = 5e-2, "bf16 activations; sharded sums run in another order"
    check("dp x tp train step loss vs one card", float(loss4), float(loss1),
          tol, why)
    worst = max(rel_err(np.asarray(a, np.float32) - b0,
                        np.asarray(b, np.float32) - b0)
                for a, b, b0 in zip(jax.tree.leaves(p4), jax.tree.leaves(p1),
                                    before))
    check_value("dp x tp gradients vs one card (worst leaf)", worst, tol, why)


# ----------------------------------------------------------------- main ---
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's device is {devs[0].platform!r})",
              file=sys.stderr)
        return 1

    from sparta_tpu.runtime import card_info, setup_compile_cache

    setup_compile_cache()
    log(f"devices: {len(devs)} x {devs[0].device_kind}")
    log(f"card (name, power limit): {card_info()}")
    phases = [phase_four] if args.four else [phase_spmm, phase_train,
                                              phase_gcn]
    for phase in phases:
        t0 = time.perf_counter()
        try:
            phase()
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED in {phase.__name__}: {e}",
                  file=sys.stderr)
            return 1
        log(f"  ({phase.__name__} {time.perf_counter() - t0:.1f}s)")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
