"""Each hand-written kernel against the plain version XLA compiles, on the
GPU, at the shapes the benchmark uses — the numbers behind PERF.md's
"Kernel decisions" table.

    python scripts/kernel_decisions.py > chiprun_out/kernel_decisions.json

Legs (all bf16 unless named; times are medians of block_until_ready
windows, milliseconds):
- blocked SpMM at the headline (10240^2 planted 128-blocks, B_cols 2048):
  the Triton kernel, bell_spmm_xla and the densified cuBLAS GEMM;
- the quantized products through the kernel and through XLA's plain path;
- the fine family at the suite's rmat size (rmat13, B_cols 2048): the
  segment-sum combine (fine), the batched-dot combine (dedup, dedup256)
  and FELL;
- a Pallas (Triton) dense GEMM against cuBLAS at 10240 x 10240 x 2048;
- block-sparse attention on the XLA path, forward and forward+backward,
  h=16, d=64, window 4 + 1 global key block, causal, T=2048 and 4096.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _pallas_gemm(a, b, bm=128, bn=128, bk=64):
    """Textbook Pallas GEMM through Triton (for the comparison only)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    M, K = a.shape
    N = b.shape[1]

    def kernel(a_ref, b_ref, o_ref):
        i, j = pl.program_id(0), pl.program_id(1)

        def body(k, acc):
            x = a_ref[pl.ds(i * bm, bm), pl.ds(k * bk, bk)]
            y = b_ref[pl.ds(k * bk, bk), pl.ds(j * bn, bn)]
            return acc + pl.dot(x, y)

        acc = jax.lax.fori_loop(0, K // bk, body,
                                jnp.zeros((bm, bn), jnp.float32))
        o_ref[...] = acc.astype(o_ref.dtype)

    return pl.pallas_call(
        kernel, grid=(M // bm, N // bn),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 2,
        out_specs=pl.BlockSpec((bm, bn), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((M, N), a.dtype),
        compiler_params=plt.CompilerParams(num_warps=8, num_stages=3),
    )(a, b)


def main():
    from sparta_tpu.runtime import device_info, require_gpu, setup_compile_cache

    setup_compile_cache()
    require_gpu()
    import jax
    import jax.numpy as jnp

    from sparta_tpu.bench.tau import search_tau
    from sparta_tpu.bench.timing import time_op
    from sparta_tpu.formats import bell_from_csr, random_block_csr
    from sparta_tpu.formats.csr import rmat_csr
    from sparta_tpu.ops import (
        BellDevice,
        QBellDevice,
        bell_spmm_quant,
        bell_spmm_triton,
        bell_spmm_xla,
        build_block_mask,
        block_sparse_attention,
        dense_matmul,
        quantize_b_cols,
        quantize_b_global_cols,
    )
    from sparta_tpu.ops.blocked import xla_route
    from sparta_tpu.ops.csr_spmm import csr_candidate_fn
    from sparta_tpu.ops.fine import (
        FellDevice,
        FineDevice,
        fell_spmm,
        fine_spmm,
    )

    out = {"device": device_info()}

    def t(name, fn, x):
        ms = time_op(fn, x, warmup=2, reps=7)[0] * 1e3
        out[name] = ms
        log(f"{name:36s} {ms:9.4f} ms")

    N = 2048
    m = random_block_csr(10240, 10240, block=128, block_density=0.08,
                         intra_density=0.13, seed=7)
    res = search_tau(m, 128, 128, taus=(0.5, 0.3, 0.1, 0.05))
    bell = bell_from_csr(m, res.grouping, block_row_size=128)
    dev = BellDevice.from_host(bell, dtype=jnp.bfloat16)
    B = jnp.asarray(np.random.default_rng(0).standard_normal(
        (bell.shape[1], N)), jnp.bfloat16)
    A = jnp.asarray(bell.to_dense_permuted(), jnp.bfloat16)
    t("blocked/triton", lambda b: bell_spmm_triton(dev, b), B)
    t("blocked/xla", lambda b: bell_spmm_xla(dev, b), B)
    t("blocked/dense_cublas", lambda b: dense_matmul(A, b), B)

    for name, qd, per_col in (("int8_rowcol", jnp.int8, False),
                              ("int8_global", jnp.int8, True),
                              ("fp8_rowcol", jnp.float8_e4m3fn, False)):
        q = QBellDevice.from_bell(bell, dtype=qd)
        Bq, bs = (quantize_b_global_cols(B, dtype=qd) if per_col
                  else quantize_b_cols(B, 128, dtype=qd))
        t(f"quant/{name}/triton", lambda a: bell_spmm_quant(*a), (q, Bq, bs))
        with xla_route():
            plain = jax.jit(lambda a: bell_spmm_quant(*a))
            t(f"quant/{name}/xla", plain, (q, Bq, bs))

    rm = rmat_csr(13, edge_factor=8, seed=4)
    Br = jnp.asarray(np.random.default_rng(1).standard_normal(
        (rm.cols, N)), jnp.bfloat16)
    fine = FineDevice.from_csr(rm, dtype=jnp.bfloat16)
    t("fine_family/fine", lambda b: fine_spmm(fine, b), Br)
    for name in ("dedup", "dedup256"):
        t(f"fine_family/{name}",
          csr_candidate_fn(rm, N, name, dtype=jnp.bfloat16), Br)
    fell = FellDevice.from_csr(rm, dtype=jnp.bfloat16)
    t("fine_family/fell", lambda b: fell_spmm(fell, b), Br)

    a = jnp.asarray(np.random.default_rng(2).standard_normal(
        (10240, 10240)), jnp.bfloat16)
    gemm = jax.jit(_pallas_gemm)
    t("gemm/pallas_triton", lambda ab: gemm(*ab), (a, B))
    t("gemm/cublas", lambda ab: dense_matmul(*ab), (a, B))

    for T in (2048, 4096):
        mask = build_block_mask(T, T, 128, window=4, causal=True,
                                global_blocks=1)
        qkv = tuple(jnp.asarray(np.random.default_rng(s).standard_normal(
            (1, 16, T, 64)), jnp.bfloat16) for s in range(3))
        fwd = jax.jit(lambda qkv, mask=mask: block_sparse_attention(
            *qkv, mask))
        t(f"attention/xla_fwd_T{T}", fwd, qkv)

        def loss(qkv, mask=mask):
            return jnp.sum(block_sparse_attention(*qkv, mask)
                           .astype(jnp.float32) ** 2)

        t(f"attention/xla_fwd_bwd_T{T}", jax.jit(jax.grad(loss)), qkv)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
