"""Multi-chip scaling benchmark: nnz/s at 1..N devices, all three layouts.

Row-sharded / ring / colsplit+reduce_scatter SpMM at 1..N devices.  Runs
on whatever devices exist — the GPUs of one host, or a virtual CPU mesh for
logic validation (no device numbers come from that):

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python scripts/scaling_bench.py

On the GPU the shard-local compute is the blocked Triton kernel; on the
CPU it is the XLA path.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    import jax

    from sparta_tpu.runtime import device_info, setup_compile_cache

    setup_compile_cache()
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sparta_tpu.bench.timing import time_op
    from sparta_tpu.formats import bell_from_csr, random_block_csr
    from sparta_tpu.ops import pad_b_for_bell
    from sparta_tpu.parallel import (
        make_mesh,
        pad_block_rows,
        shard_bell_rowwise,
        spmm_colsplit_reduce_scatter,
        spmm_ring,
        spmm_rowsharded,
        split_bell_cols,
    )

    on_gpu = jax.default_backend() == "gpu"
    n_dev = jax.device_count()
    print(f"device: {device_info()}", file=sys.stderr)
    size = 8192 if on_gpu else 1024
    m = random_block_csr(size, size, block=128, block_density=0.1,
                         intra_density=0.3, seed=3)
    bell = bell_from_csr(m, None, block_row_size=128)
    N = 1024 if on_gpu else 256
    rows = []

    for nd in [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]:
        mesh = make_mesh(nd)
        dev = shard_bell_rowwise(bell, mesh)
        # per-shard nonzero-block counts: the load-balance diagnostic a
        # single-shard dryrun cannot give (correctness-grade, not a perf claim)
        import numpy as _np
        nbr_pad = -(-bell.n_block_rows // nd) * nd
        nb_pad = _np.zeros(nbr_pad, dtype=_np.int64)
        nb_pad[: bell.n_block_rows] = bell.nb_row
        row_shard_blocks = nb_pad.reshape(nd, -1).sum(axis=1).tolist()
        Bnp = pad_b_for_bell(
            np.random.default_rng(0).standard_normal(
                (bell.shape[1], N)).astype(np.float32), bell)

        # row-sharded: B replicated, no collectives
        Brep = jax.device_put(jnp.asarray(Bnp), NamedSharding(mesh, P()))
        avg, _, _ = time_op(
            lambda b: spmm_rowsharded(dev, b, mesh=mesh), Brep,
            reps=3, target_time=0.15)
        rows.append({"devices": nd, "layout": "row_sharded", "ms": avg * 1e3,
                     "nnz_per_s": m.nnz / avg,
                     "shard_blocks": row_shard_blocks})
        print(rows[-1], file=sys.stderr)

        # ring: B column-sharded, ppermute rotation (needs N % nd == 0)
        if N % nd == 0:
            Bcol = jax.device_put(jnp.asarray(Bnp),
                                  NamedSharding(mesh, P(None, "x")))
            avg, _, _ = time_op(
                lambda b: spmm_ring(dev, b, mesh), Bcol,
                reps=3, target_time=0.15)
            rows.append({"devices": nd, "layout": "ring", "ms": avg * 1e3,
                         "nnz_per_s": m.nnz / avg,
                         "shard_blocks": row_shard_blocks})
            print(rows[-1], file=sys.stderr)

        # colsplit + reduce_scatter: K sharded
        bell_p = pad_block_rows(bell, nd)
        ci, nb, v, k_part = split_bell_cols(bell_p, nd)
        bw = bell.block_col_size
        Bp = np.zeros((nd * k_part * bw, N), dtype=np.float32)
        Bp[: Bnp.shape[0]] = Bnp
        Bparts = jax.device_put(
            jnp.asarray(Bp.reshape(nd, k_part * bw, N)),
            NamedSharding(mesh, P("x", None, None)))
        ci_d = jax.device_put(jnp.asarray(ci),
                              NamedSharding(mesh, P("x", None, None)))
        nb_d = jax.device_put(jnp.asarray(nb), NamedSharding(mesh, P("x", None)))
        v_d = jax.device_put(jnp.asarray(v),
                             NamedSharding(mesh, P("x", None, None, None, None)))
        avg, _, _ = time_op(
            lambda b: spmm_colsplit_reduce_scatter(ci_d, nb_d, v_d, b, mesh),
            Bparts, reps=3, target_time=0.15)
        rows.append({"devices": nd, "layout": "colsplit_rs", "ms": avg * 1e3,
                     "nnz_per_s": m.nnz / avg,
                     "shard_blocks": nb.sum(axis=1).astype(int).tolist()})
        print(rows[-1], file=sys.stderr)

    base = {}
    for r in rows:
        base.setdefault(r["layout"], r["nnz_per_s"] / r["devices"]
                        if r["devices"] == 1 else None)
    for r in rows:
        b = base.get(r["layout"])
        r["efficiency"] = r["nnz_per_s"] / (b * r["devices"]) if b else None
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
