"""Unstructured CSR/COO SpMM baselines (the reference's cuSPARSE CSR path,
cuda_utilities.cpp:1251-1431, reimagined for XLA).

Two backends:
- BCOO via jax.experimental.sparse (library baseline);
- a padded-ELL row-gather weighted sum (our own).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import sparse as jsparse

from ..definitions import round_up, to_device
from ..formats.csr import CSR

# timed calls per candidate when csr_spmm_auto measures: the suite's
# candidates run in 0.1-0.5 ms on an H100, and with three calls the rmat
# pick swapped from run to run between two candidates ~20% apart
AUTOTUNE_REPS = 20

def csr_to_bcoo(cmat: CSR, dtype=jnp.float32) -> jsparse.BCOO:
    rows = np.repeat(np.arange(cmat.rows), cmat.row_nnz)
    idx = np.stack([rows, cmat.indices], axis=1)
    return jsparse.BCOO(
        (jnp.asarray(cmat.values(), dtype=dtype), jnp.asarray(idx, dtype=jnp.int32)),
        shape=cmat.shape,
    )


@jax.jit
def _bcoo_spmm_one(A: jsparse.BCOO, B: jax.Array) -> jax.Array:
    return A @ B


def bcoo_spmm(A: jsparse.BCOO, B: jax.Array, max_cols: int = 2048) -> jax.Array:
    """CSR/BCOO SpMM baseline. Wide operands run in column slabs, which
    bound the scatter working set.  Evenly-divisible widths run the slabs
    under ``lax.scan`` so a jitted CALLER still traces one slab-sized
    scatter program instead of inlining all of them."""
    if B.shape[1] <= max_cols:
        return _bcoo_spmm_one(A, B)
    if B.shape[1] % max_cols == 0:
        return _bcoo_spmm_scan(A, B, max_cols)
    outs = [
        _bcoo_spmm_one(A, B[:, i : i + max_cols])
        for i in range(0, B.shape[1], max_cols)
    ]
    return jnp.concatenate(outs, axis=1)


@functools.partial(jax.jit, static_argnames=("max_cols",))
def _bcoo_spmm_scan(A: jsparse.BCOO, B: jax.Array, max_cols: int) -> jax.Array:
    K, N = B.shape
    ns = N // max_cols
    slabs = jnp.moveaxis(B.reshape(K, ns, max_cols), 1, 0)  # [ns, K, mc]
    _, outs = jax.lax.scan(lambda _, b: (None, A @ b), None, slabs)
    return jnp.moveaxis(outs, 0, 1).reshape(A.shape[0], N)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class EllDevice:
    """Row-wise ELL: per-row column indices padded to max row length."""

    cols: jax.Array  # int32 [rows, max_nnz], 0-padded
    vals: jax.Array  # [rows, max_nnz], 0-padded

    def tree_flatten(self):
        return (self.cols, self.vals), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def from_csr(cls, cmat: CSR, dtype=jnp.float32, pad_to: int = 8) -> "EllDevice":
        counts = cmat.row_nnz
        width = max(round_up(int(counts.max()) if counts.size else 0, pad_to), pad_to)
        cols = np.zeros((cmat.rows, width), dtype=np.int32)
        vals = np.zeros((cmat.rows, width), dtype=np.float32)
        ord_in_row = np.arange(cmat.nnz) - np.repeat(cmat.indptr[:-1], counts)
        r = np.repeat(np.arange(cmat.rows), counts)
        cols[r, ord_in_row] = cmat.indices
        vals[r, ord_in_row] = cmat.values()
        return cls(jnp.asarray(cols), to_device(vals, dtype))


@jax.jit
def ell_spmm(A: EllDevice, B: jax.Array) -> jax.Array:
    """C = A @ B via row-wise gather + weighted sum.

    Zero-padding entries gather B[0] with weight 0 — harmless.  The gather
    is [rows, max_nnz, N]; fine for moderate max row length."""
    gathered = B[A.cols]                      # [rows, max_nnz, N]
    return jnp.einsum(
        "rk,rkn->rn", A.vals, gathered, preferred_element_type=jnp.float32
    ).astype(B.dtype)


def dense_matmul(A: jax.Array, B: jax.Array, accum_dtype=jnp.float32) -> jax.Array:
    """Dense GEMM baseline (reference cublas_dense_multiplyAB,
    cuda_utilities.cpp:1769-1889): densify then one GEMM (cuBLAS on the
    GPU)."""
    return jnp.dot(A, B, preferred_element_type=accum_dtype).astype(B.dtype)


dense_matmul = jax.jit(dense_matmul, static_argnames=("accum_dtype",))


def csr_work_table(cmat: CSR, N: int, dtype=jnp.float32):
    """Multiply-adds per call for every unstructured-SpMM candidate,
    padding included — the count ``csr_spmm_auto`` ranks when it does not
    measure, and that ``tools plan`` prints.  ``inf`` marks a candidate
    whose device operand would not fit (``densify_bytes_cap``).  Returns
    (table, aux); aux carries the derived inputs (natural-128 nonzero
    blocks, the dedup distinct-pair counts).

    The segment-sum combine (``fine_spmm``) and FELL are not candidates:
    on an H100 both lost to the batched-dot dedup combine by 6-27x at the
    suite's rmat size (PERF.md, kernel decisions).  They stay reachable
    through ``--csr-impl``."""
    from ..reorder.signatures import block_signatures
    from .select import densify_bytes_cap

    M, K = cmat.shape
    Np = round_up(N, 128)
    itemsize = jnp.dtype(dtype).itemsize
    cap = densify_bytes_cap()
    inf = float("inf")
    # natural fixed 128-blocking stats straight from signatures (cheap)
    sigs = block_signatures(cmat, 128)
    group_bits = np.bitwise_or.reduceat(
        sigs, np.arange(0, M, 128), axis=0) if M else sigs[:0]
    nzb = int(np.bitwise_count(group_bits).sum())
    rows_f = np.repeat(np.arange(M, dtype=np.int64), cmat.row_nnz)
    n_uniq = np.unique((rows_f >> 7) * np.int64(K) + cmat.indices).size
    n_uniq256 = np.unique((rows_f >> 8) * np.int64(K) + cmat.indices).size

    def fits(elems, work):
        return work if elems * itemsize <= cap else inf

    table = {
        "dense": fits(M * K, M * K * Np),
        "natbell128": fits(nzb * 128 * 128, nzb * 128 * 128 * Np),
        "dedup": fits(n_uniq * 128, n_uniq * 128 * Np),
        "dedup256": fits(n_uniq256 * 256, n_uniq256 * 256 * Np),
    }
    return table, {"natural_nzblocks": nzb, "dedup_n_uniq": n_uniq,
                   "dedup256_n_uniq": n_uniq256}


def csr_spmm_auto(cmat: CSR, N: int, dtype=jnp.float32,
                  autotune: bool | None = None):
    """Best unstructured-sparse SpMM for a raw CSR — NO reordering.

    The counterpart of the reference's cuSPARSE-CSR baseline
    (cusparse_gemm_custom, cuda_utilities.cpp:1251-1431): a library call
    that runs the matrix as-is, choosing its own internal layout among

    - densify + dense GEMM;
    - natural 128-blocking, empty blocks dropped (``plan_spmm``);
    - the distinct-column dedup combines of ops/fine.py, 128- and 256-row
      tiles.

    ``autotune`` (default: on when JAX's device is a GPU) MEASURES every
    candidate that fits, over enough repetitions that close candidates do
    not trade places from run to run, and caches the winner on disk
    (keyed by the CSR structure, with plan_spmm's cache); otherwise the
    candidate with the fewest multiply-adds (``csr_work_table``) runs.

    Returns ``(fn, backend_name, flops)`` with ``fn(B) -> C`` taking the
    logical [K, N] operand, and ``flops`` the per-call FLOP count of the
    chosen execution.
    """
    table, _ = csr_work_table(cmat, N, dtype)
    feasible = [k for k, v in table.items() if np.isfinite(v)]
    if autotune is None:
        autotune = jax.default_backend() == "gpu"
    if not autotune or len(feasible) == 1:
        name = min(feasible, key=table.get)
        fn, flops = csr_candidate_fn(cmat, N, name, dtype=dtype,
                                     with_flops=True)
        return fn, _backend_name(name), flops

    import hashlib

    from ..bench.timing import time_op
    from .select import _autotune_cache_get, _autotune_cache_put

    h = hashlib.blake2b(b"csr_auto_v4", digest_size=16)
    h.update(np.asarray(cmat.indptr).tobytes())
    h.update(np.asarray(cmat.indices).tobytes())
    h.update(f"{cmat.shape}/{N}/{jnp.dtype(dtype)}/"
             f"{jax.devices()[0].device_kind}".encode())
    key = h.hexdigest()
    hit = _autotune_cache_get(key)
    if hit is not None and hit.get("name") in feasible:
        fn, flops = csr_candidate_fn(cmat, N, hit["name"], dtype=dtype,
                                     with_flops=True)
        return fn, _backend_name(hit["name"]), flops
    B = jnp.asarray(np.random.default_rng(0).standard_normal(
        (cmat.cols, N)).astype(np.float32), dtype=dtype)
    best = None
    for name in feasible:
        fn, flops = csr_candidate_fn(cmat, N, name, dtype=dtype,
                                     with_flops=True)
        avg, _, _ = time_op(fn, B, warmup=2, reps=AUTOTUNE_REPS)
        if best is None or avg < best[0]:
            best = (avg, name, fn, flops)
        del fn
    _autotune_cache_put(key, {"name": best[1], "ms": best[0] * 1e3})
    return best[2], _backend_name(best[1]), best[3]


def _backend_name(name: str) -> str:
    if name == "dense":
        return "csr_auto_dense"
    if name == "natbell128":
        return "csr_auto_natbell128"
    return f"csr_auto_fine[{name}]"


def csr_candidate_fn(cmat: CSR, N: int, name: str, dtype=jnp.float32,
                     with_flops: bool = False):
    """Build ONE csr_work_table candidate's executable.  ``fn`` takes the
    logical [K, N] operand and returns [M, N].  With ``with_flops`` returns
    (fn, FLOPs per call of that execution)."""
    from ..formats.bell import bell_from_csr
    from .fine import DedupDevice, dedup_spmm
    from .select import plan_spmm

    M, K = cmat.shape
    Np = round_up(N, 128)
    flops = 2 * cmat.nnz * Np
    if name == "dense":
        A = to_device(cmat.to_dense(), dtype)
        fn, flops = (lambda B: dense_matmul(A, B)), 2 * M * K * N
    elif name == "natbell128":
        bell = bell_from_csr(cmat, None, block_row_size=128,
                             block_col_size=128)
        plan = plan_spmm(bell, Np, dtype=dtype)
        Kp, Mp = bell.shape[1], bell.shape[0]
        flops = 2 * bell.total_nzblocks * 128 * 128 * Np
        if (Kp, Np, Mp) == (K, N, M):
            fn = plan.fn
        else:
            def fn(B):
                return plan.fn(jnp.pad(B, ((0, Kp - K), (0, Np - N))))[:M, :N]
    elif name in ("dedup", "dedup256"):
        dev = DedupDevice.from_csr(
            cmat, dtype=dtype, tile_rows=256 if name == "dedup256" else 128)

        def fn(B):
            return dedup_spmm(dev, B)
    else:
        raise ValueError(f"unknown candidate {name!r}")
    return (fn, flops) if with_flops else fn
