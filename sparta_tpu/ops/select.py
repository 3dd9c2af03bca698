"""Kernel selection: one place that knows which blocked-SpMM path runs.

Candidates (each exists only where it can run):
- ``triton``: the blocked Pallas kernel (ops/blocked.py), where
  ``spmm_route`` sends the block shape to it (the GPU);
- ``xla``: the plain gather + batched dot (``bell_spmm_xla``);
- ``dense``: densify A once and run one GEMM (cuBLAS on the GPU), when the
  dense A fits in a quarter of device memory.

On the GPU the winner is MEASURED (autotune) and cached on disk, keyed by
the structure; elsewhere, and with ``autotune=False``, a fixed rule picks:
dense when every block is present, else the routed blocked path.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..definitions import to_device
from ..formats.bell import BELL
from .bell_xla import bell_spmm_xla
from .blocked import bell_spmm_triton, spmm_route
from .device import BellDevice


def auto_tile_n(n: int) -> int:
    """Largest of (512, 256, 128) dividing ``n``: the operand-width rule the
    CLI's legacy backends pad to."""
    for t in (512, 256, 128):
        if n % t == 0:
            return t
    raise ValueError(f"N={n} is not a multiple of 128; pad the operand first")


def densify_bytes_cap() -> int:
    """Largest dense A a plan may materialize: a quarter of the device's
    memory (host memory on the CPU backend), leaving room for B, C and the
    other candidates that autotune builds beside it."""
    stats = jax.devices()[0].memory_stats() or {}
    total = stats.get("bytes_limit") or (
        os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))
    return int(total) // 4


@dataclasses.dataclass(frozen=True)
class SpmmPlan:
    """A ready-to-call SpMM: ``fn(B) -> C`` with B [K, N] (padded to the
    bell's padded K; see ``pad_b_for_bell``) and C [nbr*bh, N] in the
    bell's (permuted) row order."""

    fn: Callable
    backend: str

    def __call__(self, B):
        return self.fn(B)


def _candidates(bell: BELL, dtype) -> list[str]:
    kinds = []
    if spmm_route(bell.block_row_size, bell.block_col_size) == "triton":
        kinds.append("triton")
    kinds.append("xla")
    M, K = bell.shape
    if M * K * jnp.dtype(dtype).itemsize <= densify_bytes_cap():
        kinds.append("dense")
    return kinds


def _rule(bell: BELL, kinds: list[str]) -> str:
    full = bell.total_nzblocks == bell.n_block_rows * bell.n_block_cols
    if full and "dense" in kinds:
        return "dense"  # a full block grid is a dense GEMM plus overhead
    return kinds[0]


def _build_plan(bell: BELL, kind: str, dtype) -> SpmmPlan:
    if kind == "dense":
        A = to_device(bell.to_dense_permuted(), dtype)
        return SpmmPlan(
            lambda B: jnp.dot(A, B, preferred_element_type=jnp.float32)
            .astype(B.dtype), "bell_densified_gemm")
    dev = BellDevice.from_host(bell, dtype=dtype)
    if kind == "triton":
        return SpmmPlan(lambda B: bell_spmm_triton(dev, B), "bell_triton")
    return SpmmPlan(lambda B: bell_spmm_xla(dev, B), "bell_xla")


# ---- persistent autotune cache ------------------------------------------
# Measured winners keyed by (structure fingerprint, N, dtype, device kind,
# kernel version); serving workloads rebuild identical plans every process
# start, so caching the measurement amortizes autotune to once per
# structure.  Bump _AUTOTUNE_VERSION when kernel behavior changes.
_AUTOTUNE_VERSION = 2


def _autotune_cache_path():
    from pathlib import Path

    from ..runtime import REPO_ROOT

    p = os.environ.get("SPARTA_TPU_AUTOTUNE_CACHE")
    if p == "0":
        return None
    return Path(p) if p else REPO_ROOT / ".cache" / "autotune.json"


def _autotune_key(bell: BELL, N: int, dtype) -> str:
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(bell.nb_row, np.int64).tobytes())
    h.update(np.asarray(bell.cols_idx, np.int64).tobytes())
    for v in (*bell.shape, bell.block_row_size, bell.block_col_size, N,
              _AUTOTUNE_VERSION):
        h.update(int(v).to_bytes(8, "little", signed=True))
    h.update(str(jnp.dtype(dtype)).encode())
    h.update(jax.devices()[0].device_kind.encode())
    return h.hexdigest()


def _autotune_cache_get(key: str):
    path = _autotune_cache_path()
    if path is None or not path.exists():
        return None
    try:
        import json

        return json.loads(path.read_text()).get(key)
    except Exception:  # noqa: BLE001 — a corrupt cache is a miss
        return None


def _autotune_cache_put(key: str, entry: dict) -> None:
    path = _autotune_cache_path()
    if path is None:
        return
    try:
        import json

        path.parent.mkdir(parents=True, exist_ok=True)
        data = {}
        if path.exists():
            try:
                data = json.loads(path.read_text())
            except Exception:  # noqa: BLE001
                data = {}
        data[key] = entry
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(data))
        tmp.replace(path)
    except Exception:  # noqa: BLE001 — cache writes are best-effort
        pass


def plan_spmm(bell: BELL, N: int, dtype=jnp.float32,
              autotune: bool | None = None) -> SpmmPlan:
    """Pick the fastest device path for this blocked matrix and operand
    width ``N``.

    ``autotune`` (default: on when JAX's device is a GPU) MEASURES every
    candidate on a random operand and returns the winner.  Winners persist
    in an on-disk cache keyed by the structure fingerprint
    (``<repo>/.cache/autotune.json``; override with
    ``SPARTA_TPU_AUTOTUNE_CACHE=<path>``, disable with ``=0``), so a process
    that rebuilds the same plan pays the measurement once."""
    kinds = _candidates(bell, dtype)
    if autotune is None:
        autotune = jax.default_backend() == "gpu"
    if not autotune or len(kinds) == 1:
        return _build_plan(bell, _rule(bell, kinds), dtype)

    key = _autotune_key(bell, N, dtype)
    hit = _autotune_cache_get(key)
    if hit is not None and hit.get("kind") in kinds:
        return _build_plan(bell, hit["kind"], dtype)

    from ..bench.timing import time_op

    B = jnp.asarray(np.random.default_rng(0).standard_normal(
        (bell.shape[1], N)).astype(np.float32), dtype=dtype)
    best = None
    for kind in kinds:
        plan = _build_plan(bell, kind, dtype)
        avg, _, _ = time_op(plan.fn, B, warmup=1, reps=3)
        if best is None or avg < best[0]:
            best = (avg, plan, kind)
        del plan
    _autotune_cache_put(key, {"kind": best[2], "ms": best[0] * 1e3})
    return best[1]
