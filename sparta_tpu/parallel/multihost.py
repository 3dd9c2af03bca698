"""Multi-host runtime: jax.distributed bring-up + per-host partitioned
reordering.

The reference has no distributed code (SURVEY §2.7); this supplies the
north-star pieces: process-group initialization over DCN, and the
"per-host reordering" strategy — each host clusters only its own block-row
range (reordering is O(rows_local^2), so partitioning is also the
scalability answer for the blocking phase; quality degrades gracefully since
similarity structure is local to row ranges after a coarse shuffle).
"""
from __future__ import annotations

import numpy as np

from ..formats.csr import CSR
from ..reorder import BlockingEngine


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up jax.distributed (no-op on single process / managed envs that
    auto-detect)."""
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        # explicit coordinates: a failure here is a misconfiguration, not a
        # single-process environment — never degrade silently
        jax.distributed.initialize(**kwargs)
        if num_processes is not None and jax.process_count() != num_processes:
            raise RuntimeError(
                f"jax.distributed came up with {jax.process_count()} "
                f"processes, expected {num_processes}")
        return
    try:
        jax.distributed.initialize()
    except (RuntimeError, ValueError):
        pass  # already initialized or single-process auto-detect


def row_range_for_host(rows: int, host: int, n_hosts: int) -> tuple[int, int]:
    per = -(-rows // n_hosts)
    lo = min(host * per, rows)
    return lo, min(lo + per, rows)


def partitioned_reorder(
    cmat: CSR, engine: BlockingEngine, n_parts: int,
    part_id: int | None = None,
) -> np.ndarray:
    """Per-host (or per-part) reordering: each part clusters its own row
    range independently; group ids are offset so parts never merge.

    With part_id=None all parts run locally (single-host simulation of the
    multi-host flow; on a pod each host computes only its own slice and
    all-gathers the grouping).
    """
    rows = cmat.rows
    grouping = np.empty(rows, dtype=np.int64)
    parts = [part_id] if part_id is not None else range(n_parts)
    for p in parts:
        lo, hi = row_range_for_host(rows, p, n_parts)
        if hi <= lo:
            continue
        # slice the CSR rows [lo, hi)
        sub = CSR(
            indptr=(cmat.indptr[lo : hi + 1] - cmat.indptr[lo]).astype(np.int64),
            indices=cmat.indices[cmat.indptr[lo] : cmat.indptr[hi]],
            data=None if cmat.data is None
            else cmat.data[cmat.indptr[lo] : cmat.indptr[hi]],
            shape=(hi - lo, cmat.cols),
        )
        g = engine.get_grouping(sub)
        # offset so parts' group ids never collide, preserving part order
        grouping[lo:hi] = g + p * (2 * rows)
    return grouping if part_id is None else grouping[lo:hi]
