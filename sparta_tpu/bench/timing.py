"""Device timing: host clock around work that ends in ``block_until_ready``.

JAX returns before the device finishes, so every timed window ends with a
``block_until_ready`` on its last output.  A window runs ``inner`` calls
back to back (dispatch of call i+1 overlaps call i on the device), so one
window measures the device's steady rate rather than one dispatch's
latency; the per-call time is the window over ``inner``.
"""
from __future__ import annotations

import time
from typing import Callable

import jax
import numpy as np


def _window(fn: Callable, B, n: int):
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn(B)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n, out


def time_op(
    fn: Callable,
    B: jax.Array,
    warmup: int = 1,
    reps: int = 5,
    inner_iters: int | None = None,
    target_time: float = 0.05,
) -> tuple[float, float, object]:
    """Returns (median seconds per call, std across windows, last output).

    ``warmup`` calls (the first compiles) are not timed.  ``inner_iters``
    pins the calls per window; by default a window holds enough calls to
    last about ``target_time`` seconds."""
    out = None
    for _ in range(max(warmup, 1)):
        out = jax.block_until_ready(fn(B))
    if inner_iters:
        inner = max(int(inner_iters), 1)
    else:
        one, out = _window(fn, B, 1)
        inner = int(min(max(target_time / max(one, 1e-7), 1), 1000))
    per = []
    for _ in range(max(reps, 1)):
        t, out = _window(fn, B, inner)
        per.append(t)
    return float(np.median(per)), float(np.std(per)), out
