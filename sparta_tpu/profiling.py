"""Tracing / profiling subsystem.

The replacement for the reference's NVTX ranges + cudaEvent timers
(include/cuda_utilities.h:11-36, TIMER_* macros):

- ``annotate(name)``: jax.profiler trace annotation context (shows up in
  captured XLA traces exactly like colored nvtx ranges);
- ``phase_timer``: accumulating host-side phase timers feeding the CSV's
  time_to_block/compare/merge columns;
- ``capture_trace(dir)``: wrap a region in a jax.profiler trace capture for
  offline analysis (tensorboard / xprof).
"""
from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def annotate(name: str):
    """Named range visible in device traces (nvtx PUSH/POP_RANGE analogue)."""
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Capture a profiler trace of the enclosed region."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class PhaseTimer:
    """Accumulating named phase timers (reference TIMER_DEF/START/STOP)."""

    def __init__(self):
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def us(self, name: str) -> float:
        return self.totals.get(name, 0.0) * 1e6
