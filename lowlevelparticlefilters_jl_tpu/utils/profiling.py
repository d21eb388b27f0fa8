"""Tracing / profiling helpers.

The reference has no formal tracing subsystem (SURVEY.md §5) — its
equivalents are interactive particle debug plots and allocation-count
tests.  The instrumentation here:

- :func:`trace` — context manager around `jax.profiler.trace` producing a
  TensorBoard/Perfetto trace of compiled execution,
- :func:`annotate` — named `TraceAnnotation` regions that show up inside
  device traces (wrap e.g. one `forward_trajectory` call),
- :func:`step_timer` — host-side wall-clock timing of a jitted callable,
  synchronized with `block_until_ready` (median over repeats),
- the per-step callback hooks on `forward_trajectory`
  (pre/post correct/predict, trajectory.py) remain the in-graph
  observability mechanism, mirroring the reference's callback protocol
  (filtering.jl:270-281).
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace viewable in TensorBoard / Perfetto."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that appears in profiler traces."""
    return jax.profiler.TraceAnnotation(name)


def step_timer(fn: Callable, *args, repeats: int = 3, warmup: bool = True):
    """Median wall-clock seconds for one synchronized call of ``fn``."""
    if warmup:
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]
