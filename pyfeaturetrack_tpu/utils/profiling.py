"""Tracing / profiling helpers.

SURVEY.md section 5.1: the reference's only observability is verbose
prints; here the per-stage compute is wrapped in ``jax.named_scope`` (so
device traces group by pipeline stage) and a trace context manager drives
``jax.profiler`` collection around a region of frames.
"""

from __future__ import annotations

import contextlib
import time

import jax

named_scope = jax.named_scope


@contextlib.contextmanager
def trace(log_dir: str):
    """Collect a jax.profiler device trace into ``log_dir``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_jitted(fn, *args, iters: int = 50, warmup: int = 3) -> float:
    """Simple wall-clock of a jitted callable (seconds/call), compile
    excluded, fenced with block_until_ready. For device time alone use
    :func:`device_time_per_call`."""
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def device_time_per_call(fn, *args, iters: int = 8) -> float:
    """Profiler-device-lane seconds per call of a jitted callable (see
    utils/traceview)."""
    from .traceview import capture_device_trace
    out = fn(*args)
    jax.block_until_ready(out)
    r = capture_device_trace(lambda: fn(*args), n_calls=iters)
    return r["per_call_ms"] / 1e3
