"""Trace parsing (utils/traceview.py) — synthetic chrome-trace fixture
plus a live capture on the test backend."""

import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyfeaturetrack_tpu.utils.traceview import (capture_device_trace,
                                                parse_device_trace)


def _write_trace(tmp_path, events):
    d = tmp_path / "plugins" / "profile" / "run1"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    return tmp_path


def test_parse_synthetic_trace(tmp_path):
    ev = [
        {"ph": "M", "pid": 3, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "pid": 9, "name": "process_name",
         "args": {"name": "/host:CPU"}},
        # two calls of a module with two ops each
        {"ph": "X", "pid": 3, "name": "jit_step(123)", "ts": 0,
         "dur": 100.0},
        {"ph": "X", "pid": 3, "name": "fusion.1", "ts": 0, "dur": 60.0},
        {"ph": "X", "pid": 3, "name": "while.2", "ts": 60, "dur": 40.0},
        {"ph": "X", "pid": 3, "name": "jit_step(123)", "ts": 100,
         "dur": 100.0},
        {"ph": "X", "pid": 3, "name": "fusion.1", "ts": 100, "dur": 55.0},
        {"ph": "X", "pid": 3, "name": "while.2", "ts": 155, "dur": 45.0},
        # host-lane noise must be ignored
        {"ph": "X", "pid": 9, "name": "python", "ts": 0, "dur": 9999.0},
    ]
    r = parse_device_trace(str(_write_trace(tmp_path, ev)), n_calls=2)
    assert r["device_busy_ms"] == pytest.approx(0.2)
    assert r["per_call_ms"] == pytest.approx(0.1)
    assert r["ops_per_call"] == 2
    assert r["module_events"] == 2
    assert list(r["module_events_ms"]) == ["jit_step(123)"]
    assert r["module_events_ms"]["jit_step(123)"] == pytest.approx(0.2)
    top = dict(r["top_ops"])
    assert top["fusion.1"] == pytest.approx(0.115)
    assert "jit_step(123)" not in top


def test_parse_nested_container_not_double_counted(tmp_path):
    """Control-flow ops (cond/while) are logged as container events
    spanning their branch's member ops. Busy time must be the interval
    UNION, not the sum of durations."""
    ev = [
        {"ph": "M", "pid": 3, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        {"ph": "X", "pid": 3, "name": "fusion.1", "ts": 0, "dur": 50.0},
        # a cond container spanning two member ops
        {"ph": "X", "pid": 3, "name": "cond.65", "ts": 50, "dur": 100.0},
        {"ph": "X", "pid": 3, "name": "sort.2", "ts": 55, "dur": 60.0},
        {"ph": "X", "pid": 3, "name": "fusion.2", "ts": 120, "dur": 25.0},
    ]
    r = parse_device_trace(str(_write_trace(tmp_path, ev)), n_calls=1)
    # union = [0, 150] = 150 us; the naive sum would be 235 us
    assert r["device_busy_ms"] == pytest.approx(0.15)
    assert r["sum_durations_ms"] == pytest.approx(0.235)


def test_parse_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        parse_device_trace(str(tmp_path))


def test_capture_runs_on_test_backend(tmp_path):
    """Live capture: the CPU test backend has no device lane, so counts
    may be zero — the contract is 'returns a well-formed dict without
    raising' (device-lane numbers are asserted in the synthetic test)."""
    a = jnp.asarray(np.random.default_rng(0).standard_normal((64, 64)),
                    jnp.float32)
    f = jax.jit(lambda m: jnp.tanh(m @ m))
    jax.block_until_ready(f(a))
    r = capture_device_trace(lambda: f(a), n_calls=3,
                             trace_dir=str(tmp_path))
    assert set(r) >= {"device_busy_ms", "per_call_ms", "ops_per_call",
                      "top_ops"}
    assert r["n_calls"] == 3
