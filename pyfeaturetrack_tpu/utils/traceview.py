"""Profiler-trace analysis: device time of a callable from a jax.profiler
trace.

This module captures a trace around a callable and reduces it to the
numbers that matter: device-lane busy time, per-call module time, op
count, and the top ops — so benches can report *device time per frame*
beside host-clock rates.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import tempfile

import jax


def capture_device_trace(fn, n_calls: int = 10, trace_dir: str | None
                         = None) -> dict:
    """Run ``fn()`` ``n_calls`` times under jax.profiler.trace and parse
    the device lane.

    ``fn`` must dispatch device work and depend on its own previous
    output if per-call timing should reflect serialized execution (an
    independent fn measures the same thing on a single device anyway).
    Returns a dict with device_busy_ms, per_call_ms, op_events,
    ops_per_call, top_ops [(name, total_ms)], n_calls.
    """
    d = trace_dir or tempfile.mkdtemp(prefix="pft_trace_")
    with jax.profiler.trace(d):
        out = None
        for _ in range(n_calls):
            out = fn()
        jax.block_until_ready(out)
    return parse_device_trace(d, n_calls=n_calls)


def parse_device_trace(trace_dir: str, n_calls: int = 1) -> dict:
    """Parse the newest trace.json.gz under ``trace_dir``.

    Busy time is the INTERVAL UNION of the device-lane op events, not
    the sum of durations: control-flow ops (``cond.*``/``while.*``) are
    logged as container events that SPAN their branch's member ops
    so a plain sum double-counts every cond/while interior. The union is
    the "device was busy" clock; ``sum_durations_ms`` keeps the plain
    (overcounting) sum beside it.
    """
    files = sorted(glob.glob(os.path.join(
        trace_dir, "**", "*.trace.json.gz"), recursive=True))
    if not files:
        raise FileNotFoundError(
            f"(traceview) no trace.json.gz under {trace_dir}")
    with gzip.open(files[-1]) as f:
        tr = json.load(f)
    ev = tr.get("traceEvents", [])
    lanes = {}
    for e in ev:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            lanes[e["pid"]] = e["args"].get("name", "")
    device_pids = {p for p, name in lanes.items()
                   if "GPU" in name or "device" in name.lower()}
    total_us = 0.0
    n_op_events = 0
    n_module_events = 0
    by_name: collections.Counter = collections.Counter()
    intervals: dict = collections.defaultdict(list)
    t_min, t_max = None, None
    for e in ev:
        if e.get("ph") == "X" and e.get("pid") in device_pids:
            dur = float(e.get("dur", 0.0))
            name = e["name"]
            by_name[name] += dur
            # module-level events (jit_<name>) span their member ops —
            # keep them out of busy time (double counting) but report
            # them as per-call module time
            if name.startswith("jit_"):
                n_module_events += 1
            else:
                total_us += dur
                n_op_events += 1
                ts = float(e.get("ts", 0.0))
                intervals[e["pid"]].append((ts, ts + dur))
                t_min = ts if t_min is None else min(t_min, ts)
                t_max = max(t_max or 0.0, ts + dur)
    union_us = 0.0
    for iv in intervals.values():
        iv.sort()
        cs, ce = iv[0]
        for s, t in iv[1:]:
            if s > ce:
                union_us += ce - cs
                cs, ce = s, t
            else:
                ce = max(ce, t)
        union_us += ce - cs
    modules = {k: v for k, v in by_name.items() if k.startswith("jit_")}
    return {
        "n_calls": n_calls,
        "device_busy_ms": round(union_us / 1e3, 3),
        "per_call_ms": round(union_us / 1e3 / max(n_calls, 1), 3),
        "sum_durations_ms": round(total_us / 1e3, 3),
        "op_events": n_op_events,
        "ops_per_call": n_op_events // max(n_calls, 1),
        "module_events": n_module_events,
        "module_events_ms": {k: round(v / 1e3, 3)
                             for k, v in sorted(modules.items(),
                                                key=lambda kv: -kv[1])},
        "span_ms": round(((t_max - t_min) / 1e3) if t_min is not None
                         else 0.0, 3),
        "top_ops": [(k, round(v / 1e3, 3)) for k, v in
                    by_name.most_common(8) if not k.startswith("jit_")],
    }
