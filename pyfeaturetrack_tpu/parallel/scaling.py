"""Multi-device scaling-efficiency harness.

This harness measures weak scaling of the batched two-frame tracking
step over the ``frame`` mesh axis: each device tracks its own frame
pair (B = n_devices), so perfect scaling keeps wall time flat as
devices double.

On real cards this measures interconnect/compiler overheads; on the
virtual CPU mesh it validates the harness and the sharded program (XLA
emulates the devices on host cores, so reported efficiency is not
hardware-meaningful there).
"""

from __future__ import annotations

import time

import jax
import numpy as np

from ..config import create_config
from .sharding import make_mesh, track_batch_sharded


def measure_scaling(device_counts=None, image_shape=(240, 320),
                    n_features: int = 256, iters: int = 10,
                    cfg=None) -> dict:
    """Weak-scaling sweep. Returns {n_devices: seconds_per_step} plus
    efficiency relative to the smallest count."""
    if cfg is None:
        cfg = create_config()
    devices = jax.devices()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32)
                         if d <= len(devices)]

    h, w = image_shape
    rng = np.random.default_rng(0)
    results = {}
    for d in device_counts:
        mesh = make_mesh(n_frame=d, n_feature=1, devices=devices[:d])
        imgs1 = rng.uniform(0, 255, (d, h, w)).astype(np.float32)
        imgs2 = np.roll(imgs1, 1, axis=-1)
        xs = rng.uniform(cfg.borderx + 1, w - cfg.borderx - 2,
                         (d, n_features)).astype(np.float32)
        ys = rng.uniform(cfg.bordery + 1, h - cfg.bordery - 2,
                         (d, n_features)).astype(np.float32)
        vals = np.ones((d, n_features), np.int32)

        with mesh:
            out = track_batch_sharded(imgs1, imgs2, xs, ys, vals, cfg, mesh)
            jax.block_until_ready(out)  # compile
            t0 = time.perf_counter()
            for _ in range(iters):
                out = track_batch_sharded(imgs1, imgs2, xs, ys, vals,
                                          cfg, mesh)
            jax.block_until_ready(out)
            results[d] = (time.perf_counter() - t0) / iters

    base = device_counts[0]
    efficiency = {d: results[base] / results[d] for d in device_counts}
    return {"seconds_per_step": results, "efficiency_vs_smallest": efficiency,
            "device_counts": device_counts}


def _cost(compiled) -> dict:
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    return dict(ca or {})


def _collective_bytes(hlo_text: str) -> dict:
    """Census of collective ops in compiled (SPMD-partitioned) HLO:
    op counts + the summed f32-element bytes of their result shapes
    (a lower bound on interconnect traffic per step)."""
    import re
    out = {}
    total = 0.0
    for kind in ("all-reduce", "all-gather", "reduce-scatter",
                 "collective-permute", "all-to-all"):
        n = 0
        b = 0.0
        for m in re.finditer(
                rf"= ((?:\([^)]*\)|\S+)) {re.escape(kind)}\(",
                hlo_text):
            n += 1
            for shape in re.findall(
                    r"(?:f64|f32|s32|u32|bf16|pred)\[([\d,]*)\]",
                    m.group(1)):
                dims = [int(x) for x in shape.split(",") if x]
                b += float(np.prod(dims) if dims else 1) * 4
        if n:
            out[kind] = {"count": n, "approx_bytes": b}
            total += b
    out["total_approx_bytes"] = total
    return out


def _predict_rows(lowered_by_count: dict, device_counts,
                  peaks: dict) -> dict:
    """Shared analysis: per-device cost + collective census + roofline
    step-time model + weak efficiency vs the smallest count."""
    rows = {}
    for d in device_counts:
        compiled = lowered_by_count[d].compile()
        ca = _cost(compiled)
        colls = _collective_bytes(compiled.as_text())
        flops = float(ca.get("flops", 0.0))
        byts = float(ca.get("bytes accessed", 0.0))
        t_comp = max(flops / peaks["f32_flops"],
                     byts / peaks["hbm_bytes_per_s"])
        t_link = colls["total_approx_bytes"] / peaks["link_bytes_per_s"]
        rows[d] = {
            "per_device_flops": flops,
            "per_device_bytes": byts,
            "collectives": colls,
            "model_step_s": t_comp + t_link,
        }
    base = rows[device_counts[0]]["model_step_s"]
    for d in device_counts:
        rows[d]["predicted_weak_efficiency"] = round(
            base / rows[d]["model_step_s"], 4) if rows[d][
                "model_step_s"] else 1.0
    return rows


def predict_scaling_efficiency(device_counts=None,
                               image_shape=(240, 320),
                               n_features: int = 256, cfg=None,
                               device_kind: str = "NVIDIA H100 80GB HBM3",
                               workload: str = "track") -> dict:
    """Scaling PREDICTION from the sharded HLO: virtual-mesh wall clocks
    validate only structure, but the compiled, SPMD-partitioned module's
    per-device FLOPs/bytes and its collective census are the same on a
    virtual mesh as on real cards, so per-device balance and link
    traffic can be reported without them. The step-time model divides
    by ``device_kind``'s published peaks (utils/roofline.PEAKS; an
    unknown kind raises).

    Weak scaling over the frame/stream mesh axis for one of three
    workloads:

    * ``track``        — the batched two-frame tracking step
                         (B = n_devices, frame axis sharded). Expected:
                         ZERO collectives, flat per-device work.
    * ``config4``      — the same step at the 1080p/4096-feature
                         4-level config (one full config-4 pair per
                         device) — the heaviest per-device program.
    * ``serving_tick`` — serving._step_batch (one lockstep camera
                         stream per device, replace-lost ON): the
                         multi-camera serving shape, including the
                         batch-wide cond-gated refill.

    For each device count: per-device FLOPs + HBM bytes from XLA cost
    analysis, a collective census from the partitioned HLO, a roofline
    step-time model t(d) = max(flops/peak, bytes/bw) + link_bytes/link_bw,
    and predicted weak-scaling efficiency t(min_d)/t(d). Any collective
    or per-device drift flags a sharding regression."""
    import functools

    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..utils.roofline import peaks_for
    from .sharding import FRAME_AXIS, _track_pair_batch

    peaks = peaks_for(device_kind)

    if workload == "config4":
        image_shape = (1088, 1920)
        n_features = 4096
        if cfg is None:
            cfg = create_config().replace(nPyramidLevels=4,
                                          subsampling=2)
    if cfg is None:
        cfg = create_config()
    devices = jax.devices()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8) if d <= len(devices)]
    h, w = image_shape
    f32 = np.float32

    lowered = {}
    for d in device_counts:
        mesh = make_mesh(n_frame=d, n_feature=1, devices=devices[:d])
        img_sh = NamedSharding(mesh, P(FRAME_AXIS, None, None))
        feat_sh = NamedSharding(mesh, P(FRAME_AXIS, None))

        def S(shape, dtype=f32, sh=None):
            return jax.ShapeDtypeStruct(shape, dtype, sharding=sh)

        if workload in ("track", "config4"):
            args = (S((d, h, w), sh=img_sh), S((d, h, w), sh=img_sh),
                    S((d, n_features), sh=feat_sh),
                    S((d, n_features), sh=feat_sh),
                    S((d, n_features), np.int32, sh=feat_sh))
            lowered[d] = jax.jit(functools.partial(
                _track_pair_batch, cfg=cfg)).lower(*args)
        elif workload == "serving_tick":
            from ..ops.track import TrackPyramids, build_track_pyramids
            from ..serving import _step_batch
            scfg = cfg.replace(sequentialMode=True).validated_window()
            # pyramid structure for one stream, batched over the mesh
            proto = jax.eval_shape(
                functools.partial(build_track_pyramids, cfg=scfg),
                jax.ShapeDtypeStruct((h, w), f32))
            pyr = jax.tree.map(
                lambda a: S((d,) + a.shape, a.dtype, sh=img_sh), proto)
            lowered[d] = _step_batch.lower(
                pyr, (S((d, h, w), sh=img_sh),),
                S((d, n_features), sh=feat_sh),
                S((d, n_features), sh=feat_sh),
                S((d, n_features), np.int32, sh=feat_sh),
                scfg, True, 64, None, n_steps=1, stream_mesh=mesh)
        else:
            raise ValueError(f"unknown workload {workload!r}")
    rows = _predict_rows(lowered, device_counts, peaks)
    return {"workload": workload, "device_counts": device_counts,
            "per_device": rows,
            "device_kind": device_kind,
            "note": "per-device cost analysis + collective census of "
                    "the SPMD-partitioned HLO; identical on virtual "
                    "and real meshes (the peaks are data-sheet "
                    "figures)"}
