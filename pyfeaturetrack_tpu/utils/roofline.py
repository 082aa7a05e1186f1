"""Roofline / speed-of-light accounting for the hot stages.

This module turns measured stage times into achieved fractions of the
card's published peaks.

Counting model: per stage we compute the ALGORITHMIC lower bound on
device-memory traffic (each logical array read once + each output
written once, with XLA assumed to fuse elementwise/conv chains) and the
arithmetic FLOPs of the math as written. Speed-of-light time =
max(bytes / memory bandwidth, flops / peak flops); achieved fraction =
SOL time / measured time. Because the traffic number is a lower bound,
the reported fraction is conservative (true utilization >= reported).

Peaks come from one table keyed by JAX's ``device_kind``; a device that
is not in it is an error, never a default. Run standalone on the card:

    python -m pyfeaturetrack_tpu.utils.roofline        # prints JSON
"""

from __future__ import annotations

import json

import numpy as np

# Published peaks per device_kind. H100 SXM: NVIDIA H100 Tensor Core GPU
# data sheet (dense rates, no sparsity, at the full 700 W power limit);
# NVLink 900 GB/s total to the other cards, 450 GB/s each way.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "source": "NVIDIA H100 SXM data sheet",
        "hbm_bytes_per_s": 3.35e12,
        "f32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "link_bytes_per_s": 450e9,
    },
}


def peaks_for(device_kind: str) -> dict:
    """Published peaks of ``device_kind``; raises KeyError for a device
    the table does not hold."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"(roofline) no published peaks for device_kind "
            f"{device_kind!r}; known: {sorted(PEAKS)}") from None


_F32 = 4  # bytes


def _kernel_width(sigma: float) -> int:
    """Trimmed Gaussian width (ops/kernels.py semantics: symmetric trim
    of taps below 1%% of the max, factor 0.01 both kernels)."""
    hw = 71 // 2
    xs = np.arange(-hw, hw + 1, dtype=np.float64)
    g = np.exp(-xs * xs / (2.0 * sigma * sigma))
    keep = g >= 0.01 * g.max()
    return int(keep.sum())


def pyramid_counts(h: int, w: int, cfg) -> dict:
    """Per-frame pyramid build: smooth + per-level images + gradients."""
    ks = _kernel_width(cfg.smooth_sigma)
    kg = _kernel_width(cfg.grad_sigma)
    kp = _kernel_width(cfg.pyramid_sigma_fact * cfg.subsampling)

    bytes_total = 0.0
    flops = 0.0
    lh, lw = h, w
    for level in range(cfg.nPyramidLevels):
        px = lh * lw
        if level == 0:
            # read raw frame; write smoothed level-0 image
            bytes_total += 2 * px * _F32
            flops += 2 * 2 * ks * px          # separable smooth (2 passes)
        else:
            # read previous level, smooth + decimate, write level image
            prev = (lh * cfg.subsampling) * (lw * cfg.subsampling)
            bytes_total += (prev + px) * _F32
            flops += 2 * 2 * kp * prev
        # gradients: read level image once (fused dx+dy), write gx + gy
        bytes_total += 3 * px * _F32
        flops += 2 * (2 * 2 * kg) * px        # two separable conv pairs
        lh //= cfg.subsampling
        lw //= cfg.subsampling
    return {"bytes": bytes_total, "flops": flops}


def lk_counts(h: int, w: int, n_features: int, cfg) -> dict:
    """Batched pyramidal LK for one frame step (all levels, worst-case
    fixed-trip iterations — matching the compiled program, which always
    runs max_iterations with lane masking)."""
    ph = cfg.window_height // 2 * 2 + 2      # gathered patch edge (h+1)
    pw = cfg.window_width // 2 * 2 + 2
    patch = ph * pw
    win = cfg.window_height * cfg.window_width
    it = cfg.max_iterations
    levels = cfg.nPyramidLevels

    # per level: 1 hoisted 3-patch gather (frame 1) + per iteration a
    # 3-patch gather (frame 2) + final residue 1-patch gather
    gathers_per_level = 3 + 3 * it + 1
    bytes_total = levels * n_features * gathers_per_level * patch * _F32
    # blend (~8 flops/px/patch) + window reductions (5 sums x ~2 flops)
    flops = levels * n_features * (
        (3 + 3 * it + 1) * patch * 8 + it * win * 10)
    return {"bytes": float(bytes_total), "flops": float(flops)}


def flow_counts(h: int, w: int, cfg) -> dict:
    """Dense per-pixel LK flow for one frame pair (ops/flow.py): the
    lk_counts model with the feature set = each level's own pixel grid
    (dense flow re-grids per level; upsampling traffic is negligible
    next to the window gathers and is folded into the +1)."""
    ph = cfg.window_height // 2 * 2 + 2
    pw = cfg.window_width // 2 * 2 + 2
    patch = ph * pw
    win = cfg.window_height * cfg.window_width
    it = cfg.max_iterations
    s = cfg.subsampling
    bytes_total = 0.0
    flops = 0.0
    for lvl in range(cfg.nPyramidLevels):
        n_px = (h // s**lvl) * (w // s**lvl)
        gathers = 3 + 3 * it + 1
        bytes_total += n_px * gathers * patch * _F32
        flops += n_px * (gathers * patch * 8 + it * win * 10)
    return {"bytes": float(bytes_total), "flops": float(flops)}


def affine_counts(n_features: int, cfg, h: int = 480, w: int = 640
                  ) -> dict:
    """Affine-consistency GN for one frame step (mode 2: 6-param).

    Bytes = compulsory device-memory traffic: the three image channels
    (img, gx, gy) and the per-feature templates are read once; the
    per-iteration warp gathers are assumed cache-served. FLOPs count
    every fixed-trip iteration, matching the compiled program."""
    t = cfg.affine_window_width * cfg.affine_window_height
    patch = (cfg.affine_window_width + 1) ** 2
    it = cfg.affine_max_iterations
    params = 6
    bytes_total = (3 * h * w + n_features * 3 * patch
                   + 4 * n_features) * _F32
    flops = n_features * it * (
        3 * patch * 8 + t * (params * 4 + params * params * 2)
        + params ** 3)
    return {"bytes": float(bytes_total), "flops": float(flops)}


def config4_counts(cfg=None, h: int = 1088, w: int = 1920,
                   n_features: int = 4096) -> dict:
    """Config-4 (1080p, 4096 features, 4 levels, subsampling 2) frame
    step: pyramid build + pyramidal LK, the algorithmic once-through
    lower bound (the same convention as the other stages)."""
    from ..config import create_config
    if cfg is None:
        cfg = create_config().replace(nPyramidLevels=4, subsampling=2)
    p = pyramid_counts(h, w, cfg)
    l = lk_counts(h, w, n_features, cfg)
    return {"bytes": p["bytes"] + l["bytes"],
            "flops": p["flops"] + l["flops"]}


def ba_iter_counts(C: int, L: int, kw: int) -> dict:
    """One windowed GN iteration (sfm/ba_windowed._gn_step_windowed)."""
    obs = L * kw
    # residuals/Jacobians ~300 flops/obs; U/V/W outer products
    # (72+18+36 MACs x2); S_blocks einsum L*kw^2*6*6*3*2
    flops = obs * (300 + 2 * (72 + 18 + 36) * 2) + L * kw * kw * 6 * 6 * 6
    # dominant traffic: per-obs Jacobian blocks written+read once
    bytes_total = obs * (2 * 6 + 2 * 3 + 6 * 3 + 6 * 6) * _F32 * 2
    return {"bytes": float(bytes_total), "flops": float(flops)}


def summarize(counts: dict, measured_s: float, device_kind: str,
              peak_flops_key: str = "f32_flops") -> dict:
    """Achieved fractions vs ``device_kind``'s published peaks for one
    stage."""
    peaks = peaks_for(device_kind)
    t_mem = counts["bytes"] / peaks["hbm_bytes_per_s"]
    t_cmp = counts["flops"] / peaks[peak_flops_key]
    sol = max(t_mem, t_cmp)
    return {
        "measured_us": round(measured_s * 1e6, 2),
        "sol_us": round(sol * 1e6, 2),
        "bound": "memory" if t_mem >= t_cmp else "compute",
        "achieved_fraction": round(sol / measured_s, 4),
        "hbm_gbytes_per_s": round(
            counts["bytes"] / measured_s / 1e9, 2),
        "gflops_per_s": round(counts["flops"] / measured_s / 1e9, 2),
        "bytes": counts["bytes"],
        "flops": counts["flops"],
    }


def measure_stage_times(h=480, w=640, n_features=1000, iters=200):
    """Time pyramid build / LK / affine / dense flow in isolation on the
    current backend (run this alone on the card — contention skews it)."""
    import time

    import jax
    import jax.numpy as jnp

    from ..config import create_config
    from ..ops.track import build_track_pyramids, track_features_pyramids

    cfg = create_config()
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (h, w)), jnp.float32)
    img2 = jnp.asarray(rng.uniform(0, 255, (h, w)), jnp.float32)
    x = jnp.asarray(rng.uniform(30, w - 30, n_features), jnp.float32)
    y = jnp.asarray(rng.uniform(30, h - 30, n_features), jnp.float32)
    val = jnp.ones((n_features,), jnp.int32)

    build = jax.jit(build_track_pyramids, static_argnames=("cfg",))
    p1 = build(img, cfg)
    p2 = build(img2, cfg)
    out = track_features_pyramids(p1, p2, x, y, val, cfg)
    jax.block_until_ready(out)

    t0 = time.perf_counter()
    for _ in range(iters):
        p2 = build(img2, cfg)
    jax.block_until_ready(p2)
    pyr_s = (time.perf_counter() - t0) / iters

    t0 = time.perf_counter()
    for _ in range(iters):
        out = track_features_pyramids(p1, p2, x, y, val, cfg)
    jax.block_until_ready(out)
    lk_s = (time.perf_counter() - t0) / iters

    # affine stage (mode 2), batched over the same feature count
    from ..ops.affine import _affine_track_batch
    from ..ops.interp import gather_window
    acfg = create_config(affineConsistencyCheck=2)
    hw, hh = acfg.affine_window_width // 2, acfg.affine_window_height // 2
    tmpl = gather_window(p1.img[0], x, y, hw, hh)
    A0 = jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32),
                          (n_features, 2, 2))
    chk = jnp.ones((n_features,), bool)
    aff = _affine_track_batch(tmpl, p2.img[0], p2.gradx[0], p2.grady[0],
                              x, y, A0, chk, acfg)
    jax.block_until_ready(aff)
    t0 = time.perf_counter()
    for _ in range(max(iters // 4, 1)):
        aff = _affine_track_batch(tmpl, p2.img[0], p2.gradx[0],
                                  p2.grady[0], x, y, A0, chk, acfg)
    jax.block_until_ready(aff)
    aff_s = (time.perf_counter() - t0) / max(iters // 4, 1)

    # dense per-pixel flow (ops/flow.py) over the same prebuilt pyramids
    from ..ops.flow import dense_flow_pyramids
    fl = dense_flow_pyramids(p1, p2, cfg)
    jax.block_until_ready(fl)
    t0 = time.perf_counter()
    for _ in range(max(iters // 4, 1)):
        fl = dense_flow_pyramids(p1, p2, cfg)
    jax.block_until_ready(fl)
    flow_s = (time.perf_counter() - t0) / max(iters // 4, 1)

    return {"pyramid_s": pyr_s, "lk_s": lk_s, "affine_s": aff_s,
            "flow_s": flow_s}


def measure_stage_device_times(h=480, w=640, n_features=1000,
                               n_calls=8) -> dict:
    """Stage times from the profiler device lane (utils/traceview).
    Returns seconds per call per stage, plus op counts."""
    import jax
    import jax.numpy as jnp

    from ..config import create_config
    from ..ops.track import build_track_pyramids, track_features_pyramids
    from .traceview import capture_device_trace

    cfg = create_config()
    rng = np.random.default_rng(0)
    img2 = jnp.asarray(rng.uniform(0, 255, (h, w)), jnp.float32)
    x = jnp.asarray(rng.uniform(30, w - 30, n_features), jnp.float32)
    y = jnp.asarray(rng.uniform(30, h - 30, n_features), jnp.float32)
    val = jnp.ones((n_features,), jnp.int32)
    build = jax.jit(build_track_pyramids, static_argnames=("cfg",))
    p1 = build(img2, cfg)
    p2 = build(img2, cfg)
    out = track_features_pyramids(p1, p2, x, y, val, cfg)
    jax.block_until_ready(out)
    r_pyr = capture_device_trace(lambda: build(img2, cfg),
                                 n_calls=n_calls)
    r_lk = capture_device_trace(
        lambda: track_features_pyramids(p1, p2, x, y, val, cfg),
        n_calls=n_calls)
    from ..ops.flow import dense_flow_pyramids
    fl = dense_flow_pyramids(p1, p2, cfg)
    jax.block_until_ready(fl)
    r_fl = capture_device_trace(lambda: dense_flow_pyramids(p1, p2, cfg),
                                n_calls=max(n_calls // 2, 2))
    return {"pyramid_device_s": r_pyr["per_call_ms"] / 1e3,
            "pyramid_ops": r_pyr["ops_per_call"],
            "lk_device_s": r_lk["per_call_ms"] / 1e3,
            "lk_ops": r_lk["ops_per_call"],
            "flow_device_s": r_fl["per_call_ms"] / 1e3,
            "flow_ops": r_fl["ops_per_call"]}


def roofline_report(h=480, w=640, n_features=1000, stage_times=None,
                    ba_iter_s=None, ba_shape=(60, 6000, 12),
                    with_device_trace: bool = True) -> dict:
    """Assemble the roofline dict for the card JAX runs on. The
    summarize() rows use host-clock times fenced by block_until_ready;
    ``device_trace_stage_times`` adds the profiler device lane."""
    import jax

    from ..config import create_config
    cfg = create_config()
    kind = jax.devices()[0].device_kind
    peaks = peaks_for(kind)
    if stage_times is None:
        stage_times = measure_stage_times(h, w, n_features)
    rep = {
        "device_kind": kind,
        "peaks": {"source": peaks["source"],
                  "hbm_gbytes_per_s": peaks["hbm_bytes_per_s"] / 1e9,
                  "f32_tflops": peaks["f32_flops"] / 1e12,
                  "bf16_tflops": peaks["bf16_flops"] / 1e12},
        "pyramid_build": summarize(pyramid_counts(h, w, cfg),
                                   stage_times["pyramid_s"], kind),
        "lk_track": summarize(lk_counts(h, w, n_features, cfg),
                              stage_times["lk_s"], kind),
        "affine_check": summarize(
            affine_counts(n_features,
                          create_config(affineConsistencyCheck=2),
                          h=h, w=w),
            stage_times["affine_s"], kind),
    }
    if "flow_s" in stage_times:
        rep["dense_flow"] = summarize(flow_counts(h, w, cfg),
                                      stage_times["flow_s"], kind)
    c4 = config4_counts()
    rep["config4_1080p_sol_us"] = round(
        max(c4["bytes"] / peaks["hbm_bytes_per_s"],
            c4["flops"] / peaks["f32_flops"]) * 1e6, 1)
    if ba_iter_s is not None:
        C, L, kw = ba_shape
        rep["ba_iteration"] = summarize(ba_iter_counts(C, L, kw),
                                        ba_iter_s, kind)
    if with_device_trace:
        rep["device_trace_stage_times"] = measure_stage_device_times(
            h, w, n_features)
    return rep


if __name__ == "__main__":
    print(json.dumps(roofline_report(), indent=2))
