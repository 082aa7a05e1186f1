"""Throughput runs of the BASELINE.md configs on one GPU.

The default run prints the card line (``nvidia-smi`` name and power
limit) and then ONE JSON line: frames/s of the sequential per-frame step
tracking 1000 features at 480x640, with the device it ran on. ``--all``
adds the other BASELINE configs as one JSON object on stderr. Every time
is a host-clock interval that ends in ``block_until_ready``. The run
refuses to start without a GPU.

Per-frame work is the sequential-mode cost: build the NEW frame's
pyramid + gradients, then batched pyramidal LK for all features (the
previous frame's pyramids are the cached state).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

# bench.py may run from any directory: pin the repo dir for imports.
_REPO = os.path.dirname(os.path.abspath(__file__))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def _textured(h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h + 8, w + 8))
    k = np.array([1.0, 4, 6, 4, 1]) / 16.0
    for axis in (0, 1):
        img = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), axis, img)
    return img


def bench_tracking(h, w, n_features, cfg, n_frames=50, warmup=5):
    """frames/s for the sequential per-frame step at the given config."""
    import jax
    import jax.numpy as jnp
    from pyfeaturetrack_tpu.ops.track import (build_track_pyramids,
                                              track_features_pyramids)

    @jax.jit
    def frame_step(pyr_prev, img_new, x, y, val):
        pyr_new = build_track_pyramids(img_new, cfg)
        out = track_features_pyramids(pyr_prev, pyr_new, x, y, val, cfg)
        return pyr_new, out

    base = _textured(h, w)
    frames = [jnp.asarray(base[i % 4:i % 4 + h, i % 4:i % 4 + w],
                          jnp.float32) for i in range(4)]
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(cfg.borderx + 1, w - cfg.borderx - 2,
                                n_features), jnp.float32)
    y = jnp.asarray(rng.uniform(cfg.bordery + 1, h - cfg.bordery - 2,
                                n_features), jnp.float32)
    val = jnp.ones((n_features,), jnp.int32)

    pyr = jax.jit(build_track_pyramids, static_argnames=('cfg',))(
        frames[0], cfg)
    for i in range(warmup):
        pyr2, out = frame_step(pyr, frames[(i + 1) % 4], x, y, val)
    jax.block_until_ready(out)

    t0 = time.perf_counter()
    cur = pyr
    for i in range(n_frames):
        cur, out = frame_step(cur, frames[(i + 1) % 4], x, y, val)
    jax.block_until_ready(out)
    return n_frames / (time.perf_counter() - t0)


def _repeat(fn, n=5, warmup=1):
    """Run ``fn`` warmup+n times; report median/min/max of the last n.
    The warmup calls are discarded: they pay jit compilation and first
    execution."""
    for _ in range(warmup):
        fn()
    vals = [float(fn()) for _ in range(n)]
    return {"median": round(float(np.median(vals)), 2),
            "min": round(float(np.min(vals)), 2),
            "max": round(float(np.max(vals)), 2), "n": n}


def bench_sequence_replace(h=480, w=640, n_features=1000, n_frames=48,
                           shift=2, chain=1):
    """BASELINE config 2: the example3-shaped sequence loop WITH per-frame
    lost-feature replacement, fully device-resident (ops.select_device) —
    frames/s including the replace stage. The texture ping-pongs
    horizontally so a steady trickle of features drifts out of the border
    band and must be refilled. ``chain`` > 1 uses the micro-chained
    driver (k frames per dispatched program)."""
    import jax
    import jax.numpy as jnp
    from pyfeaturetrack_tpu.config import create_config
    from pyfeaturetrack_tpu.models.device_sequence import (
        select_step_device, sequence_chain_device, sequence_step_device)

    cfg = create_config().replace(sequentialMode=True).validated_window()
    base = _textured(h, w, seed=4)[:h, :w]
    n_cycle = 16
    cyc = [jnp.asarray(np.roll(base, shift * i, axis=1).astype(np.float32))
           for i in range(n_cycle)]
    frames = cyc + cyc[-2:0:-1]  # ping-pong: steps stay +-shift px

    def advance(pyr, i, x, y, val):
        if chain == 1:
            out = sequence_step_device(
                pyr, frames[i % len(frames)], x, y, val, cfg, True)
            return out[0], out[1], out[2], out[3]
        imgs = tuple(frames[(i + j) % len(frames)] for j in range(chain))
        pyr, _, (fx, fy, fv), _, _ = sequence_chain_device(
            pyr, imgs, x, y, val, cfg, True)
        return pyr, fx, fy, fv

    pyr, x, y, val, _, _ = select_step_device(frames[0], cfg, n_features)
    for i in range(1, 1 + 2 * chain, chain):  # warm cond branches
        pyr, x, y, val = advance(pyr, i, x, y, val)
    jax.block_until_ready(val)

    t0 = time.perf_counter()
    for i in range(0, n_frames, chain):
        pyr, x, y, val = advance(pyr, 6 + i, x, y, val)
    jax.block_until_ready(val)
    return n_frames / (time.perf_counter() - t0)


def bench_serving(h=480, w=640, n_features=1000, n_frames=48, chain=8,
                  prefetch=0, stage_uint8=True, warmed=[]):
    """Live-video ingestion: frames start HOST-side and the timed loop
    covers h2d staging + tracking with replace-lost (serving.py). The
    uint8-vs-float32 A/B exposes the host-link bytes (4x); prefetch=0
    is the shipped default (JAX async dispatch already overlaps h2d)."""
    import jax
    import jax.numpy as jnp
    from pyfeaturetrack_tpu.config import create_config
    from pyfeaturetrack_tpu.serving import StreamingTracker, prefetch_to_device

    cfg = create_config().replace(sequentialMode=True).validated_window()
    base = _textured(h, w, seed=4)[:h, :w]
    n_cycle = 16
    cyc = [np.roll(base, 2 * i, axis=1).astype(np.uint8)
           for i in range(n_cycle)]
    host_frames = cyc + cyc[-2:0:-1]

    def run_once():
        tr = StreamingTracker(cfg, n_features, replace_lost=True,
                              chain=chain)
        src = (host_frames[i % len(host_frames)] for i in range(n_frames))
        it = (prefetch_to_device(
                  src, depth=prefetch,
                  stage_dtype=np.uint8 if stage_uint8 else np.float32)
              if prefetch > 0 else
              (jnp.asarray(np.asarray(
                   f, np.uint8 if stage_uint8 else np.float32))
               for f in src))
        for fr in it:
            tr.feed(fr)
        tr.block()

    key = (chain, prefetch, stage_uint8)
    if key not in warmed:  # one unmeasured pass to absorb compiles
        warmed.append(key)
        run_once()
    t0 = time.perf_counter()
    run_once()
    return n_frames / (time.perf_counter() - t0)


def bench_batched_chain(h=480, w=640, n_features=1000, n_streams=8,
                        chain=8, n_prog=6):
    """Peak aggregate: chain frames per program x n_streams lockstep
    streams, REPLACE-LOST ON (full example3 semantics). Compute-side:
    frames pre-staged on device; one program advances every stream by
    ``chain`` frames over the vmapped stream axis. Returns aggregate
    frames/s."""
    import jax
    import jax.numpy as jnp
    from pyfeaturetrack_tpu.config import create_config
    from pyfeaturetrack_tpu.serving import _select_batch, _step_batch

    cfg = create_config().replace(sequentialMode=True).validated_window()
    bases = [np.floor(_textured(h, w, seed=10 + b)[:h, :w])
             for b in range(n_streams)]
    ticks = [jnp.asarray(np.stack([np.roll(bases[b], 2 * i, axis=1)
                                   for b in range(n_streams)]
                                  ).astype(np.float32))
             for i in range(chain)]
    pyr, x, y, val, aff, _ = _select_batch(ticks[0], cfg, n_features, 512)
    out = _step_batch(pyr, tuple(ticks), x, y, val, cfg, True, 512, aff,
                      n_steps=chain)
    jax.block_until_ready(out[2])
    t0 = time.perf_counter()
    for _ in range(n_prog):
        out = _step_batch(pyr, tuple(ticks), x, y, val, cfg, True, 512,
                          aff, n_steps=chain)
    jax.block_until_ready(out[2])
    return n_prog * chain * n_streams / (time.perf_counter() - t0)


def bench_serving_batched(h=480, w=640, n_features=1000, n_streams=8,
                          n_ticks=12, chain=4, warmed=[]):
    """Multi-camera serving: n_streams live uint8 feeds advanced in
    lockstep (BatchedStreamingTracker), h2d staging inside the timed
    loop. Returns AGGREGATE frames/s across streams."""
    import jax
    from pyfeaturetrack_tpu.config import create_config
    from pyfeaturetrack_tpu.serving import BatchedStreamingTracker

    cfg = create_config().replace(sequentialMode=True).validated_window()
    bases = [np.floor(_textured(h, w, seed=10 + b)[:h, :w])
             for b in range(n_streams)]
    ticks = [np.stack([np.roll(bases[b], 2 * i, axis=1)
                       for b in range(n_streams)]).astype(np.uint8)
             for i in range(16)]

    def run_once():
        bt = BatchedStreamingTracker(cfg, n_streams=n_streams,
                                     n_features=n_features, chain=chain)
        for i in range(n_ticks):
            bt.feed(ticks[i % len(ticks)])
        bt.block()

    key = (h, w, n_features, n_streams, chain)
    if key not in warmed:  # one unmeasured pass per config (compiles)
        warmed.append(key)
        run_once()
    t0 = time.perf_counter()
    run_once()
    return n_ticks * n_streams / (time.perf_counter() - t0)


def bench_dense_flow(h=480, w=640, n_frames=20, warmup=3):
    """Dense per-pixel KLT flow frames/s for the sequential per-frame
    step: build the new frame's pyramid, dense flow vs the cached
    previous pyramid (each frame tracks all h*w pixels)."""
    import jax
    import jax.numpy as jnp
    from pyfeaturetrack_tpu.config import create_config
    from pyfeaturetrack_tpu.ops.flow import dense_flow_pyramids
    from pyfeaturetrack_tpu.ops.track import build_track_pyramids

    cfg = create_config()

    @jax.jit
    def frame_step(pyr_prev, img_new):
        pyr_new = build_track_pyramids(img_new, cfg)
        return pyr_new, dense_flow_pyramids(pyr_prev, pyr_new, cfg)

    base = _textured(h, w)
    frames = [jnp.asarray(base[i % 4:i % 4 + h, i % 4:i % 4 + w],
                          jnp.float32) for i in range(4)]
    pyr = jax.jit(build_track_pyramids, static_argnames=("cfg",))(
        frames[0], cfg)
    for i in range(warmup):
        pyr2, fl = frame_step(pyr, frames[(i + 1) % 4])
    jax.block_until_ready(fl)

    t0 = time.perf_counter()
    cur = pyr
    for i in range(n_frames):
        cur, fl = frame_step(cur, frames[(i + 1) % 4])
    jax.block_until_ready(fl)
    fps = n_frames / (time.perf_counter() - t0)
    return fps


def bench_dense_flow_batched(h=240, w=320, batch=4, n_steps=6, warmup=2):
    """Aggregate dense-flow frames/s for ``batch`` lockstep camera
    streams in ONE vmapped program per step (ops/flow.dense_flow_batched
    — the dense analogue of the batched8 sparse config)."""
    import jax
    import jax.numpy as jnp
    from pyfeaturetrack_tpu.config import create_config
    from pyfeaturetrack_tpu.ops.flow import dense_flow_batched

    cfg = create_config()
    base = _textured(h, w)
    stack = [jnp.stack([jnp.asarray(
        base[(i + b) % 4:(i + b) % 4 + h, (i + b) % 4:(i + b) % 4 + w],
        jnp.float32) for b in range(batch)]) for i in range(3)]
    for i in range(warmup):
        fl = dense_flow_batched(stack[i % 2], stack[(i + 1) % 3], cfg)
    jax.block_until_ready(fl)
    t0 = time.perf_counter()
    for i in range(n_steps):
        fl = dense_flow_batched(stack[i % 2], stack[(i + 1) % 3], cfg)
    jax.block_until_ready(fl)
    return batch * n_steps / (time.perf_counter() - t0)


def bench_two_frame_demo():
    """Config 1: the stock example1 flow (select 100 + track), end to end
    host-to-host, seconds per run."""
    import pyfeaturetrack_tpu as pft
    img1 = np.floor(_textured(240, 320, seed=1)[:240, :320])
    img2 = np.floor(_textured(240, 320, seed=1)[1:241, 1:321])
    cfg = pft.create_config()
    # warm
    fl = pft.KLTSelectGoodFeatures(cfg, img1, 100)
    fl2, _ = pft.KLTTrackFeatures(cfg, img1, img2, fl)
    t0 = time.perf_counter()
    for _ in range(5):
        fl = pft.KLTSelectGoodFeatures(cfg, img1, 100)
        fl2, _ = pft.KLTTrackFeatures(cfg, img1, img2, fl)
    return (time.perf_counter() - t0) / 5


def bench_affine(h=480, w=640, n_features=1000):
    """Config 3: affine-consistency tracking (6-param) frames/s."""
    import jax
    import jax.numpy as jnp
    from pyfeaturetrack_tpu.config import create_config
    from pyfeaturetrack_tpu.ops.affine import _affine_track_batch
    from pyfeaturetrack_tpu.ops.track import build_track_pyramids

    cfg = create_config(affineConsistencyCheck=2)
    base = _textured(h, w, seed=2)
    img = jnp.asarray(base[:h, :w], jnp.float32)
    pyr = jax.jit(build_track_pyramids, static_argnames=('cfg',))(img, cfg)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(40, w - 40, n_features), jnp.float32)
    y = jnp.asarray(rng.uniform(40, h - 40, n_features), jnp.float32)
    hw, hh = cfg.affine_window_width // 2, cfg.affine_window_height // 2
    from pyfeaturetrack_tpu.ops.interp import gather_window
    tmpl = gather_window(pyr.img[0], x, y, hw, hh)
    A0 = jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32), (n_features, 2, 2))
    check = jnp.ones((n_features,), bool)

    def run():
        return _affine_track_batch(tmpl, pyr.img[0], pyr.gradx[0],
                                   pyr.grady[0], x, y, A0, check, cfg)
    out = run()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(20):
        out = run()
    jax.block_until_ready(out)
    return 20 / (time.perf_counter() - t0)


def bench_batched_streams(h=480, w=640, n_features=1000, batch=8,
                          n_iters=20):
    """Aggregate throughput tracking ``batch`` independent frame pairs at
    once on one chip (the multi-stream serving shape). Returns aggregate
    frames/s."""
    import jax
    import jax.numpy as jnp
    from pyfeaturetrack_tpu.config import create_config
    from pyfeaturetrack_tpu.ops.track import (build_track_pyramids,
                                              track_features_pyramids)

    cfg = create_config()

    @jax.jit
    def step(imgs1, imgs2, x, y, val):
        def one(i1, i2, xx, yy, vv):
            p1 = build_track_pyramids(i1, cfg)
            p2 = build_track_pyramids(i2, cfg)
            return track_features_pyramids(p1, p2, xx, yy, vv, cfg)
        return jax.vmap(one)(imgs1, imgs2, x, y, val)

    rng = np.random.default_rng(0)
    imgs1 = jnp.asarray(rng.uniform(0, 255, (batch, h, w)).astype(np.float32))
    imgs2 = jnp.asarray(rng.uniform(0, 255, (batch, h, w)).astype(np.float32))
    x = jnp.asarray(rng.uniform(cfg.borderx + 1, w - cfg.borderx - 2,
                                (batch, n_features)), jnp.float32)
    y = jnp.asarray(rng.uniform(cfg.bordery + 1, h - cfg.bordery - 2,
                                (batch, n_features)), jnp.float32)
    val = jnp.ones((batch, n_features), jnp.int32)

    out = step(imgs1, imgs2, x, y, val)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out = step(imgs1, imgs2, x, y, val)
    jax.block_until_ready(out)
    return n_iters * batch / (time.perf_counter() - t0)


def bench_sfm_windowed(C=60, L=6000, kw=12, n_iters=8, solver="dense",
                       precond_block=1):
    """Config 5b: windowed block-sparse BA iteration rate at production
    scale (60 cameras x 6000 landmarks, 12-frame windows). With
    ``solver="cg"`` this doubles as config 5c (long-trajectory scale:
    banded PCG, no [6C, 6C] materialization; ``precond_block`` groups
    the preconditioner — see sfm/ba_windowed._banded_pcg_solve)."""
    import jax
    import jax.numpy as jnp
    from pyfeaturetrack_tpu.sfm import (WindowedBAProblem,
                                        bundle_adjust_windowed)
    from pyfeaturetrack_tpu.sfm.geometry import so3_exp, project

    rng = np.random.default_rng(0)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    Rs = so3_exp(jnp.asarray(0.01 * rng.standard_normal((C, 3)), jnp.float32))
    ts = jnp.asarray(np.stack([[-0.15 * i, 0.0, 0.0] for i in range(C)]),
                     jnp.float32)
    X = np.stack([rng.uniform(-4, 4, L), rng.uniform(-3, 3, L),
                  rng.uniform(5, 12, L)], -1).astype(np.float32)
    c0 = rng.integers(0, C - kw + 1, L).astype(np.int32)
    cidx = c0[:, None] + np.arange(kw)[None, :]
    uv, _ = jax.vmap(lambda ci, x: project(jnp.asarray(K), Rs[ci], ts[ci],
                                           x))(jnp.asarray(cidx),
                                               jnp.asarray(X))
    problem = WindowedBAProblem(K=jnp.asarray(K), c0=jnp.asarray(c0),
                                uv=uv, w=jnp.ones((L, kw), jnp.float32))
    X0 = jnp.asarray(X + 0.05 * rng.standard_normal(X.shape
                                                    ).astype(np.float32))
    out = bundle_adjust_windowed(problem, Rs, ts, X0, n_iters=n_iters,
                                 point_only_iters=0, solver=solver,
                                 precond_block=precond_block)
    jax.block_until_ready(out[:3])
    t0 = time.perf_counter()
    out = bundle_adjust_windowed(problem, Rs, ts, X0, n_iters=n_iters,
                                 point_only_iters=0, solver=solver,
                                 precond_block=precond_block)
    jax.block_until_ready(out[:3])
    return n_iters / (time.perf_counter() - t0)


def bench_sfm():
    """Config 5 core: BA iteration rate on a synthetic 20-cam/2000-pt
    problem (iterations/s)."""
    import jax
    import jax.numpy as jnp
    from pyfeaturetrack_tpu.sfm import BAProblem, bundle_adjust
    from pyfeaturetrack_tpu.sfm.geometry import so3_exp, project

    rng = np.random.default_rng(0)
    C, L = 20, 2000
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    Rs = so3_exp(jnp.asarray(
        0.02 * rng.standard_normal((C, 3)), jnp.float32))
    ts = np.stack([[-0.2 * i, 0.0, 0.0] for i in range(C)]).astype(np.float32)
    X = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L),
                  rng.uniform(5, 10, L)], -1).astype(np.float32)
    # project all cameras on device
    uv_dev, _ = jax.vmap(lambda R, t: project(jnp.asarray(K), R, t,
                                              jnp.asarray(X)))(
        jnp.asarray(Rs), jnp.asarray(ts))
    cam = np.repeat(np.arange(C), L).astype(np.int32)
    pt = np.tile(np.arange(L), C).astype(np.int32)
    problem = BAProblem(jnp.asarray(K), jnp.asarray(cam), jnp.asarray(pt),
                        uv_dev.reshape(-1, 2),
                        jnp.ones((C * L,), jnp.float32))
    X0 = X + 0.05 * rng.standard_normal(X.shape).astype(np.float32)
    # warm up (compile) outside the timed region with the SAME n_iters:
    # the trailing jnp.stack differs per count and recompiles
    R, t, Xh, costs = bundle_adjust(problem, Rs, ts, X0, n_iters=8)
    jax.block_until_ready((R, t, Xh))  # compile must NOT bleed into rep 1
    t0 = time.perf_counter()
    R, t, Xh, costs = bundle_adjust(problem, Rs, ts, X0, n_iters=8)
    jax.block_until_ready((R, t, Xh))
    dt = (time.perf_counter() - t0)
    return 8 / dt, costs[-1] / jnp.maximum(costs[0], 1e-9)


def _card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True)
    return out.stdout.strip()


def main():
    from pyfeaturetrack_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--features", type=int, default=1000)
    ap.add_argument("--size", type=str, default="480x640")
    ap.add_argument("--all", action="store_true",
                    help="also run the other BASELINE configs")
    args = ap.parse_args()
    h, w = map(int, args.size.split("x"))

    import jax
    if jax.default_backend() != "gpu":
        print(f"[bench] no GPU: JAX backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"card: {_card_line()}", flush=True)

    from pyfeaturetrack_tpu.config import create_config
    cfg = create_config()

    reps = _repeat(lambda: bench_tracking(h, w, args.features, cfg,
                                          n_frames=args.frames), n=5)
    headline = {
        "metric": f"frames_per_s_{args.features}feat_{h}x{w}",
        "value": reps["median"],
        "unit": "frames/s",
        "runs": reps,
        "device": device,
    }

    if args.all:
        def log(msg):
            print(f"[bench] {msg}", file=sys.stderr, flush=True)

        details = {}
        runs = [
            ("config2_sequence_replace_fps", bench_sequence_replace),
            ("config2_chain8_fps",
             lambda: bench_sequence_replace(chain=8)),
            ("config3_affine_checks_per_s", bench_affine),
            ("config4_1080p_4096feat_4lvl_fps", lambda: bench_tracking(
                1088, 1920, 4096,
                create_config().replace(nPyramidLevels=4, subsampling=2),
                n_frames=20)),
            ("dense_flow_480x640_fps", bench_dense_flow),
            ("dense_flow_batched4_240x320_fps", bench_dense_flow_batched),
            ("batched8_streams_aggregate_fps", bench_batched_streams),
            ("serving_uint8_ingest_fps",
             lambda: bench_serving(stage_uint8=True)),
            ("serving_batched8_aggregate_ingest_fps",
             bench_serving_batched),
            ("batched8_chain8_replace_aggregate_fps", bench_batched_chain),
            ("config5b_windowed_ba_iters_per_s", bench_sfm_windowed),
            ("config5c_cg_ba_500cams_20kpts_iters_per_s",
             lambda: bench_sfm_windowed(C=500, L=20000, kw=8, n_iters=6,
                                        solver="cg", precond_block=16)),
        ]
        for name, fn in runs:
            details[name] = _repeat(fn, n=5)
            log(f"{name}: {details[name]}")
        ratios = []

        def _sfm_rate():
            rate, ratio = bench_sfm()
            ratios.append(float(ratio))
            return rate
        details["config5_ba_iters_per_s"] = _repeat(_sfm_rate, n=5)
        details["config5_ba_final_over_initial_cost"] = float(
            f"{float(np.median(ratios)):.3e}")
        details["config1_two_frame_demo_s"] = round(bench_two_frame_demo(),
                                                    4)
        from pyfeaturetrack_tpu.utils.synthscene import run_vo_on_corridor
        details["config5_e2e_corridor"] = run_vo_on_corridor(
            n_frames=100, kf_every=3, n_features=100)
        details["device"] = device
        print(json.dumps(details), file=sys.stderr)

    print(json.dumps(headline))
    return 0


if __name__ == "__main__":
    sys.exit(main())
