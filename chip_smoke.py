"""Proof that the tracker runs on one NVIDIA GPU through its public entry
points, at real sizes, and agrees with the plain reference.

    python chip_smoke.py            # every one-card phase, on one GPU
    python chip_smoke.py --cards 4  # only the sharded paths, on four GPUs

Each phase runs on the card and compares with the same XLA program on
the CPU backend, reached in this process through ``jax.devices("cpu")``,
or with the float64 oracle (``pyfeaturetrack_tpu/oracle``) where that is
cheap. Each phase prints one line: what it compared and its time on the
card, measured after ``block_until_ready``. The last line is one JSON
object naming the device; it is printed only when every phase passed.
Any failure, mismatch or exception exits non-zero without it. There is no
CPU fallback: without a GPU the script fails in phase 1.

Statuses must be equal, except lanes enumerated by cause: a lane whose
float64 oracle outcome changes when one threshold (max_residue,
min_determinant, min_displacement) moves by 0.1% sits on that threshold,
and the two backends may legitimately round to either side of it. Every
tolerance below states its reason next to its value.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# GPU vs CPU positions: the LK kernel and XLA's GPU fusions contract
# multiply-adds and sum windows in another order than XLA:CPU; no matrix
# product is involved (no TF32). 1e-3 px bounds the drift that compounds
# over at most max_iterations Newton steps per level.
POS_ATOL_GPU_CPU = 1e-3
# float32 tracker vs float64 oracle, as tests/test_track.py asserts it:
# the measured gap is ~1e-5 px; 1e-4 keeps an order of magnitude.
POS_ATOL_ORACLE = 1e-4
# Same device, same program family (serving vs the device sequence): the
# only difference is batching, which may re-fuse the same float32 sums.
POS_ATOL_SAME_DEVICE = 1e-4
THRESHOLDS = ("max_residue", "min_determinant", "min_displacement")


class SmokeFailure(Exception):
    """A phase found a result that disagrees with its reference."""


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def final_line(kind: str, count: int) -> str:
    """The contract's last line."""
    return json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": kind,
                                              "count": count}})


def card_line() -> str:
    """Name and power limit of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def compare_lanes(name: str, got, ref, atol: float, explain=None) -> dict:
    """Compare (x, y, status) lane arrays. Lanes whose statuses differ,
    or whose positions (both TRACKED) differ by more than ``atol``, must
    each be explained: ``explain(lanes)`` returns {lane: cause} for the
    ones it can attribute. Any unexplained lane raises SmokeFailure.
    Returns {"summary", "causes", "max_pos_diff"}."""
    gx, gy, gs = (np.asarray(a).ravel() for a in got)
    rx, ry, rs = (np.asarray(a).ravel() for a in ref)
    check(gs.shape == rs.shape, f"{name}: shape {gs.shape} vs {rs.shape}")
    both = (gs == 0) & (rs == 0)
    dpos = np.where(both, np.maximum(np.abs(gx - rx), np.abs(gy - ry)), 0.0)
    bad = np.flatnonzero((gs != rs) | (dpos > atol))
    causes = explain(bad) if (explain is not None and bad.size) else {}
    unexplained = [int(i) for i in bad if int(i) not in causes]
    check(not unexplained,
          f"{name}: {len(unexplained)} unexplained lanes, first "
          f"{[(i, int(gs[i]), int(rs[i])) for i in unexplained[:5]]}")
    worst = float(dpos.max(initial=0.0))
    return {"summary": (f"{name}: lanes={gs.size} "
                        f"tracked={int((rs == 0).sum())} "
                        f"status_mismatch={int((gs != rs).sum())} "
                        f"max_pos_diff={worst:.3g}px (tol {atol}) "
                        f"enumerated={dict(sorted(causes.items()))}"),
            "causes": causes, "max_pos_diff": worst}


def threshold_explainer(run_oracle, cfg, atol: float, rel: float = 1e-3):
    """Build an ``explain`` for compare_lanes. ``run_oracle(cfg, lanes)``
    returns float64 (x, y, status) for those lanes; a lane sits on a
    threshold when moving that threshold by ``rel`` changes its outcome."""
    def explain(lanes):
        lanes = np.asarray(lanes)
        bx, by, bs = (np.asarray(a) for a in run_oracle(cfg, lanes))
        causes = {}
        for param in THRESHOLDS:
            v = getattr(cfg, param)
            for f in (1.0 - rel, 1.0 + rel):
                px, py, ps = (np.asarray(a) for a in run_oracle(
                    cfg.replace(**{param: type(v)(v * f)}), lanes))
                moved = (ps != bs) | (np.maximum(np.abs(px - bx),
                                                 np.abs(py - by)) > atol)
                for i in lanes[moved]:
                    causes.setdefault(int(i), f"{param} at threshold")
        return causes
    return explain


def timed(fn):
    """(result, milliseconds) of a warm fn(): one untimed call compiles,
    the second is timed until its result is ready."""
    import jax
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, (time.perf_counter() - t0) * 1e3


def textured(h: int, w: int, seed: int) -> np.ndarray:
    """Seeded smooth random texture, values 0..255."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h + 16, w + 16))
    k = np.array([1.0, 4, 6, 4, 1]) / 16.0
    for axis in (0, 1):
        img = np.apply_along_axis(lambda m: np.convolve(m, k, "same"),
                                  axis, img)
    return img


def moving_frames(h: int, w: int, n: int, seed: int,
                  step=(1.3, -0.7)) -> list:
    """n frames of one texture translated by ``step`` px per frame."""
    base = textured(h + 2 * n * 2, w + 2 * n * 2, seed)
    frames = []
    for i in range(n):
        ox, oy = 2 * n + step[0] * i, 2 * n + step[1] * i
        x0, y0 = int(np.floor(ox)), int(np.floor(oy))
        ax, ay = ox - x0, oy - y0
        a = base[y0:y0 + h + 1, x0:x0 + w + 1]
        frames.append(((1 - ax) * (1 - ay) * a[:-1, :-1]
                       + ax * (1 - ay) * a[:-1, 1:]
                       + (1 - ax) * ay * a[1:, :-1]
                       + ax * ay * a[1:, 1:]).astype(np.float32))
    return frames


def _lanes(fl):
    return (np.asarray(fl.x), np.asarray(fl.y), np.asarray(fl.val))


def _track_oracle(img1, img2, feats):
    """run_oracle for a two-frame pyramidal step."""
    from pyfeaturetrack_tpu.oracle import klt_oracle as oracle

    def run(cfg, lanes):
        out, _ = oracle.track_features(np.asarray(img1, np.float64),
                                       np.asarray(img2, np.float64),
                                       feats[lanes], cfg)
        return out[:, 0], out[:, 1], out[:, 2].astype(np.int64)
    return run


def step_on(dev, cfg, img1, img2, feats):
    """KLTTrackFeatures for one two-frame step with ``dev`` as the
    default device; returns the feature list and milliseconds."""
    import jax

    import pyfeaturetrack_tpu as pft
    from pyfeaturetrack_tpu.features import feature_state_from_numpy
    with jax.default_device(dev):
        fl = feature_state_from_numpy(np.asarray(feats, np.float64))
        return timed(lambda: pft.KLTTrackFeatures(cfg, img1, img2, fl)[0])


def compare_step(name, cfg, img1, img2, feats, gpu, cpu):
    """One two-frame step on the card vs the same call on the CPU.
    Returns (comparison, the card's feature list, card milliseconds)."""
    fl, ms = step_on(gpu, cfg, img1, img2, feats)
    fl_c, _ = step_on(cpu, cfg, img1, img2, feats)
    explain = threshold_explainer(_track_oracle(img1, img2, feats), cfg,
                                  POS_ATOL_GPU_CPU)
    return (compare_lanes(name, _lanes(fl), _lanes(fl_c),
                          POS_ATOL_GPU_CPU, explain), fl, ms)


# -- phases ----------------------------------------------------------------

def phase_device(jax, expect_count=1):
    check(jax.default_backend() == "gpu",
          f"JAX backend is {jax.default_backend()!r}, not 'gpu'")
    devs = jax.devices()
    check(len(devs) >= expect_count and all(d.platform == "gpu"
                                            for d in devs),
          f"need {expect_count} CUDA device(s), JAX sees {devs}")
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError as e:
        raise SmokeFailure(
            "the CPU backend is hidden (JAX_PLATFORMS="
            f"{os.environ.get('JAX_PLATFORMS')!r}); the reference runs "
            f"there, so the comparison cannot be made: {e}") from e
    print(f"[1 device] kind={devs[0].device_kind} count={len(devs)} "
          f"cpu_reference={cpu}", flush=True)
    # nvidia-smi's own line(s), unprefixed: "<name>, <power limit>"
    print(card_line(), flush=True)
    return devs[0], cpu


def phase_config1(gpu, cpu):
    """examples/example1.py path vs the float64 oracle."""
    import jax

    import pyfeaturetrack_tpu as pft
    from pyfeaturetrack_tpu.oracle import klt_oracle as oracle
    from pyfeaturetrack_tpu.utils.io import pgm_read
    data = os.path.join(REPO, "examples", "data")
    img1 = pgm_read(os.path.join(data, "img0.pgm"))
    img2 = pgm_read(os.path.join(data, "img1.pgm"))
    tc = pft.KLTCreateTrackingContext()
    with jax.default_device(gpu):
        fl, ms_sel = timed(lambda: pft.KLTSelectGoodFeatures(tc, img1, 100))
        fl2, ms_trk = timed(lambda: pft.KLTTrackFeatures(tc, img1, img2,
                                                         fl)[0])
        fl3, ms_rep = timed(lambda: pft.KLTReplaceLostFeatures(tc, img2,
                                                               fl2))
    with jax.default_device(cpu):
        fl_c = pft.KLTSelectGoodFeatures(tc, img1, 100)
        fl3_c = pft.KLTReplaceLostFeatures(tc, img2, fl2)
    sel = _lanes(fl)
    check(all(np.array_equal(a, b) for a, b in zip(sel, _lanes(fl_c))),
          "config1: selection differs between the card and the CPU")
    feats = np.stack([a.astype(np.float64) for a in sel], 1)
    want, _ = oracle.track_features(img1.astype(np.float64),
                                    img2.astype(np.float64), feats, tc)
    res = compare_lanes(
        "config1 track vs float64 oracle", _lanes(fl2),
        (want[:, 0], want[:, 1], want[:, 2].astype(np.int64)),
        POS_ATOL_ORACLE,
        threshold_explainer(_track_oracle(img1, img2, feats), tc,
                            POS_ATOL_ORACLE))
    check(all(np.array_equal(a, b) for a, b in zip(_lanes(fl3),
                                                    _lanes(fl3_c))),
          "config1: KLTReplaceLostFeatures differs from the CPU")
    remaining = int((np.asarray(fl2.val) >= 0).sum())
    print(f"[2 config1] {res['summary']}; remaining={remaining}/100 "
          f"gpu_ms select={ms_sel:.3f} track={ms_trk:.3f} "
          f"replace={ms_rep:.3f}", flush=True)


def phase_headline(gpu, cpu, h=480, w=640, n_frames=16, n_features=1000):
    """track_sequence on the card; live counts vs the CPU run; every
    two-frame step vs the CPU step fed the same inputs."""
    import jax

    import pyfeaturetrack_tpu as pft
    from pyfeaturetrack_tpu.models.sequence import track_sequence
    frames = moving_frames(h, w, n_frames, seed=5)
    cfg = pft.create_config().replace(sequentialMode=True)
    with jax.default_device(gpu):
        (ft, _), ms = timed(lambda: track_sequence(
            frames, n_features=n_features, replace_lost=True))
    with jax.default_device(cpu):
        ft_c, _ = track_sequence(frames, n_features=n_features,
                                 replace_lost=True)
    table = [np.asarray(a) for a in ft]
    enumerated = 0
    worst = 0.0
    for i in range(n_frames - 1):
        feats = np.stack([table[0][i], table[1][i], table[2][i]],
                         1).astype(np.float64)
        res, fl2, _ = compare_step(f"step {i}", cfg, frames[i],
                                   frames[i + 1], feats, gpu, cpu)
        enumerated += bool(res["causes"])
        worst = max(worst, res["max_pos_diff"])
        # the card's table row i+1 is its own step + refill of row i
        with jax.default_device(gpu):
            fl3 = pft.KLTReplaceLostFeatures(cfg, frames[i + 1], fl2)
        with jax.default_device(cpu):
            fl3_c = pft.KLTReplaceLostFeatures(cfg, frames[i + 1], fl2)
        check(all(np.array_equal(a, b) for a, b in
                  zip(_lanes(fl3), _lanes(fl3_c))),
              f"headline step {i}: refill differs from the CPU refill")
        check(all(np.array_equal(a, t[i + 1]) for a, t in
                  zip(_lanes(fl3), table)),
              f"headline step {i}: table row {i + 1} is not the step's "
              "own result")
    live = (table[2] >= 0).sum(1)
    live_c = (np.asarray(ft_c.val) >= 0).sum(1)
    check(enumerated > 0 or np.array_equal(live, live_c),
          f"headline: live counts {live.tolist()} vs CPU {live_c.tolist()}")
    print(f"[3 headline] {n_frames} frames {h}x{w} {n_features} features: "
          f"{n_frames - 1} steps match the CPU (worst pos diff {worst:.3g}px, "
          f"steps with enumerated lanes={enumerated}); live per frame "
          f"{live.tolist()} == CPU; gpu_ms sequence={ms:.3f}", flush=True)


def phase_config4(gpu, cpu, h=1088, w=1920, n_features=4096):
    import jax

    import pyfeaturetrack_tpu as pft
    frames = moving_frames(h, w, 2, seed=9, step=(2.2, 1.4))
    cfg = pft.create_config().replace(nPyramidLevels=4, subsampling=2)
    with jax.default_device(gpu):
        fl = pft.KLTSelectGoodFeatures(cfg, frames[0], n_features)
    feats = np.stack([a.astype(np.float64) for a in _lanes(fl)], 1)
    res, _, ms = compare_step("config4 step", cfg, frames[0], frames[1],
                              feats, gpu, cpu)
    print(f"[4 config4] {h}x{w} {n_features} features 4 levels: "
          f"{res['summary']} gpu_ms={ms:.3f}", flush=True)


def phase_serving(gpu, h=480, w=640, n_frames=16, n_features=1000,
                  n_streams=8, chain=8):
    """Both streaming trackers vs track_sequence_device on the card."""
    import jax

    from pyfeaturetrack_tpu.models.device_sequence import \
        track_sequence_device
    from pyfeaturetrack_tpu.serving import (BatchedStreamingTracker,
                                            StreamingTracker)
    streams = [moving_frames(h, w, n_frames, seed=20 + s,
                             step=(1.0 + 0.3 * s, -0.5))
               for s in range(n_streams)]
    with jax.default_device(gpu):
        def single():
            tr = StreamingTracker(n_features=n_features, chain=chain)
            for f in streams[0]:
                tr.feed(f)
            return tr.table()
        (sx, sy, sv), ms_s = timed(single)

        def batched():
            bt = BatchedStreamingTracker(n_streams=n_streams,
                                         n_features=n_features,
                                         chain=chain)
            for i in range(n_frames):
                bt.feed(np.stack([s[i] for s in streams]))
            return bt.table()
        (bx, by, bv), ms_b = timed(batched)
        refs = [track_sequence_device(s, n_features=n_features,
                                      chain=chain) for s in streams]
    res = [compare_lanes("streaming", (sx, sy, sv), refs[0],
                         POS_ATOL_SAME_DEVICE)]
    for s in range(n_streams):
        res.append(compare_lanes(
            f"batched stream {s}", (bx[:, s], by[:, s], bv[:, s]),
            refs[s], POS_ATOL_SAME_DEVICE))
    worst = max(r["max_pos_diff"] for r in res)
    print(f"[5 serving] StreamingTracker chain={chain} and "
          f"BatchedStreamingTracker x{n_streams}, {n_frames} frames "
          f"{h}x{w} {n_features} features == track_sequence_device "
          f"(status mismatches 0, worst pos diff {worst:.3g}px); gpu_ms "
          f"streaming={ms_s:.3f} batched={ms_b:.3f}", flush=True)


def phase_flow(gpu, cpu, h=480, w=640):
    import jax

    from pyfeaturetrack_tpu.config import create_config
    from pyfeaturetrack_tpu.ops.flow import compute_dense_flow
    f0, f1 = moving_frames(h, w, 2, seed=31, step=(1.6, -0.9))
    with jax.default_device(gpu):
        fl, ms = timed(lambda: compute_dense_flow(f0, f1))
    with jax.default_device(cpu):
        fl_c = compute_dense_flow(f0, f1)
    cfg = create_config().validated_window()
    explain = threshold_explainer(
        _flow_level0_oracle(f0, f1, cfg, cpu), cfg, POS_ATOL_GPU_CPU)
    xg = np.broadcast_to(np.arange(w, dtype=np.float32), (h, w))
    yg = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], (h, w))
    got = (xg + np.asarray(fl.u), yg + np.asarray(fl.v),
           np.asarray(fl.status))
    ref = (xg + np.asarray(fl_c.u), yg + np.asarray(fl_c.v),
           np.asarray(fl_c.status))
    res = compare_lanes("dense flow", got, ref, POS_ATOL_GPU_CPU, explain)
    frac, frac_c = [float((np.asarray(s) == 0).mean())
                    for s in (fl.status, fl_c.status)]
    print(f"[6 flow] {h}x{w} pair: {res['summary']}; tracked fraction "
          f"{frac:.4f} "
          f"(CPU {frac_c:.4f}) gpu_ms={ms:.3f}", flush=True)


def _flow_level0_oracle(f0, f1, cfg, cpu):
    """run_oracle for dense-flow pixels: the float64 level-0 solve from
    the CPU run's upsampled coarse flow (the finest level decides the
    status map)."""
    import jax

    from pyfeaturetrack_tpu.ops.flow import flow_level, upsample_flow
    from pyfeaturetrack_tpu.ops.track import build_track_pyramids_jit
    from pyfeaturetrack_tpu.oracle import flow_oracle
    with jax.default_device(cpu):
        p1 = build_track_pyramids_jit(np.asarray(f0, np.float32), cfg)
        p2 = build_track_pyramids_jit(np.asarray(f1, np.float32), cfg)
        s = float(cfg.subsampling)
        u = v = np.zeros(p1.img[-1].shape, np.float32)
        for r in range(cfg.nPyramidLevels - 1, 0, -1):
            if p1.img[r].shape != u.shape:
                u = upsample_flow(u, p1.img[r].shape, s)
                v = upsample_flow(v, p1.img[r].shape, s)
            u, v, _ = flow_level(*(p[r] for p in (p1.img, p1.gradx,
                                                  p1.grady, p2.img,
                                                  p2.gradx, p2.grady)),
                                 u, v, cfg)
        u0 = np.asarray(upsample_flow(u, p1.img[0].shape, s), np.float64)
        v0 = np.asarray(upsample_flow(v, p1.img[0].shape, s), np.float64)
    lv = [np.asarray(p[0], np.float64) for p in (p1.img, p1.gradx,
                                                  p1.grady, p2.img,
                                                  p2.gradx, p2.grady)]
    w = lv[0].shape[1]

    def run(c, lanes):
        ys, xs = np.divmod(np.asarray(lanes), w)
        x1, y1 = xs.astype(np.float64), ys.astype(np.float64)
        x2, y2, st, _ = flow_oracle.track_level(
            x1, y1, x1 + u0.flat[lanes], y1 + v0.flat[lanes], *lv, c,
            np.ones(len(lanes), bool))
        return x2, y2, st
    return run


def phase_backend(gpu, cpu):
    """VisualOdometry on the example8 scene; one config-5 bundle_adjust
    on the card vs the CPU."""
    import importlib.util

    import jax
    import jax.numpy as jnp

    from pyfeaturetrack_tpu.sfm import BAProblem, VisualOdometry, bundle_adjust
    from pyfeaturetrack_tpu.sfm.geometry import project, so3_exp
    from pyfeaturetrack_tpu.sfm.pipeline import ate_rmse_aligned
    spec = importlib.util.spec_from_file_location(
        "example8_vo", os.path.join(REPO, "examples", "example8_vo.py"))
    ex8 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex8)
    with jax.default_device(gpu):
        Rs, ts, cs, pts = ex8.make_scene()
        frames = ex8.render(Rs, ts, pts)

        def run_vo():
            vo = VisualOdometry(ex8.K, n_features=120, kf_every=2,
                                window=6, min_parallax_px=10.0)
            for f in frames:
                vo.feed(f)
            return vo.trajectory()
        t0 = time.perf_counter()
        fi, _, _, c = run_vo()
        vo_s = time.perf_counter() - t0
    gt = cs[fi]
    travel = float(np.linalg.norm(gt[-1] - gt[0]))
    ate = ate_rmse_aligned(c, gt)
    # the bound tests/test_vo.py asserts on the same scene
    check(ate < 0.03 * travel, f"VO ATE {ate:.4f} >= 3% of {travel:.3f}")

    # config 5: 20 cameras x 2000 points, 8 Gauss-Newton iterations
    rng = np.random.default_rng(0)
    C, L = 20, 2000
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    R0 = np.asarray(so3_exp(jnp.asarray(0.02 * rng.standard_normal((C, 3)),
                                        jnp.float32)))
    t0_ = np.stack([[-0.2 * i, 0.0, 0.0] for i in range(C)]
                   ).astype(np.float32)
    X = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L),
                  rng.uniform(5, 10, L)], -1).astype(np.float32)
    uv = np.asarray(jax.vmap(lambda R, t: project(
        jnp.asarray(K), R, t, jnp.asarray(X))[0])(R0, t0_)).reshape(-1, 2)
    X0 = X + 0.05 * rng.standard_normal(X.shape).astype(np.float32)
    cam = np.repeat(np.arange(C), L).astype(np.int32)
    pt = np.tile(np.arange(L), C).astype(np.int32)

    def ba(dev):
        with jax.default_device(dev):
            prob = BAProblem(jnp.asarray(K), jnp.asarray(cam),
                             jnp.asarray(pt), jnp.asarray(uv),
                             jnp.ones((C * L,), jnp.float32))
            return timed(lambda: bundle_adjust(prob, R0, t0_, X0,
                                               n_iters=8)[3])
    costs, ms = ba(gpu)
    costs_c, _ = ba(cpu)
    costs, costs_c = np.asarray(costs, np.float64), np.asarray(costs_c,
                                                               np.float64)
    # The initial cost and the cost after the first Gauss-Newton step
    # sit far above float32 rounding and must agree to 1e-3 relative.
    # Each later step multiplies the cost by ~1e-3 (quadratic
    # convergence), so the two backends' different summation order in
    # the normal equations shows up relatively larger there; once the
    # cost reaches the rounding floor only its order of magnitude is
    # meaningful, which the drop check below holds to one decade.
    rel = np.abs(costs[:2] - costs_c[:2]) / costs_c[:2]
    check(np.all(rel < 1e-3), f"BA early costs differ: {rel.tolist()}")
    drop, drop_c = costs[0] / costs[-1], costs_c[0] / costs_c[-1]
    check(drop > 1e3 and drop_c > 1e3 and
          abs(np.log10(drop) - np.log10(drop_c)) < 1.0,
          f"BA cost drop {drop:.3g} vs CPU {drop_c:.3g}")
    print(f"[7 backend] VO example8: {len(fi)} keyframes, ATE {ate:.5f} "
          f"< 3% of travel {travel:.3f} (wall {vo_s:.2f}s); BA 20x2000 x8 "
          f"iters: cost drop {drop:.3g} (CPU {drop_c:.3g}), early-cost "
          f"rel diff {float(rel.max()):.2g}; costs {costs.tolist()} "
          f"(CPU {costs_c.tolist()}) gpu_ms={ms:.3f}", flush=True)


KERNEL_CASES = (("headline", 480, 640, 1000, {}),
                ("config4", 1088, 1920, 4096,
                 {"nPyramidLevels": 4, "subsampling": 2}),
                ("flow", 480, 640, None, {}))


def phase_kernel(gpu, cases=KERNEL_CASES):
    """The Pallas LK level kernel vs the plain XLA level, on the card,
    at the headline, config-4 and dense-flow level-0 shapes (n=None:
    every pixel, as dense flow's level 0)."""
    import jax
    import jax.numpy as jnp

    from pyfeaturetrack_tpu.config import create_config
    from pyfeaturetrack_tpu.ops import lk_gpu
    from pyfeaturetrack_tpu.ops.track import (build_track_pyramids_jit,
                                              track_feature_level)
    from pyfeaturetrack_tpu.oracle import klt_oracle as oracle
    for name, h, w, n, over in cases:
        cfg = create_config().replace(**over)
        f0, f1 = moving_frames(h, w, 2, seed=41, step=(1.3, -0.7))
        with jax.default_device(gpu):
            p1 = build_track_pyramids_jit(jnp.asarray(f0), cfg)
            p2 = build_track_pyramids_jit(jnp.asarray(f1), cfg)
            lvl = (p1.img[0], p1.gradx[0], p1.grady[0],
                   p2.img[0], p2.gradx[0], p2.grady[0])
            if n is None:
                ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
                x, y = xs.ravel(), ys.ravel()
            else:
                rng = np.random.default_rng(2)
                x = rng.uniform(cfg.borderx, w - cfg.borderx, n
                                ).astype(np.float32)
                y = rng.uniform(cfg.bordery, h - cfg.bordery, n
                                ).astype(np.float32)
            x2, y2 = x + 1.3, y - 0.7
            act = jnp.ones(x.shape, bool)
            kern = jax.jit(lambda *a: lk_gpu.track_level_kernel(
                *a, cfg, act))
            xla = jax.jit(lambda *a: track_feature_level(*a, cfg, act))
            args = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(x2),
                    jnp.asarray(y2), *lvl)
            got = kern(*args)
            ref = xla(*args)
            ms_k = min(timed(lambda: kern(*args))[1] for _ in range(10))
            ms_x = min(timed(lambda: xla(*args))[1] for _ in range(10))
        lv64 = [np.asarray(a, np.float64) for a in lvl]

        def run(c, lanes, x=x, y=y, x2=x2, y2=y2, lv64=lv64):
            out = [oracle.track_feature(float(x[i]), float(y[i]),
                                        float(x2[i]), float(y2[i]),
                                        *lv64, c)[:3] for i in lanes]
            return tuple(np.asarray(v) for v in zip(*out)) if out else (
                np.zeros(0), np.zeros(0), np.zeros(0, np.int64))
        res = compare_lanes(
            f"kernel vs XLA level ({name})", got[:3], ref[:3],
            POS_ATOL_GPU_CPU,
            threshold_explainer(run, cfg, POS_ATOL_GPU_CPU))
        same_iters = np.asarray(got[3]) == np.asarray(ref[3])
        check(all(int(i) in res["causes"]
                  for i in np.flatnonzero(~same_iters)),
              f"kernel vs XLA level ({name}): iteration counts differ")
        print(f"[8 kernel] {h}x{w} lanes={x.size}: {res['summary']}; "
              f"level ms "
              f"kernel={ms_k:.3f} xla={ms_x:.3f}", flush=True)

    import pytest

    class Outcomes:
        """Counts test outcomes, so that skipped tests cannot pass."""
        def __init__(self):
            self.passed, self.other = 0, 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed or report.skipped:
                self.other += 1
    seen = Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_lk_gpu.py"),
                      os.path.join(REPO, "tests", "test_lk_gpu_flow.py")],
                     plugins=[seen])
    check(rc == 0 and seen.passed > 0 and seen.other == 0,
          f"pytest -m gpu: exit {rc}, {seen.passed} passed, "
          f"{seen.other} failed or skipped")
    print(f"[8 kernel] {seen.passed} tests marked gpu passed on the card",
          flush=True)


def phase_four_cards(devs, h=480, w=640, n_features=1000, n_frames=4,
                     ba_shape=(60, 6000, 12)):
    """The sharded paths of parallel/sharding.py and the landmark-sharded
    windowed BA on a mesh over ``devs``, each vs the same computation on
    ``devs[0]`` alone: one frame pair, stream or chunk per card."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from pyfeaturetrack_tpu.config import create_config
    from pyfeaturetrack_tpu.models.chunked import track_chunks_batched
    from pyfeaturetrack_tpu.parallel import sharding as sh
    from pyfeaturetrack_tpu.serving import _select_batch, _step_batch
    nd = len(devs)
    one = devs[0]
    mesh = sh.make_mesh(n_frame=nd, n_feature=1, devices=devs)
    img_sh = NamedSharding(mesh, P(sh.FRAME_AXIS, None, None))
    feat_sh = NamedSharding(mesh, P(sh.FRAME_AXIS, None))
    put = lambda a, s: jax.device_put(jnp.asarray(a), s)  # noqa: E731
    clips = [moving_frames(h, w, n_frames, seed=60 + b,
                           step=(1.0 + 0.2 * b, -0.6)) for b in range(nd)]
    imgs = [np.stack([c[i] for c in clips]) for i in range(n_frames)]
    cfg = create_config().replace(sequentialMode=True).validated_window()
    rng = np.random.default_rng(61)
    xs = rng.uniform(cfg.borderx + 1, w - cfg.borderx - 2,
                     (nd, n_features)).astype(np.float32)
    ys = rng.uniform(cfg.bordery + 1, h - cfg.bordery - 2,
                     (nd, n_features)).astype(np.float32)
    vals = np.ones((nd, n_features), np.int32)

    def report(name, got, ref, ms):
        res = compare_lanes(name, got, ref, POS_ATOL_SAME_DEVICE)
        print(f"[4-card {name}] {res['summary']} mesh_ms={ms:.3f}",
              flush=True)

    # track step and full step (affine check + LI + refill)
    for name, fn, c in (
            ("track step", sh._track_pair_batch, cfg),
            ("full step", sh._full_pair_batch,
             create_config(affineConsistencyCheck=2,
                           lighting_insensitive=True).validated_window())):
        args = (imgs[0], imgs[1], xs, ys, vals)
        with mesh:
            got, ms = timed(lambda: fn(
                *(put(a, img_sh if a.ndim == 3 else feat_sh)
                  for a in args), c))
        ref = fn(*(jax.device_put(a, one) for a in args), c)
        report(name, got, ref, ms)

    # dense flow and dense disparity, pixel rows sharded
    f0, f1 = clips[0][0], clips[0][1]
    pix = Mesh(np.asarray(devs), (sh.PIXROW_AXIS,))
    solo = Mesh(np.asarray([one]), (sh.PIXROW_AXIS,))
    ccfg = create_config()
    xg = np.broadcast_to(np.arange(w, dtype=np.float32), (h, w))
    yg = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], (h, w))
    fl, ms = timed(lambda: sh.dense_flow_sharded(f0, f1, ccfg, mesh=pix))
    fl_1 = sh.dense_flow_sharded(f0, f1, ccfg, mesh=solo)
    report("dense flow", (xg + np.asarray(fl.u), yg + np.asarray(fl.v),
                          fl.status),
           (xg + np.asarray(fl_1.u), yg + np.asarray(fl_1.v),
            fl_1.status), ms)
    right = moving_frames(h, w, 2, seed=62, step=(4.0, 0.0))
    dd, ms = timed(lambda: sh.dense_disparity_sharded(
        right[0], right[1], ccfg, mesh=pix, max_disparity=16.0))
    dd_1 = sh.dense_disparity_sharded(right[0], right[1], ccfg, mesh=solo,
                                      max_disparity=16.0)
    report("dense disparity", (xg - np.asarray(dd.d), yg, dd.status),
           (xg - np.asarray(dd_1.d), yg, dd_1.status), ms)

    # chunked sequence: one video chunk per card, refill on, chain 2
    def chunks(frames_put, xput):
        return track_chunks_batched(
            frames_put, *(xput(a) for a in (xs, ys, vals)), cfg,
            replace_lost=True, chain=2)[:3]
    with mesh:
        got, ms = timed(lambda: chunks(
            [put(f, img_sh) for f in imgs],
            lambda a: put(a, feat_sh)))
    ref = chunks([jax.device_put(f, one) for f in imgs],
                 lambda a: jax.device_put(a, one))
    report("chunked sequence", got, ref, ms)

    # batched serving tick: one camera stream per card, refill on
    with mesh:
        pyr, x, y, v, aff, _ = _select_batch(put(imgs[0], img_sh), cfg,
                                             n_features, 512)
        got, ms = timed(lambda: _step_batch(
            pyr, tuple(put(f, img_sh) for f in imgs[1:]), x, y, v, cfg,
            True, 512, aff, n_steps=n_frames - 1, stream_mesh=mesh)[1])
    pyr, x, y, v, aff, _ = _select_batch(jax.device_put(imgs[0], one),
                                         cfg, n_features, 512)
    ref = _step_batch(pyr, tuple(jax.device_put(f, one) for f in imgs[1:]),
                      x, y, v, cfg, True, 512, aff,
                      n_steps=n_frames - 1)[1]
    report("batched serving", got, ref, ms)

    # landmark-sharded windowed BA at 60 cameras x 6000 landmarks
    from pyfeaturetrack_tpu.sfm import (WindowedBAProblem,
                                        bundle_adjust_windowed,
                                        pad_windowed_for_mesh)
    from pyfeaturetrack_tpu.sfm.geometry import project, so3_exp
    C, L, kw = ba_shape
    rng = np.random.default_rng(63)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    Rs = np.asarray(so3_exp(jnp.asarray(0.01 * rng.standard_normal((C, 3)),
                                        jnp.float32)))
    ts = np.stack([[-0.15 * i, 0.0, 0.0] for i in range(C)]
                  ).astype(np.float32)
    X = np.stack([rng.uniform(-4, 4, L), rng.uniform(-3, 3, L),
                  rng.uniform(5, 12, L)], -1).astype(np.float32)
    c0 = rng.integers(0, C - kw + 1, L).astype(np.int32)
    cidx = c0[:, None] + np.arange(kw)[None, :]
    Rj, tj = jnp.asarray(Rs), jnp.asarray(ts)
    uv = np.asarray(jax.vmap(lambda ci, p: project(
        jnp.asarray(K), Rj[ci], tj[ci], p))(cidx, X)[0])
    X0 = X + 0.05 * rng.standard_normal(X.shape).astype(np.float32)
    prob = WindowedBAProblem(K=jnp.asarray(K), c0=jnp.asarray(c0),
                             uv=jnp.asarray(uv),
                             w=jnp.ones((L, kw), jnp.float32))
    lm = Mesh(np.asarray(devs), ("landmark",))
    pp, Xp, n_pad = pad_windowed_for_mesh(prob, X0, nd)
    ba = lambda m, p, x0: bundle_adjust_windowed(  # noqa: E731
        p, Rs, ts, x0, n_iters=4, point_only_iters=0, solver="cg", mesh=m)
    (_, _, Xs, costs), ms = timed(lambda: ba(lm, pp, Xp))
    with jax.default_device(one):
        _, _, X1, costs1 = ba(None, prob, X0)
    costs, costs1 = (np.asarray(c, np.float64) for c in (costs, costs1))
    # psum over 4 landmark shards sums the camera system in another
    # order; early Gauss-Newton costs sit far above float32 rounding
    rel = np.abs(costs[:2] - costs1[:2]) / costs1[:2]
    check(np.all(rel < 1e-3), f"4-card BA early costs differ: {rel}")
    dx = float(np.abs(np.asarray(Xs)[:L] - np.asarray(X1)).max())
    print(f"[4-card windowed BA] {C} cams x {L} landmarks x4 iters: cost "
          f"{costs[0]:.4g} -> {costs[-1]:.4g} (one card {costs1[-1]:.4g}), "
          f"early rel diff {float(rel.max()):.2g}, max |dX| {dx:.3g} "
          f"mesh_ms={ms:.3f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded paths on four cards")
    args = ap.parse_args(argv)
    try:
        from pyfeaturetrack_tpu.utils.cache import enable_compile_cache
        enable_compile_cache()
        import jax
        gpu, cpu = phase_device(jax, expect_count=args.cards)
        if args.cards == 4:
            phase_four_cards(jax.devices()[:4])
        else:
            phase_config1(gpu, cpu)
            phase_headline(gpu, cpu)
            phase_config4(gpu, cpu)
            phase_serving(gpu)
            phase_flow(gpu, cpu)
            phase_backend(gpu, cpu)
            phase_kernel(gpu)
    except Exception as e:  # noqa: BLE001 — any failure fails the run
        import traceback
        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return 1
    print(final_line(gpu.device_kind, len(jax.devices())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
