"""Batched pyramidal Lucas-Kanade tracking — the framework's flagship op.

Reference parity: trackFeatures.py -> KLTTrackFeatures / _trackFeature /
_computeIntensityDifference / _computeGradientSum /
_compute2by2GradientMatrix / _compute2by1ErrorVector / _solveEquation and
the lighting-insensitive variants (see SURVEY.md section 3.2).

Inversion of the reference design: the reference loops
feature-at-a-time, pixel-at-a-time with early exits; here ALL features
advance together through a fixed-trip iteration loop with per-feature
active masks, so the whole tracker is one fused XLA program:

* window reads  -> batched bilinear gathers [N, h, w]
* 2x2 normal matrix + error vector -> window-axis reductions
* per-feature early exit (OOB / small det / convergence) -> lane masking;
  frozen lanes keep their state, reproducing the sequential semantics
  bit-for-bit in structure (float32 vs the oracle's float64 is the only
  difference, covered by tolerance in tests).

Status codes are bit-identical to the reference (klt.py constants).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..features import (KLT_LARGE_RESIDUE, KLT_MAX_ITERATIONS, KLT_OOB,
                        KLT_SMALL_DET, KLT_TRACKED)
from .convolve import compute_smoothed_image, to_float_image
from .interp import gather_patch, patch_indices, window_from_patch
from .pyramid import compute_gradient_pyramids, compute_pyramid
from ..utils.staging import stage_f32

_ONE_PLUS_EPS = 1.001


class TrackPyramids(NamedTuple):
    """Image + gradient pyramids for one frame (the sequential-mode cache).

    Reference parity: klt.py -> tc.pyramid_last / pyramid_last_gradx /
    pyramid_last_grady.
    """
    img: tuple[jax.Array, ...]
    gradx: tuple[jax.Array, ...]
    grady: tuple[jax.Array, ...]


def build_track_pyramids(img: jax.Array, cfg) -> TrackPyramids:
    """float -> smooth -> pyramid -> per-level gradients.

    Reference parity: trackFeatures.py -> KLTTrackFeatures pyramid-build
    phase. Traceable (used inside callers' jits); top-level callers should
    prefer build_track_pyramids_jit, which compiles the conv chain into
    one program instead of dispatching it op by op.
    """
    with jax.named_scope("pft.pyramid_build"):
        fimg = compute_smoothed_image(to_float_image(img), cfg.smooth_sigma)
        pyr = compute_pyramid(fimg, cfg.subsampling, cfg.nPyramidLevels,
                              cfg.pyramid_sigma_fact)
        gx, gy = compute_gradient_pyramids(pyr, cfg.grad_sigma)
    if getattr(cfg, "image_dtype", "float32") != "float32":
        # storage-only cast: construction math above stays float32;
        # window blends/reductions upcast at the gather (ops/interp)
        dt = jnp.dtype(cfg.image_dtype)
        cast = lambda lv: tuple(a.astype(dt) for a in lv)  # noqa: E731
        return TrackPyramids(img=cast(pyr.levels), gradx=cast(gx.levels),
                             grady=cast(gy.levels))
    return TrackPyramids(img=pyr.levels, gradx=gx.levels, grady=gy.levels)


build_track_pyramids_jit = functools.partial(
    jax.jit, static_argnames=("cfg",))(build_track_pyramids)


def _bounds_ok(x: jax.Array, y: jax.Array, hw: int, hh: int,
               ncols: int, nrows: int) -> jax.Array:
    """Window-fits-in-image test, matching the reference's inequalities
    (trackFeatures.py -> _trackFeature entry checks)."""
    return ((x - hw >= 0.0) & (ncols - (x + hw) >= _ONE_PLUS_EPS) &
            (y - hh >= 0.0) & (nrows - (y + hh) >= _ONE_PLUS_EPS))


def _gather3(imga, imgb, imgc, x, y, hw: int, hh: int):
    """Three bilinear windows at the SAME per-feature positions, sharing
    one set of patch indices (one index computation, three patch reads,
    shared fractional blend). Values equal three gather_window calls."""
    rows, cols, ax, ay = patch_indices(imga.shape, x, y, hw, hh)
    return (window_from_patch(imga[rows, cols], ax, ay),
            window_from_patch(imgb[rows, cols], ax, ay),
            window_from_patch(imgc[rows, cols], ax, ay))


def _window_terms(w1, g1x, g1y, img2, gx2, gy2, x2, y2,
                  hw, hh, lighting_insensitive: bool):
    """Residual window and summed-gradient windows for one LK step.

    ``w1``/``g1x``/``g1y`` are the frame-1 windows, hoisted out of the
    iteration loop (the frame-1 position is constant per level — the
    reference re-interpolates them every iteration; same values, 2x fewer
    gathers). Returns (imgdiff, gx, gy), each [N, h, w].
    Reference parity: trackFeatures.py -> _computeIntensityDifference +
    _computeGradientSum (and the *LightingInsensitive variants).
    """
    w2, g2x, g2y = _gather3(img2, gx2, gy2, x2, y2, hw, hh)
    if not lighting_insensitive:
        return w1 - w2, g1x + g2x, g1y + g2y
    n = float((2 * hw + 1) * (2 * hh + 1))
    sum1_sq = jnp.sum(w1 * w1, axis=(-2, -1), keepdims=True)
    sum2_sq = jnp.sum(w2 * w2, axis=(-2, -1), keepdims=True)
    alpha = jnp.sqrt((sum1_sq / n) / (sum2_sq / n))
    mean1 = jnp.mean(w1, axis=(-2, -1), keepdims=True)
    mean2 = jnp.mean(w2, axis=(-2, -1), keepdims=True)
    beta = mean1 - alpha * mean2
    diff = w1 - w2 * alpha - beta
    return diff, g1x + alpha * g2x, g1y + alpha * g2y


def _residue_diff(w1, img2, x2, y2, hw, hh,
                  lighting_insensitive: bool):
    """Final residual window (post-convergence residue check). ``w1`` is
    the hoisted frame-1 window."""
    patch, ax, ay = gather_patch(img2, x2, y2, hw, hh)
    w2 = window_from_patch(patch, ax, ay)
    if not lighting_insensitive:
        return w1 - w2
    n = float((2 * hw + 1) * (2 * hh + 1))
    alpha = jnp.sqrt((jnp.sum(w1 * w1, axis=(-2, -1), keepdims=True) / n) /
                     (jnp.sum(w2 * w2, axis=(-2, -1), keepdims=True) / n))
    beta = (jnp.mean(w1, axis=(-2, -1), keepdims=True) -
            alpha * jnp.mean(w2, axis=(-2, -1), keepdims=True))
    return w1 - w2 * alpha - beta


class _LKState(NamedTuple):
    x2: jax.Array       # [N] current tracked position
    y2: jax.Array
    status: jax.Array   # [N] int32
    iteration: jax.Array  # [N] int32 completed updates
    active: jax.Array   # [N] bool — still iterating


def track_feature_level(x1, y1, x2, y2, img1, gx1, gy1, img2, gx2, gy2,
                        cfg, active_in) -> tuple[jax.Array, jax.Array,
                                                 jax.Array, jax.Array]:
    """One pyramid level of iterative translational LK for all features.

    Reference parity: trackFeatures.py -> _trackFeature, vectorized over
    features. ``active_in`` masks features still being tracked (lanes with
    False pass through unchanged with status KLT_TRACKED).

    Returns (x2, y2, status, iteration) with status in {TRACKED, OOB,
    SMALL_DET, LARGE_RESIDUE, MAX_ITERATIONS}.
    """
    hw, hh = cfg.window_width // 2, cfg.window_height // 2
    nrows, ncols = img1.shape
    th = jnp.float32(cfg.min_displacement)

    # Frame-1 windows are constant through the iteration loop: hoist them.
    w1, g1x, g1y = _gather3(img1, gx1, gy1, x1, y1, hw, hh)

    init = _LKState(
        x2=x2, y2=y2,
        status=jnp.full_like(x2, KLT_TRACKED, dtype=jnp.int32),
        iteration=jnp.zeros_like(x2, dtype=jnp.int32),
        active=active_in,
    )

    def body(_, st: _LKState) -> _LKState:
        ok = (_bounds_ok(x1, y1, hw, hh, ncols, nrows) &
              _bounds_ok(st.x2, st.y2, hw, hh, ncols, nrows))
        newly_oob = st.active & ~ok
        status = jnp.where(newly_oob, KLT_OOB, st.status)
        live = st.active & ok

        imgdiff, gx, gy = _window_terms(
            w1, g1x, g1y, img2, gx2, gy2, st.x2, st.y2,
            hw, hh, cfg.lighting_insensitive)

        gxx = jnp.sum(gx * gx, axis=(-2, -1))
        gxy = jnp.sum(gx * gy, axis=(-2, -1))
        gyy = jnp.sum(gy * gy, axis=(-2, -1))
        ex = cfg.step_factor * jnp.sum(imgdiff * gx, axis=(-2, -1))
        ey = cfg.step_factor * jnp.sum(imgdiff * gy, axis=(-2, -1))

        det = gxx * gyy - gxy * gxy
        small = det < cfg.min_determinant
        status = jnp.where(live & small, KLT_SMALL_DET, status)
        live = live & ~small

        safe_det = jnp.where(small, 1.0, det)
        dx = (gyy * ex - gxy * ey) / safe_det
        dy = (gxx * ey - gxy * ex) / safe_det

        nx2 = jnp.where(live, st.x2 + dx, st.x2)
        ny2 = jnp.where(live, st.y2 + dy, st.y2)
        niter = jnp.where(live, st.iteration + 1, st.iteration)

        moving = (jnp.abs(dx) >= th) | (jnp.abs(dy) >= th)
        still_active = live & moving & (niter < cfg.max_iterations)
        return _LKState(nx2, ny2, status, niter, still_active)

    st = lax.fori_loop(0, cfg.max_iterations, body, init)

    # Final bounds check on the tracked window only (overrides any status,
    # as in the reference).
    final_ok = _bounds_ok(st.x2, st.y2, hw, hh, ncols, nrows)
    status = jnp.where(active_in & ~final_ok, KLT_OOB, st.status)

    # Residue check, only for still-TRACKED lanes.
    diff = _residue_diff(w1, img2, st.x2, st.y2, hw, hh,
                         cfg.lighting_insensitive)
    residue = jnp.sum(jnp.abs(diff), axis=(-2, -1)) / float(
        cfg.window_width * cfg.window_height)
    tracked = active_in & (status == KLT_TRACKED)
    status = jnp.where(tracked & (residue > cfg.max_residue),
                       KLT_LARGE_RESIDUE, status)
    # Max-iterations comes after the residue check in the reference.
    tracked = active_in & (status == KLT_TRACKED)
    status = jnp.where(tracked & (st.iteration >= cfg.max_iterations),
                       KLT_MAX_ITERATIONS, status)
    return st.x2, st.y2, status, st.iteration


def track_level(x1, y1, x2, y2, img1, gx1, gy1, img2, gx2, gy2, cfg,
                active_in):
    """One LK level, by the fastest route for the platform it lowers on.

    On CUDA the level runs as one Pallas kernel (ops/lk_gpu) whenever
    ``lk_gpu.kernel_supported`` takes its shape; every other platform,
    and every level the gate refuses, runs track_feature_level. Both
    give the same statuses; positions agree to float rounding.

    Gradient rule: derivatives are always those of track_feature_level
    (the kernel's in-program while loop has no reverse-mode rule), so
    jax.grad / jax.jvp through a level work on every platform.
    """
    from . import lk_gpu
    args = (x1, y1, x2, y2, img1, gx1, gy1, img2, gx2, gy2)
    if not lk_gpu.kernel_supported(img1.shape, cfg):
        return track_feature_level(*args, cfg, active_in)
    return _kernel_or_xla_level(*args, cfg, active_in)


@functools.partial(jax.custom_jvp, nondiff_argnums=(10,))
def _kernel_or_xla_level(x1, y1, x2, y2, img1, gx1, gy1, img2, gx2, gy2,
                         cfg, active_in):
    from . import lk_gpu
    return lax.platform_dependent(
        x1, y1, x2, y2, img1, gx1, gy1, img2, gx2, gy2, active_in,
        cuda=lambda *a: lk_gpu.track_level_kernel(*a[:10], cfg, a[10]),
        default=lambda *a: track_feature_level(*a[:10], cfg, a[10]))


@_kernel_or_xla_level.defjvp
def _kernel_or_xla_level_jvp(cfg, primals, tangents):
    return jax.jvp(lambda *a: track_feature_level(*a[:10], cfg, a[10]),
                   primals, tangents)


@functools.partial(jax.jit, static_argnames=("cfg",))
def track_features_pyramids(pyr1: TrackPyramids, pyr2: TrackPyramids,
                            x: jax.Array, y: jax.Array, val: jax.Array,
                            cfg, *, x_init=None, y_init=None
                            ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Pyramidal LK over a feature batch given prebuilt pyramids.

    Reference parity: trackFeatures.py -> KLTTrackFeatures feature loop +
    coarse-to-fine level loop. Returns (x, y, val) arrays; lost features
    get (-1, -1, status).

    ``x_init``/``y_init`` (beyond-reference): guided tracking — start the
    frame-2 search at these positions instead of at (x, y). Lets callers
    with an external motion prior (e.g. a landmark projected through an
    estimated pose — sfm/loop.py) converge across displacements far
    beyond the pyramid search range. Default (None) is exactly the
    reference behavior.
    """
    nrows, ncols = pyr1.img[0].shape
    s = float(cfg.subsampling)
    n_levels = cfg.nPyramidLevels

    live = val >= 0

    # project to coarsest level
    scale = s ** n_levels
    xloc = x / scale
    yloc = y / scale
    if x_init is None:
        xout, yout = xloc, yloc
    else:
        xout = x_init / scale
        yout = y_init / scale

    status = jnp.full_like(val, KLT_TRACKED)
    # 'broken' freezes lanes that hit SMALL_DET / OOB at a coarser level
    # (the reference breaks out of the level loop for those two codes only).
    broken = jnp.zeros_like(live)

    for r in range(n_levels - 1, -1, -1):
        xloc, yloc = xloc * s, yloc * s
        # Lanes broken at a coarser level keep their break-level coords:
        # the reference breaks its level loop and runs the final border
        # check on the un-rescaled position (oracle track_features).
        xout = jnp.where(broken, xout, xout * s)
        yout = jnp.where(broken, yout, yout * s)
        active = live & ~broken
        with jax.named_scope(f"pft.lk_level_{r}"):
            nx, ny, lvl_status, _ = track_level(
                xloc, yloc, xout, yout,
                pyr1.img[r], pyr1.gradx[r], pyr1.grady[r],
                pyr2.img[r], pyr2.gradx[r], pyr2.grady[r], cfg, active)
        xout = jnp.where(active, nx, xout)
        yout = jnp.where(active, ny, yout)
        status = jnp.where(active, lvl_status, status)
        broken = broken | (active & ((lvl_status == KLT_SMALL_DET) |
                                     (lvl_status == KLT_OOB)))

    # Final classification (reference: KLTTrackFeatures post-loop).
    out_of_view = ((xout < cfg.borderx) | (xout > ncols - 1 - cfg.borderx) |
                   (yout < cfg.bordery) | (yout > nrows - 1 - cfg.bordery))
    lost = (status != KLT_TRACKED) | out_of_view
    final_status = jnp.where(
        status == KLT_OOB, KLT_OOB,
        jnp.where(out_of_view, KLT_OOB, status))

    new_x = jnp.where(live, jnp.where(lost, -1.0, xout), x)
    new_y = jnp.where(live, jnp.where(lost, -1.0, yout), y)
    new_val = jnp.where(live, final_status, val)
    return new_x, new_y, new_val


@functools.partial(jax.jit, static_argnames=("cfg",
                                              "fb_max_displacement"))
def fb_reject(pyr1: TrackPyramids, pyr2: TrackPyramids,
              x0: jax.Array, y0: jax.Array, nx: jax.Array,
              ny: jax.Array, nval: jax.Array, cfg,
              fb_max_displacement: float = 0.5
              ) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Backward half of the forward-backward gate: given a completed
    forward track (x0, y0) -> (nx, ny, nval), re-track 2->1 and reject
    lanes whose round trip misses (x0, y0) by more than
    ``fb_max_displacement`` px (or whose backward track fails). Lets
    drivers that already ran the forward pass (e.g. through the affine
    stage) add the gate without re-tracking.
    """
    from ..features import KLT_FB_INCONSISTENT
    # backward pass: lanes lost forward carry nval < 0 -> inactive
    bx, by, bval = track_features_pyramids(pyr2, pyr1, nx, ny, nval, cfg)
    fwd_ok = nval == KLT_TRACKED
    bwd_ok = bval == KLT_TRACKED
    err = jnp.hypot(bx - x0, by - y0)
    err = jnp.where(fwd_ok & bwd_ok, err, jnp.inf)
    bad = fwd_ok & (err > fb_max_displacement)
    out_val = jnp.where(bad, KLT_FB_INCONSISTENT, nval)
    out_x = jnp.where(bad, -1.0, nx)
    out_y = jnp.where(bad, -1.0, ny)
    return out_x, out_y, out_val, err


@functools.partial(jax.jit, static_argnames=("cfg",
                                              "fb_max_displacement"))
def track_features_pyramids_fb(pyr1: TrackPyramids, pyr2: TrackPyramids,
                               x: jax.Array, y: jax.Array,
                               val: jax.Array, cfg,
                               fb_max_displacement: float = 0.5
                               ) -> tuple[jax.Array, jax.Array,
                                          jax.Array, jax.Array]:
    """Forward-backward consistency tracking (beyond-reference quality
    gate): track 1->2, re-track the results 2->1, and reject lanes whose
    round trip misses the start by more than ``fb_max_displacement`` px
    (or whose backward track fails). Rejected lanes get
    KLT_FB_INCONSISTENT and (-1, -1), like any other lost status.

    Returns (x, y, val, fb_err) — fb_err is the round-trip distance per
    lane (inf where the forward or backward track failed), useful as a
    per-track quality score.
    """
    nx, ny, nval = track_features_pyramids(pyr1, pyr2, x, y, val, cfg)
    return fb_reject(pyr1, pyr2, x, y, nx, ny, nval, cfg,
                     fb_max_displacement=fb_max_displacement)


def track_features(img1, img2, fl, cfg, pyr1: TrackPyramids | None = None):
    """High-level tracking entry: images in, updated FeatureState out.

    Reference parity: trackFeatures.py -> KLTTrackFeatures. Returns
    (new_fl, pyr2) where ``pyr2`` is the frame-2 pyramid cache to pass back
    in sequential mode (the reference stashes it on the context).
    """
    from ..errors import KLTGetVerbosity, verbose_print
    cfg = cfg.validated_window()
    if pyr1 is None:
        pyr1 = build_track_pyramids_jit(stage_f32(img1), cfg)
    pyr2 = build_track_pyramids_jit(stage_f32(img2), cfg)
    nrows, ncols = pyr2.img[0].shape
    verbose_print(f"(KLT) Tracking {fl.nFeatures} features in a "
                  f"{ncols} by {nrows} image...  ")
    nx, ny, nval = track_features_pyramids(pyr1, pyr2, fl.x, fl.y, fl.val,
                                           cfg)
    out = fl._replace(x=nx, y=ny, val=nval)
    if KLTGetVerbosity() > 0:
        import numpy as _np
        verbose_print(f"\t{int((_np.asarray(nval) >= 0).sum())} features "
                      "successfully tracked.")
    return out, pyr2
