"""Dense rectified-stereo disparity — the tracker's 1-D LK at every pixel.

Beyond-reference modality completing the stereo story: sfm/stereo.py
matches SPARSE features across a rectified pair (multi-hypothesis guided
LK); this module produces DENSE disparity/depth maps with the same
conventions (disparity = x_L - x_R >= 0; right-image sample at x - d;
metric depth z = fx * baseline / d — sfm/stereo.stereo_depth).

On a rectified pair the correspondence is constrained to the horizontal
epipolar line, so the per-pixel solve is the 1-D specialization of the
tracker's level op (ops/track.track_feature_level): same window gathers,
same symmetric two-frame gradient, but a SCALAR normal equation
du = step_factor * sum(diff*gx) / sum(gx*gx) with the vertical
displacement pinned to zero. Status codes keep the reference semantics
(klt.py constants), with KLT_SMALL_DET triggered by the 1-D analogue
gxx < min_determinant.

Large disparities are handled the way production stereo does it rather
than by inflating the pyramid (sfm/stereo.py documents why the
derived-parameter route breaks on modest images): at the COARSEST level
an integer-shift SSD sweep (box-filtered squared difference per
candidate disparity, spaced about half a window apart) seeds each pixel
with the best hypothesis, and coarse-to-fine 1-D LK refines from there.

Left-right consistency (dense_disparity_lr) reuses the horizontal-flip
trick: matching right->left on fliplr'd images is again a positive-
disparity problem, so ONE implementation serves both directions; pixels
whose two disparities disagree are occlusions, exactly like the
forward-backward gate on dense flow (ops/flow.flow_consistency).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..features import (KLT_LARGE_RESIDUE, KLT_MAX_ITERATIONS, KLT_OOB,
                        KLT_SMALL_DET, KLT_TRACKED)
from .flow import upsample_flow
from .track import TrackPyramids, _bounds_ok, _gather3, _residue_diff


class DenseDisparity(NamedTuple):
    """Per-pixel disparity map + KLT status map for one rectified pair."""
    d: jax.Array       # [H, W] float32, disparity x_L - x_R (>= 0 valid)
    status: jax.Array  # [H, W] int32, KLT status codes


def _box_sum(a: jax.Array, hw: int, hh: int) -> jax.Array:
    """Zero-padded window sum over (2*hh+1, 2*hw+1) boxes, same shape
    (integral-image form; exact for the float32 test sizes used here)."""
    pad = jnp.pad(a, ((hh + 1, hh), (hw + 1, hw)))
    c = jnp.cumsum(jnp.cumsum(pad, axis=0), axis=1)
    wh, ww = 2 * hh + 1, 2 * hw + 1
    return (c[wh:, ww:] - c[:-wh, ww:] - c[wh:, :-ww] + c[:-wh, :-ww])


def _hypothesis_init(img1: jax.Array, img2: jax.Array,
                     hypotheses: tuple[int, ...], hw: int, hh: int
                     ) -> jax.Array:
    """Integer-disparity SSD sweep: for each candidate shift h, window-
    summed (img1[y,x] - img2[y,x-h])^2; returns the per-pixel argmin as
    a float32 disparity map. Centers whose shifted window leaves the
    right image are penalized out of the running (their disparity is
    unobservable — they stay at the smallest feasible candidate)."""
    h_img, w_img = img1.shape
    xs = jnp.arange(w_img, dtype=jnp.float32)[None, :]
    big = jnp.float32(3.4e38)
    ssds = []
    for h in hypotheses:
        shifted = jnp.pad(img2, ((0, 0), (h, 0)))[:, :w_img]
        ssd = _box_sum((img1 - shifted) ** 2, hw, hh)
        ssds.append(ssd + jnp.where(xs < h + hw, big, 0.0))
    best = jnp.argmin(jnp.stack(ssds), axis=0)
    return jnp.asarray(hypotheses, jnp.float32)[best]


def disparity_level(img1, gx1, gy1, img2, gx2, gy2, d, cfg
                    ) -> tuple[jax.Array, jax.Array]:
    """One pyramid level of dense 1-D LK: refine the disparity map ``d``
    (right-image window at (x - d, y)). Returns (d, status) maps.

    Mirrors ops/track.track_feature_level's masked fixed-trip loop and
    status priorities exactly, specialized to the horizontal axis.
    It runs as XLA on every platform: the GPU level kernel
    (ops/lk_gpu) covers the 2-D tracker only."""
    nrows, ncols = img1.shape
    hw, hh = cfg.window_width // 2, cfg.window_height // 2
    th = jnp.float32(cfg.min_displacement)

    xg = jnp.tile(jnp.arange(ncols, dtype=jnp.float32)[None, :],
                  (nrows, 1))
    yg = jnp.tile(jnp.arange(nrows, dtype=jnp.float32)[:, None],
                  (1, ncols))
    x1 = xg.ravel()
    y1 = yg.ravel()
    x2 = x1 - d.ravel()

    w1, g1x, g1y = _gather3(img1, gx1, gy1, x1, y1, hw, hh)
    ok1 = _bounds_ok(x1, y1, hw, hh, ncols, nrows)

    def body(_, st):
        x2, status, iteration, active = st
        ok = ok1 & _bounds_ok(x2, y1, hw, hh, ncols, nrows)
        status = jnp.where(active & ~ok, KLT_OOB, status)
        live = active & ok

        w2, g2x, _ = _gather3(img2, gx2, gy2, x2, y1, hw, hh)
        diff = w1 - w2
        gx = g1x + g2x
        gxx = jnp.sum(gx * gx, axis=(-2, -1))
        ex = cfg.step_factor * jnp.sum(diff * gx, axis=(-2, -1))

        small = gxx < cfg.min_determinant
        status = jnp.where(live & small, KLT_SMALL_DET, status)
        live = live & ~small
        du = ex / jnp.where(small, 1.0, gxx)

        nx2 = jnp.where(live, x2 + du, x2)
        niter = jnp.where(live, iteration + 1, iteration)
        moving = jnp.abs(du) >= th
        still = live & moving & (niter < cfg.max_iterations)
        return (nx2, status, niter, still)

    init = (x2, jnp.full_like(x2, KLT_TRACKED, dtype=jnp.int32),
            jnp.zeros_like(x2, dtype=jnp.int32),
            jnp.ones_like(x2, dtype=bool))
    x2, status, iteration, _ = lax.fori_loop(0, cfg.max_iterations,
                                             body, init)

    final_ok = _bounds_ok(x2, y1, hw, hh, ncols, nrows)
    status = jnp.where(~final_ok, KLT_OOB, status)
    rdiff = _residue_diff(w1, img2, x2, y1, hw, hh, False)
    residue = jnp.sum(jnp.abs(rdiff), axis=(-2, -1)) / float(
        cfg.window_width * cfg.window_height)
    tracked = status == KLT_TRACKED
    status = jnp.where(tracked & (residue > cfg.max_residue),
                       KLT_LARGE_RESIDUE, status)
    tracked = status == KLT_TRACKED
    status = jnp.where(tracked & (iteration >= cfg.max_iterations),
                       KLT_MAX_ITERATIONS, status)
    return ((x1 - x2).reshape(nrows, ncols),
            status.reshape(nrows, ncols))


@functools.partial(jax.jit, static_argnames=("cfg", "max_disparity",
                                             "hypothesis_stride"))
def dense_disparity_pyramids(pyr_l: TrackPyramids, pyr_r: TrackPyramids,
                             cfg, max_disparity: float = 64.0,
                             hypothesis_stride: int | None = None
                             ) -> DenseDisparity:
    """Coarse-to-fine dense disparity over prebuilt pyramids (the
    stereo analogue of ops/flow.dense_flow_pyramids). The coarsest
    level seeds from the SSD hypothesis sweep; each finer level refines
    the upsampled map. The status map is the finest level's."""
    s = float(cfg.subsampling)
    n_levels = cfg.nPyramidLevels
    hw, hh = cfg.window_width // 2, cfg.window_height // 2
    if hypothesis_stride is None:
        hypothesis_stride = hw + 1

    coarse_img_l = pyr_l.img[n_levels - 1].astype(jnp.float32)
    coarse_img_r = pyr_r.img[n_levels - 1].astype(jnp.float32)
    max_d_coarse = int(max_disparity / s ** (n_levels - 1))
    hypotheses = tuple(range(0, max_d_coarse + 1, int(hypothesis_stride)))
    if len(hypotheses) > 1:
        with jax.named_scope("pft.disparity_hypotheses"):
            d = _hypothesis_init(coarse_img_l, coarse_img_r, hypotheses,
                                 hw, hh)
    else:
        d = jnp.zeros(coarse_img_l.shape, jnp.float32)

    status = None
    for r in range(n_levels - 1, -1, -1):
        shape = pyr_l.img[r].shape
        if shape != d.shape:
            d = upsample_flow(d, shape, s)
        lvl = tuple(
            p[r].astype(jnp.float32)
            for p in (pyr_l.img, pyr_l.gradx, pyr_l.grady,
                      pyr_r.img, pyr_r.gradx, pyr_r.grady))
        with jax.named_scope(f"pft.disparity_level_{r}"):
            d, status = disparity_level(*lvl, d, cfg)
    return DenseDisparity(d=d, status=status)


def dense_disparity(left, right, cfg=None, max_disparity: float = 64.0
                    ) -> DenseDisparity:
    """High-level entry: dense disparity map for one rectified pair
    (images in any array form; uint8 staged host-side per the staging
    rule)."""
    from ..config import create_config
    from ..utils.staging import stage_f32
    from .track import build_track_pyramids_jit

    cfg = (cfg or create_config()).validated_window()
    p_l = build_track_pyramids_jit(stage_f32(left), cfg)
    p_r = build_track_pyramids_jit(stage_f32(right), cfg)
    return dense_disparity_pyramids(p_l, p_r, cfg,
                                    max_disparity=float(max_disparity))


def disparity_lr_consistency(dl: DenseDisparity, dr: DenseDisparity,
                             max_err: float = 1.0,
                             min_disparity: float = 0.25,
                             max_disparity: float = 64.0
                             ) -> tuple[jax.Array, jax.Array]:
    """Left-right consistency gate. ``dr`` is the RIGHT-reference map in
    right-image coordinates (from dense_disparity on the fliplr'd pair,
    flipped back — see dense_disparity_lr). err(p) = |d_L(p) -
    d_R(p - d_L(p))|; valid needs both statuses TRACKED at the linked
    pixels, err <= max_err, and d_L within [min, max] disparity."""
    h, w = dl.d.shape
    lx = jnp.clip(jnp.round(
        jnp.arange(w, dtype=dl.d.dtype)[None, :] - dl.d), 0,
        w - 1).astype(jnp.int32)
    ly = jnp.tile(jnp.arange(h, dtype=jnp.int32)[:, None], (1, w))
    err = jnp.abs(dl.d - dr.d[ly, lx])
    valid = ((dl.status == KLT_TRACKED) & (dr.status[ly, lx] == 0) &
             (err <= max_err) & (dl.d >= min_disparity) &
             (dl.d <= max_disparity))
    return err, valid


def dense_disparity_lr(left, right, cfg=None,
                       max_disparity: float = 64.0,
                       max_err: float = 1.0
                       ) -> tuple[DenseDisparity, jax.Array, jax.Array]:
    """Dense disparity with the left-right occlusion gate: returns
    (left-reference DenseDisparity, LR error map, valid mask). The
    right-reference pass runs on horizontally flipped images (matching
    right->left is then again a positive-disparity problem)."""
    from ..config import create_config
    from ..utils.staging import stage_f32
    from .track import build_track_pyramids_jit

    cfg = (cfg or create_config()).validated_window()
    li = stage_f32(left)
    ri = stage_f32(right)
    p_l = build_track_pyramids_jit(li, cfg)
    p_r = build_track_pyramids_jit(ri, cfg)
    dl = dense_disparity_pyramids(p_l, p_r, cfg,
                                  max_disparity=float(max_disparity))
    p_rf = build_track_pyramids_jit(jnp.fliplr(ri), cfg)
    p_lf = build_track_pyramids_jit(jnp.fliplr(li), cfg)
    drf = dense_disparity_pyramids(p_rf, p_lf, cfg,
                                   max_disparity=float(max_disparity))
    dr = DenseDisparity(d=jnp.fliplr(drf.d),
                        status=jnp.fliplr(drf.status))
    err, valid = disparity_lr_consistency(dl, dr, max_err=max_err,
                                          max_disparity=max_disparity)
    return dl, err, valid


def dense_depth(left, right, K, baseline: float, cfg=None,
                max_disparity: float = 64.0, max_err: float = 1.0):
    """Metric dense depth map from one rectified pair: returns (depth
    [H, W] float32 with invalid pixels at 0, disparity map, valid mask).
    Scale comes from the physical ``baseline`` (sfm/stereo.stereo_depth
    convention: z = fx * baseline / d)."""
    import numpy as np

    dl, _, valid = dense_disparity_lr(left, right, cfg,
                                      max_disparity=max_disparity,
                                      max_err=max_err)
    d = np.asarray(dl.d)
    v = np.asarray(valid)
    fx = float(np.asarray(K)[0, 0])
    depth = np.where(v, fx * float(baseline) / np.maximum(d, 1e-9),
                     0.0).astype(np.float32)
    return depth, d, v
