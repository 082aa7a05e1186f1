"""Batched affine-consistency check.

Reference parity: trackFeatures.py -> _am_trackFeatureAffine /
_am_getSubFloatImage / _am_getGradientWinAffine /
_am_computeIntensityDifferenceAffine / _am_compute{6by6,4by4}GradientMatrix /
_am_compute{6by1,4by1}ErrorVector / _am_gauss_jordan_elimination
(SURVEY.md section 3.3). Semantics defined by the float64 oracle
(oracle/affine_oracle.py — the executable spec, since the reference mount
was empty).

After successful translational tracking, each feature's position is
re-verified (and refined) against its FIRST-frame template under a warp:

  affineConsistencyCheck = 0 -> translation re-check    (2 params)
  affineConsistencyCheck = 1 -> similarity              (4 params)
  affineConsistencyCheck = 2 -> full affine             (6 params)

Batched shape: all features iterate together through a fixed-trip Gauss-Newton
loop with lane masking; the per-feature PxP normal systems are solved as
one batched ``jnp.linalg.solve`` (the reference's sequential Gauss-Jordan
becomes one batched [N, P, P] solve). The template store rides in
``AffineState`` ([N, T, T] arrays), captured with batched bilinear gathers
the first frame a feature tracks successfully; the warp A persists across
frames exactly like the reference's per-feature aff_* fields.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..features import (KLT_LARGE_RESIDUE, KLT_OOB, KLT_SMALL_DET,
                        KLT_TRACKED, AffineState, FeatureState)
from .interp import bilinear, gather_window
from .linalg import gauss_solve_det

_ONE_PLUS_EPS = 1.001


def make_affine_state(n_features: int, cfg) -> AffineState:
    """Empty affine template store sized for ``cfg``'s affine window."""
    th, tw = cfg.affine_window_height, cfg.affine_window_width
    return AffineState(
        img=jnp.zeros((n_features, th, tw), jnp.float32),
        gradx=jnp.zeros((n_features, th, tw), jnp.float32),
        grady=jnp.zeros((n_features, th, tw), jnp.float32),
        x=jnp.zeros((n_features,), jnp.float32),
        y=jnp.zeros((n_features,), jnp.float32),
        A=jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32),
                           (n_features, 2, 2)),
        valid=jnp.zeros((n_features,), bool),
    )


def _warp_coords(x, y, A, hw: int, hh: int):
    """Affine-warped window sample coordinates [N, h, w]."""
    ii = jnp.arange(-hw, hw + 1, dtype=x.dtype)[None, None, :]
    jj = jnp.arange(-hh, hh + 1, dtype=y.dtype)[None, :, None]
    xs = x[:, None, None] + A[:, 0, 0, None, None] * ii + A[:, 0, 1, None, None] * jj
    ys = y[:, None, None] + A[:, 1, 0, None, None] * ii + A[:, 1, 1, None, None] * jj
    return jnp.broadcast_arrays(xs, ys)


def _warp_oob(xs, ys, ncols: int, nrows: int):
    """Any warped sample outside the image -> lane is OOB."""
    bad = ((xs < 0.0) | (ncols - xs < _ONE_PLUS_EPS) |
           (ys < 0.0) | (nrows - ys < _ONE_PLUS_EPS))
    return jnp.any(bad, axis=(-2, -1))


def _jacobian(gxw, gyw, hw: int, hh: int, mode: int):
    """[N, P, h*w] Gauss-Newton Jacobian rows (see oracle _jacobian)."""
    n = gxw.shape[0]
    ii = jnp.arange(-hw, hw + 1, dtype=gxw.dtype)[None, None, :]
    jj = jnp.arange(-hh, hh + 1, dtype=gxw.dtype)[None, :, None]
    ii = jnp.broadcast_to(ii, gxw.shape)
    jj = jnp.broadcast_to(jj, gxw.shape)
    if mode == 0:
        rows = [gxw, gyw]
    elif mode == 1:
        rows = [gxw * ii + gyw * jj, -gxw * jj + gyw * ii, gxw, gyw]
    else:
        rows = [gxw * ii, gyw * ii, gxw * jj, gyw * jj, gxw, gyw]
    return jnp.stack([r.reshape(n, -1) for r in rows], axis=1)


class _GNState(NamedTuple):
    x: jax.Array
    y: jax.Array
    A: jax.Array       # [N, 2, 2]
    status: jax.Array  # [N] int32
    active: jax.Array  # [N] bool


@functools.partial(jax.jit, static_argnames=("cfg",))
def _affine_track_batch(tmpl, img2, gx2, gy2, x0, y0, A0, check, cfg):
    """Batched Gauss-Newton template matching (oracle:
    am_track_feature_affine, vectorized). Returns (x, y, A, status)."""
    mode = int(cfg.affineConsistencyCheck)
    hw, hh = cfg.affine_window_width // 2, cfg.affine_window_height // 2
    nrows, ncols = img2.shape
    init = _GNState(
        x=x0, y=y0, A=A0,
        status=jnp.full(x0.shape, KLT_TRACKED, jnp.int32),
        active=check,
    )

    def body(_, st: _GNState) -> _GNState:
        xs, ys = _warp_coords(st.x, st.y, st.A, hw, hh)
        oob = _warp_oob(xs, ys, ncols, nrows)
        status = jnp.where(st.active & oob, KLT_OOB, st.status)
        live = st.active & ~oob

        I2w = bilinear(img2, xs, ys)
        gxw = bilinear(gx2, xs, ys)
        gyw = bilinear(gy2, xs, ys)
        diff = (tmpl - I2w).reshape(x0.shape[0], -1)

        J = _jacobian(gxw, gyw, hw, hh, mode)
        T = jnp.einsum("npk,nqk->npq", J, J,
                       precision=lax.Precision.HIGHEST)
        e = jnp.einsum("npk,nk->np", J, diff,
                       precision=lax.Precision.HIGHEST)

        # Batched unpivoted Gauss-Jordan (= the reference's
        # _am_gauss_jordan_elimination, vectorized): no pivoting, so the
        # [N, P, P] batch vectorizes (see ops/linalg).
        d, det = gauss_solve_det(T, e)
        small = jnp.abs(det) < cfg.min_determinant
        status = jnp.where(live & small, KLT_SMALL_DET, status)
        live = live & ~small

        if mode == 0:
            dA = jnp.zeros_like(st.A)
            dx, dy = d[:, 0], d[:, 1]
        elif mode == 1:
            dA = jnp.stack([jnp.stack([d[:, 0], -d[:, 1]], -1),
                            jnp.stack([d[:, 1], d[:, 0]], -1)], -2)
            dx, dy = d[:, 2], d[:, 3]
        else:
            dA = jnp.stack([jnp.stack([d[:, 0], d[:, 2]], -1),
                            jnp.stack([d[:, 1], d[:, 3]], -1)], -2)
            dx, dy = d[:, 4], d[:, 5]

        nx = jnp.where(live, st.x + dx, st.x)
        ny = jnp.where(live, st.y + dy, st.y)
        nA = jnp.where(live[:, None, None], st.A + dA, st.A)

        converged = ((jnp.abs(dx) < cfg.affine_min_displacement) &
                     (jnp.abs(dy) < cfg.affine_min_displacement))
        return _GNState(nx, ny, nA, status, live & ~converged)

    st = lax.fori_loop(0, cfg.affine_max_iterations, body, init)

    # Post-loop: final warp OOB, residue, drift (oracle post section).
    xs, ys = _warp_coords(st.x, st.y, st.A, hw, hh)
    final_oob = _warp_oob(xs, ys, ncols, nrows)
    status = jnp.where(check & (st.status == KLT_TRACKED) & final_oob,
                       KLT_OOB, st.status)

    I2w = bilinear(img2, xs, ys)
    residue = jnp.sum(jnp.abs(tmpl - I2w), axis=(-2, -1)) / float(
        cfg.affine_window_width * cfg.affine_window_height)
    tracked = check & (status == KLT_TRACKED)
    status = jnp.where(tracked & (residue > cfg.affine_max_residue),
                       KLT_LARGE_RESIDUE, status)

    drift = jnp.maximum(jnp.abs(st.x - x0), jnp.abs(st.y - y0))
    tracked = check & (status == KLT_TRACKED)
    status = jnp.where(tracked & (drift > cfg.affine_max_displacement_differ),
                       KLT_OOB, status)
    return st.x, st.y, st.A, status


def affine_consistency_check(pyr1, pyr2, fl_before: FeatureState,
                             fl_after: FeatureState, cfg) -> FeatureState:
    """Post-tracking affine verification stage.

    Reference parity: trackFeatures.py -> KLTTrackFeatures affine branch.
    ``pyr1``/``pyr2`` are the TrackPyramids of the two frames (level 0 =
    smoothed full-res image + gradients, exactly what the reference's
    pyramid1/pyramid2 provide). ``fl_before`` holds pre-track positions
    (template anchors); ``fl_after`` the translation-tracked result.
    """
    hw, hh = cfg.affine_window_width // 2, cfg.affine_window_height // 2
    aff = fl_after.aff
    if aff is None or aff.img.shape[-1] != cfg.affine_window_width:
        aff = make_affine_state(fl_after.nFeatures, cfg)

    tracked = fl_after.val == KLT_TRACKED
    # Lanes lost by translational tracking lose their template (the
    # reference frees aff_img on loss).
    eye = jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32), aff.A.shape)
    lost = (fl_before.val >= 0) & ~tracked
    aff = aff._replace(valid=aff.valid & ~lost,
                       A=jnp.where(lost[:, None, None], eye, aff.A))

    # First successful track -> capture template, skip the check this
    # frame. cond-gated: in steady state no lane needs capture and the
    # three [N, wh, ww] bilinear gathers are skipped entirely.
    need_capture = tracked & ~aff.valid
    img1s, gx1, gy1 = pyr1.img[0], pyr1.gradx[0], pyr1.grady[0]

    def capture(a):
        t_new = gather_window(img1s, fl_before.x, fl_before.y, hw, hh)
        tx_new = gather_window(gx1, fl_before.x, fl_before.y, hw, hh)
        ty_new = gather_window(gy1, fl_before.x, fl_before.y, hw, hh)
        cap = need_capture[:, None, None]
        return AffineState(
            img=jnp.where(cap, t_new, a.img),
            gradx=jnp.where(cap, tx_new, a.gradx),
            grady=jnp.where(cap, ty_new, a.grady),
            x=jnp.where(need_capture, fl_before.x, a.x),
            y=jnp.where(need_capture, fl_before.y, a.y),
            A=jnp.where(cap, jnp.eye(2, dtype=jnp.float32)[None], a.A),
            valid=a.valid | need_capture,
        )

    aff = lax.cond(jnp.any(need_capture), capture, lambda a: a, aff)

    check = tracked & aff.valid & ~need_capture

    x, y, A, status = _affine_track_batch(
        aff.img, pyr2.img[0], pyr2.gradx[0], pyr2.grady[0],
        fl_after.x, fl_after.y, aff.A, check, cfg)

    failed = check & (status != KLT_TRACKED)
    new_x = jnp.where(check, jnp.where(failed, -1.0, x), fl_after.x)
    new_y = jnp.where(check, jnp.where(failed, -1.0, y), fl_after.y)
    new_val = jnp.where(failed, status, fl_after.val)
    aff = aff._replace(
        A=jnp.where(check[:, None, None] & ~failed[:, None, None], A, aff.A),
        valid=aff.valid & ~failed,
    )
    return fl_after._replace(x=new_x, y=new_y, val=new_val, aff=aff)
