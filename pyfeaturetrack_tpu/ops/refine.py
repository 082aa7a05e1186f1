"""Sub-pixel corner refinement (beyond-reference).

The reference (selectGoodFeatures.py) returns integer pixel corners —
the min-eigenvalue scan casts candidate coordinates to int and the
greedy suppression keeps them there, so every selected feature starts
with up to half a pixel of localization error that the tracker then
carries. This module refines each corner to sub-pixel accuracy with
the classic gradient-orthogonality iteration (Förstner / OpenCV
``cornerSubPix``): for the true corner q, every image gradient
∇I(p) in a neighborhood is orthogonal to (q − p), so q solves

    [ Σ ∇I∇Iᵀ ] q = Σ (∇I∇Iᵀ) p        over the window around q.

Batched shape: all N features iterate together — batched bilinear window
gathers of the gradient images (ops/interp.gather_window, the same
machinery as the tracker), per-feature 2×2 normal systems solved in
closed form (no lax LinAlg — DESIGN.md rule 1), a fixed-trip
``fori_loop`` with per-lane convergence/out-of-bounds masks. One jitted
program; differentiable like the rest of the compute path.

Verified against a float64 NumPy mirror and on rendered corners with
known sub-pixel positions (tests/test_refine.py): recovered to
≲0.03 px from integer-pixel starts. Wired into the sequence drivers as
``SequenceTracker(subpixel_refine=True)`` / CLI ``--subpixel`` —
refines newly SELECTED features only (initial selection + refills);
re-tracked positions are never moved.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from .convolve import compute_gradients, compute_smoothed_image, to_float_image
from .interp import gather_window, window_coords


@functools.partial(jax.jit,
                   static_argnames=("half_win", "n_iters"))
def refine_corners(gradx: jax.Array, grady: jax.Array, x: jax.Array,
                   y: jax.Array, *, half_win: int = 5, n_iters: int = 5,
                   min_displacement: float = 0.01,
                   eps: float = 1e-6) -> tuple[jax.Array, jax.Array]:
    """Refine corner positions to sub-pixel accuracy on gradient images.

    ``gradx``/``grady``: [H, W] image gradients. ``x``/``y``: [N]
    initial positions (typically integer-pixel selection output).
    Returns refined (x, y); lanes whose window would leave the image or
    whose structure tensor is degenerate (|det| < eps) keep their input
    position. Each iteration moves at most the window radius (guard
    against runaway steps on pathological inputs).
    """
    nrows, ncols = gradx.shape
    hw = half_win

    def in_bounds(xf, yf):
        # window + bilinear tap must fit (floor+1 read on the high side)
        return ((xf - hw >= 0.0) & (xf + hw + 1.001 <= ncols - 1) &
                (yf - hw >= 0.0) & (yf + hw + 1.001 <= nrows - 1))

    def body(_, st):
        cx, cy, active = st
        ok = active & in_bounds(cx, cy)
        gxw = gather_window(gradx, cx, cy, hw, hw)   # [N, w, w]
        gyw = gather_window(grady, cx, cy, hw, hw)
        xs, ys = window_coords(cx, cy, hw, hw)       # sample coords
        gxx = jnp.sum(gxw * gxw, axis=(-2, -1))
        gxy = jnp.sum(gxw * gyw, axis=(-2, -1))
        gyy = jnp.sum(gyw * gyw, axis=(-2, -1))
        bx = jnp.sum((gxw * gxw) * xs + (gxw * gyw) * ys, axis=(-2, -1))
        by = jnp.sum((gxw * gyw) * xs + (gyw * gyw) * ys, axis=(-2, -1))
        det = gxx * gyy - gxy * gxy
        safe = jnp.where(jnp.abs(det) < eps, 1.0, det)
        qx = (gyy * bx - gxy * by) / safe
        qy = (gxx * by - gxy * bx) / safe
        dx = jnp.clip(qx - cx, -float(hw), float(hw))
        dy = jnp.clip(qy - cy, -float(hw), float(hw))
        upd = ok & (jnp.abs(det) >= eps)
        nx = jnp.where(upd, cx + dx, cx)
        ny = jnp.where(upd, cy + dy, cy)
        moving = (jnp.abs(dx) >= min_displacement) | \
                 (jnp.abs(dy) >= min_displacement)
        return (nx, ny, upd & moving)

    x = x.astype(jnp.float32)
    y = y.astype(jnp.float32)
    active = jnp.ones(x.shape, bool)
    rx, ry, _ = lax.fori_loop(0, n_iters, body, (x, y, active))
    return rx, ry


def refine_features_subpixel(img, fl, cfg, *, half_win: int = 5,
                             n_iters: int = 5):
    """Sub-pixel-refine a selected FeatureState against ``img``.

    Computes the selection-stage gradients (smoothed per
    ``cfg.smoothBeforeSelecting``, σ = cfg.grad_sigma — the same images
    the min-eig scan scored) and moves every live feature (val >= 0) to
    its sub-pixel corner. Dead lanes pass through untouched.
    """
    fimg = to_float_image(img)
    if cfg.smoothBeforeSelecting:
        fimg = compute_smoothed_image(fimg, cfg.smooth_sigma)
    gradx, grady = compute_gradients(fimg, cfg.grad_sigma)
    rx, ry = refine_corners(gradx, grady, fl.x, fl.y,
                            half_win=half_win, n_iters=n_iters)
    live = fl.val >= 0
    return fl._replace(x=jnp.where(live, rx, fl.x),
                       y=jnp.where(live, ry, fl.y))
