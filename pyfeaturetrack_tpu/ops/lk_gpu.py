"""One pyramid level of translational LK as one Pallas kernel for the GPU.

Same contract as ops/track.track_feature_level: every status rule, the
bounds test, the residue gate and the iteration cap are that function's,
in the same order. What differs is where the loop runs. XLA compiles
track_feature_level into a loop of ``max_iterations`` trips, each a
chain of small gather and reduce kernels over all lanes. Here one program
owns a block of ``FB`` features and runs the whole iteration loop itself,
exiting as soon as no lane of the block is live, so one launch covers the
level.

Layout, per program:

* windows are padded to the next power of two (7x7 -> 8x8) and flattened
  to ``P`` taps; padded taps are clamped onto the window's last row or
  column for the read and zeroed before any sum;
* level images stay in device memory, flattened, and are read by pointer
  gathers (integer-array indexing of the ref); a 480x640 level's six f32
  planes take 7.4 MB and sit in L2;
* bilinear windows are built from four taps with the shared fractional
  weights, in the same expression as ops/interp.window_from_patch.

The kernel has no matrix product, so TF32 never enters. Positions differ
from the XLA level only by FMA contraction and the order of the window
sums; statuses are decided by the same comparisons and agree except for
lanes sitting on a threshold.

Route: Pallas through Triton (``backend="triton"``), named explicitly.
``interpret=True`` runs the same kernel body on the CPU; only tests set it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..features import (KLT_LARGE_RESIDUE, KLT_MAX_ITERATIONS, KLT_OOB,
                        KLT_SMALL_DET, KLT_TRACKED)

# Features per program. 32 keeps a 1000-feature level on 32 SMs; larger
# blocks only pay off on dense flow, where lanes are plentiful.
FB = 32
# Largest padded window the kernel takes (taps per feature). A 15x15
# window pads to 16x16 = 256; beyond that the per-program tensors
# outgrow the register file.
MAX_TAPS = 256
_ONE_PLUS_EPS = 1.001


def _pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def kernel_supported(img_shape, cfg) -> bool:
    """Shape gate. The kernel takes a level when its padded window has at
    most MAX_TAPS taps and the flat image index fits in int32; otherwise
    the caller runs ops/track.track_feature_level."""
    nrows, ncols = img_shape[-2:]
    taps = _pow2(cfg.window_width) * _pow2(cfg.window_height)
    return (taps <= MAX_TAPS and nrows * ncols < 2 ** 31 - 1
            and nrows >= cfg.window_height + 1
            and ncols >= cfg.window_width + 1)


def _bounds_ok(x, y, hw, hh, ncols, nrows):
    return ((x - hw >= 0.0) & (ncols - (x + hw) >= _ONE_PLUS_EPS) &
            (y - hh >= 0.0) & (nrows - (y + hh) >= _ONE_PLUS_EPS))


def _lk_kernel(x1_ref, y1_ref, x2_ref, y2_ref, act_ref,
               i1_ref, gx1_ref, gy1_ref, i2_ref, gx2_ref, gy2_ref,
               xo_ref, yo_ref, so_ref, it_ref, *,
               nrows, ncols, hw, hh, pw, ph, max_iterations, step_factor,
               min_determinant, min_displacement, max_residue,
               lighting_insensitive):
    ww, wh = 2 * hw + 1, 2 * hh + 1
    taps = pw * ph
    k = lax.broadcasted_iota(jnp.int32, (1, taps), 1)
    ii = k % pw
    jj = k // pw
    valid = (ii < ww) & (jj < wh)
    # padded taps read the window's last column/row (in bounds) and are
    # zeroed below
    tap_off = jnp.minimum(jj, wh - 1) * ncols + jnp.minimum(ii, ww - 1)

    def corner(x, y):
        xt = jnp.floor(x)
        yt = jnp.floor(y)
        ax = (x - xt)[:, None]
        ay = (y - yt)[:, None]
        x0 = jnp.clip(xt.astype(jnp.int32) - hw, 0, ncols - 2 - 2 * hw)
        y0 = jnp.clip(yt.astype(jnp.int32) - hh, 0, nrows - 2 - 2 * hh)
        return (y0 * ncols + x0)[:, None] + tap_off, ax, ay

    def window(ref, off, ax, ay):
        p00 = ref[off].astype(jnp.float32)
        p01 = ref[off + 1].astype(jnp.float32)
        p10 = ref[off + ncols].astype(jnp.float32)
        p11 = ref[off + (ncols + 1)].astype(jnp.float32)
        w = ((1.0 - ax) * (1.0 - ay) * p00 + ax * (1.0 - ay) * p01 +
             (1.0 - ax) * ay * p10 + ax * ay * p11)
        return jnp.where(valid, w, 0.0)

    def wsum(a):
        return jnp.sum(a, axis=1)

    n = float(ww * wh)

    def photometric(w1, w2):
        """Lighting-insensitive gain/offset of frame 2 onto frame 1."""
        alpha = jnp.sqrt((wsum(w1 * w1) / n) / (wsum(w2 * w2) / n))
        beta = wsum(w1) / n - alpha * (wsum(w2) / n)
        return alpha[:, None], beta[:, None]

    x1 = x1_ref[...]
    y1 = y1_ref[...]
    active_in = act_ref[...] != 0
    off1, ax1, ay1 = corner(x1, y1)
    w1 = window(i1_ref, off1, ax1, ay1)
    g1x = window(gx1_ref, off1, ax1, ay1)
    g1y = window(gy1_ref, off1, ax1, ay1)
    ok1 = _bounds_ok(x1, y1, hw, hh, ncols, nrows)
    th = jnp.float32(min_displacement)

    def cond(st):
        it, _, _, _, _, active = st
        return (it < max_iterations) & (jnp.max(active.astype(jnp.int32)) > 0)

    def body(st):
        it, x2, y2, status, niter, active = st
        ok = ok1 & _bounds_ok(x2, y2, hw, hh, ncols, nrows)
        status = jnp.where(active & ~ok, KLT_OOB, status)
        live = active & ok
        off2, ax2, ay2 = corner(x2, y2)
        w2 = window(i2_ref, off2, ax2, ay2)
        g2x = window(gx2_ref, off2, ax2, ay2)
        g2y = window(gy2_ref, off2, ax2, ay2)
        if lighting_insensitive:
            alpha, beta = photometric(w1, w2)
            diff = w1 - w2 * alpha - beta
            gx = g1x + alpha * g2x
            gy = g1y + alpha * g2y
        else:
            diff = w1 - w2
            gx = g1x + g2x
            gy = g1y + g2y
        gxx = wsum(gx * gx)
        gxy = wsum(gx * gy)
        gyy = wsum(gy * gy)
        ex = step_factor * wsum(diff * gx)
        ey = step_factor * wsum(diff * gy)
        det = gxx * gyy - gxy * gxy
        small = det < min_determinant
        status = jnp.where(live & small, KLT_SMALL_DET, status)
        live = live & ~small
        safe_det = jnp.where(small, 1.0, det)
        dx = (gyy * ex - gxy * ey) / safe_det
        dy = (gxx * ey - gxy * ex) / safe_det
        x2 = jnp.where(live, x2 + dx, x2)
        y2 = jnp.where(live, y2 + dy, y2)
        niter = jnp.where(live, niter + 1, niter)
        moving = (jnp.abs(dx) >= th) | (jnp.abs(dy) >= th)
        active = live & moving & (niter < max_iterations)
        return it + 1, x2, y2, status, niter, active

    init = (jnp.int32(0), x2_ref[...], y2_ref[...],
            jnp.full(x1.shape, KLT_TRACKED, jnp.int32),
            jnp.zeros(x1.shape, jnp.int32), active_in)
    _, x2, y2, status, niter, _ = lax.while_loop(cond, body, init)

    final_ok = _bounds_ok(x2, y2, hw, hh, ncols, nrows)
    status = jnp.where(active_in & ~final_ok, KLT_OOB, status)
    off2, ax2, ay2 = corner(x2, y2)
    w2 = window(i2_ref, off2, ax2, ay2)
    if lighting_insensitive:
        alpha, beta = photometric(w1, w2)
        diff = w1 - w2 * alpha - beta
    else:
        diff = w1 - w2
    residue = wsum(jnp.abs(diff)) / n
    tracked = active_in & (status == KLT_TRACKED)
    status = jnp.where(tracked & (residue > max_residue),
                       KLT_LARGE_RESIDUE, status)
    tracked = active_in & (status == KLT_TRACKED)
    status = jnp.where(tracked & (niter >= max_iterations),
                       KLT_MAX_ITERATIONS, status)
    xo_ref[...] = x2
    yo_ref[...] = y2
    so_ref[...] = status
    it_ref[...] = niter


@functools.partial(jax.jit, static_argnames=("cfg", "interpret", "block"))
def track_level_kernel(x1, y1, x2, y2, img1, gx1, gy1, img2, gx2, gy2,
                       cfg, active_in, *, interpret: bool = False,
                       block: int = FB):
    """track_feature_level as one kernel launch: same arguments, same
    (x2, y2, status, iteration) result. The caller checks
    kernel_supported first."""
    nrows, ncols = img1.shape
    planes = (img1, gx1, gy1, img2, gx2, gy2)
    if any(p.shape != img1.shape for p in planes):
        raise ValueError("(track_level_kernel) the six level planes must "
                         f"share one shape, got {[p.shape for p in planes]}")
    hw, hh = cfg.window_width // 2, cfg.window_height // 2
    n = x1.shape[0]
    npad = -(-n // block) * block
    pad = lambda a: jnp.pad(a, (0, npad - n))  # noqa: E731
    lanes = [pad(a.astype(jnp.float32)) for a in (x1, y1, x2, y2)]
    # padded lanes are inactive: they pass through untouched
    act = pad(active_in.astype(jnp.int32))
    imgs = [a.reshape(-1) for a in planes]

    kernel = functools.partial(
        _lk_kernel, nrows=nrows, ncols=ncols, hw=hw, hh=hh,
        pw=_pow2(cfg.window_width), ph=_pow2(cfg.window_height),
        max_iterations=int(cfg.max_iterations),
        step_factor=float(cfg.step_factor),
        min_determinant=float(cfg.min_determinant),
        min_displacement=float(cfg.min_displacement),
        max_residue=float(cfg.max_residue),
        lighting_insensitive=bool(cfg.lighting_insensitive))
    lane_spec = pl.BlockSpec((block,), lambda i: (i,))
    img_spec = pl.BlockSpec((nrows * ncols,), lambda i: (0,))
    f32 = jax.ShapeDtypeStruct((npad,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((npad,), jnp.int32)
    xo, yo, so, it = pl.pallas_call(
        kernel,
        out_shape=(f32, f32, i32, i32),
        grid=(npad // block,),
        in_specs=[lane_spec] * 5 + [img_spec] * 6,
        out_specs=(lane_spec,) * 4,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="pft_lk_level",
    )(*lanes, act, *imgs)
    return xo[:n], yo[:n], so[:n], it[:n]
