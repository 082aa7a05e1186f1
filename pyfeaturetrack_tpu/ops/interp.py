"""Batched bilinear window sampling.

Reference parity: trackFeatures.py -> _interpolate. The reference samples
one pixel at a time with a 4-tap bilinear read; here a whole (features x
window) block of samples is gathered at once — one batched gather instead of a scalar loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def bilinear(img: jax.Array, xs: jax.Array, ys: jax.Array) -> jax.Array:
    """Sample ``img[y, x]`` bilinearly at float coords (any broadcastable
    shape). Indices are clamped for memory safety; callers mask validity
    separately (the reference guarantees in-bounds reads via its bounds
    checks, so clamping never changes an *active* lane's value).
    """
    h, w = img.shape[-2], img.shape[-1]
    xt = jnp.floor(xs).astype(jnp.int32)
    yt = jnp.floor(ys).astype(jnp.int32)
    ax = xs - xt
    ay = ys - yt
    x0 = jnp.clip(xt, 0, w - 2)
    y0 = jnp.clip(yt, 0, h - 2)
    # taps upcast to the coordinate dtype (f32): images may be stored
    # bfloat16 (cfg.image_dtype) — only the HBM read is low-precision,
    # the blend math is not
    p00 = img[y0, x0].astype(xs.dtype)
    p01 = img[y0, x0 + 1].astype(xs.dtype)
    p10 = img[y0 + 1, x0].astype(xs.dtype)
    p11 = img[y0 + 1, x0 + 1].astype(xs.dtype)
    return ((1.0 - ax) * (1.0 - ay) * p00 + ax * (1.0 - ay) * p01 +
            (1.0 - ax) * ay * p10 + ax * ay * p11)


def window_coords(x: jax.Array, y: jax.Array, hw: int, hh: int
                  ) -> tuple[jax.Array, jax.Array]:
    """Per-feature window sample coordinates.

    ``x, y``: [N] centers. Returns (xs, ys) of shape [N, 2*hh+1, 2*hw+1]
    with xs[n, j, i] = x[n] + (i - hw), ys[n, j, i] = y[n] + (j - hh) —
    the reference's window iteration order (j outer, i inner).
    """
    offs_x = jnp.arange(-hw, hw + 1, dtype=x.dtype)
    offs_y = jnp.arange(-hh, hh + 1, dtype=y.dtype)
    xs = x[:, None, None] + offs_x[None, None, :]
    ys = y[:, None, None] + offs_y[None, :, None]
    xs, ys = jnp.broadcast_arrays(xs, ys)
    return xs, ys


def gather_window(img: jax.Array, x: jax.Array, y: jax.Array,
                  hw: int, hh: int) -> jax.Array:
    """Bilinear window stack [N, h, w] centered at per-feature (x, y)."""
    xs, ys = window_coords(x, y, hw, hh)
    return bilinear(img, xs, ys)


def patch_indices(img_shape, x: jax.Array, y: jax.Array, hw: int, hh: int):
    """Shared index computation for patch gathers: returns
    (rows [N,h+1,1], cols [N,1,w+1], ax [N], ay [N]) for the integer
    (h+1)x(w+1) patch whose top-left is floor(x)-hw / floor(y)-hh.

    Clamped so the whole patch is in-bounds (parity: active lanes are
    bounds-checked upstream, clamping only protects masked lanes)."""
    hsz, wsz = img_shape[-2], img_shape[-1]
    xt = jnp.floor(x).astype(jnp.int32)
    yt = jnp.floor(y).astype(jnp.int32)
    ax = x - xt
    ay = y - yt
    x0 = jnp.clip(xt - hw, 0, wsz - 2 - 2 * hw)
    y0 = jnp.clip(yt - hh, 0, hsz - 2 - 2 * hh)
    rows = y0[:, None, None] + jnp.arange(2 * hh + 2,
                                          dtype=jnp.int32)[None, :, None]
    cols = x0[:, None, None] + jnp.arange(2 * hw + 2,
                                          dtype=jnp.int32)[None, None, :]
    return rows, cols, ax, ay


def gather_patch(img: jax.Array, x: jax.Array, y: jax.Array,
                 hw: int, hh: int) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Integer patch [N, h+1, w+1] whose top-left is floor(x)-hw/floor(y)-hh,
    plus the per-feature fractional offsets (ax, ay).

    Because window offsets are integers, every bilinear tap of the window
    shares the same fractional part — so ONE integer gather of the
    (h+1)x(w+1) patch replaces 4 gathers per tap (3x fewer loads), and the
    window is reconstructed by blending four shifted views of the patch
    (see window_from_patch). Values are identical to gather_window.
    """
    rows, cols, ax, ay = patch_indices(img.shape, x, y, hw, hh)
    return img[rows, cols], ax, ay


def window_from_patch(patch: jax.Array, ax: jax.Array, ay: jax.Array
                      ) -> jax.Array:
    """Blend the four shifted (h x w) views of an (h+1 x w+1) patch with
    the shared per-feature bilinear weights. Equals gather_window."""
    a = ax[:, None, None]
    b = ay[:, None, None]
    patch = patch.astype(ax.dtype)  # bf16-stored images blend in f32
    p00 = patch[:, :-1, :-1]
    p01 = patch[:, :-1, 1:]
    p10 = patch[:, 1:, :-1]
    p11 = patch[:, 1:, 1:]
    return ((1.0 - a) * (1.0 - b) * p00 + a * (1.0 - b) * p01 +
            (1.0 - a) * b * p10 + a * b * p11)


def gather_window_fast(img: jax.Array, x: jax.Array, y: jax.Array,
                       hw: int, hh: int) -> jax.Array:
    """Patch-gather + blend form of gather_window (identical values)."""
    patch, ax, ay = gather_patch(img, x, y, hw, hh)
    return window_from_patch(patch, ax, ay)
