"""Dense pyramidal Lucas-Kanade optical flow — the tracker at every pixel.

Beyond-reference extension (the reference tracks sparse features only;
see PARITY.md "North-star extras"). Dense flow here is EXACTLY the
sparse tracker's per-level math applied to every pixel center:
ops/track.track_feature_level is reused wholesale with the feature set
= the pixel grid, so every status code, bounds check, convergence rule,
and residue gate is the oracle-tested one (trackFeatures.py ->
_trackFeature semantics, vectorized). Each pixel's window taps move
with that pixel's OWN flow estimate — the well-posed per-feature
formulation. (A cheaper box-filter variant that window-sums a single
warped image — i.e. assumes neighbors share the center pixel's flow —
was built and measured first: it diverges under iteration because each
pixel's normal equations ingest its neighbors' evolving, noisy flows.
Exactness won; see tests/test_flow.py for the sparse==dense pin.)

Pyramid handling differs from the sparse driver in one documented way:
the sparse tracker carries each FEATURE's position coarse-to-fine,
while dense flow re-grids per level — each level solves on its own
pixel grid, initialized by bilinearly upsampling the coarser level's
flow field (upsample_flow). Statuses are the finest level's. The
float64 executable spec mirroring all of this is
oracle/flow_oracle.py (SURVEY.md §0 oracle protocol).

Shape notes: frame-1 window taps land on integer pixels (the grid),
frame-2 taps are per-pixel subpixel gathers [H*W, h, w] — large but
embarrassingly parallel; the whole level is one fused XLA program. At
480x640 the XLA level-0 working set is ~0.5 GB of fused gather buffers
(the GPU level kernel, ops/lk_gpu, materializes none); shard the pixel axis over the mesh for larger
frames (the feature-axis sharding of parallel/sharding.py applies
unchanged, pixels being features here).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .interp import bilinear
from .track import TrackPyramids, track_level


class DenseFlow(NamedTuple):
    """Per-pixel flow field + KLT status map for one frame pair."""
    u: jax.Array       # [H, W] float32, x-displacement
    v: jax.Array       # [H, W] float32, y-displacement
    status: jax.Array  # [H, W] int32, KLT status codes


def upsample_flow(u: jax.Array, shape: tuple[int, int],
                  scale: float) -> jax.Array:
    """Upscale a flow component to ``shape`` and rescale its magnitude.

    Half-pixel-center bilinear sampling (src = (dst + 0.5)/zoom - 0.5,
    clamped) — written out explicitly so oracle/flow_oracle.py can
    mirror it exactly in float64 rather than chasing a library resize's
    convention.
    """
    h_out, w_out = shape
    h_in, w_in = u.shape
    ys = (jnp.arange(h_out, dtype=u.dtype) + 0.5) * (h_in / h_out) - 0.5
    xs = (jnp.arange(w_out, dtype=u.dtype) + 0.5) * (w_in / w_out) - 0.5
    ys = jnp.clip(ys, 0.0, h_in - 1.0)
    xs = jnp.clip(xs, 0.0, w_in - 1.0)
    grid_x, grid_y = jnp.meshgrid(xs, ys)
    return bilinear(u, grid_x, grid_y) * scale


def warp_image(img: jax.Array, u: jax.Array, v: jax.Array) -> jax.Array:
    """Backward-warp: out[y, x] = img(x + u[y,x], y + v[y,x]) bilinear.
    Coordinates clamp at the rim (the last row/column resolves to the
    previous texel — ops/interp.bilinear's memory-safety clamp)."""
    h, w = img.shape
    gx = jnp.arange(w, dtype=u.dtype)[None, :] + u
    gy = jnp.arange(h, dtype=v.dtype)[:, None] + v
    return bilinear(img, gx, gy)


def flow_level(img1, gx1, gy1, img2, gx2, gy2, u, v, cfg
               ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """One pyramid level of dense LK: track_feature_level over the pixel
    grid, initialized at grid + (u, v). Returns (u, v, status) maps.
    The level runs through ops/track.track_level, so on CUDA the pixel
    grid goes through the Pallas level kernel like any feature batch.
    """
    nrows, ncols = img1.shape
    xg = jnp.tile(jnp.arange(ncols, dtype=jnp.float32)[None, :],
                  (nrows, 1))
    yg = jnp.tile(jnp.arange(nrows, dtype=jnp.float32)[:, None],
                  (1, ncols))
    x1 = xg.ravel()
    y1 = yg.ravel()
    x2 = x1 + u.ravel()
    y2 = y1 + v.ravel()
    active = jnp.ones_like(x1, dtype=bool)
    nx, ny, status, _ = track_level(
        x1, y1, x2, y2, img1, gx1, gy1, img2, gx2, gy2, cfg, active)
    return ((nx - x1).reshape(nrows, ncols),
            (ny - y1).reshape(nrows, ncols),
            status.reshape(nrows, ncols))


@functools.partial(jax.jit, static_argnames=("cfg",))
def dense_flow_pyramids(pyr1: TrackPyramids, pyr2: TrackPyramids,
                        cfg) -> DenseFlow:
    """Coarse-to-fine dense LK over prebuilt pyramids (the flow analogue
    of ops/track.track_features_pyramids). Flow starts at zero on the
    coarsest level; each finer level re-solves on its own grid from the
    upsampled field. The status map is the finest level's."""
    s = float(cfg.subsampling)
    n_levels = cfg.nPyramidLevels

    hc, wc = pyr1.img[n_levels - 1].shape
    u = jnp.zeros((hc, wc), jnp.float32)
    v = jnp.zeros((hc, wc), jnp.float32)
    status = None

    for r in range(n_levels - 1, -1, -1):
        shape = pyr1.img[r].shape
        if shape != u.shape:
            u = upsample_flow(u, shape, s)
            v = upsample_flow(v, shape, s)
        lvl = tuple(
            p[r].astype(jnp.float32)
            for p in (pyr1.img, pyr1.gradx, pyr1.grady,
                      pyr2.img, pyr2.gradx, pyr2.grady))
        with jax.named_scope(f"pft.flow_level_{r}"):
            u, v, status = flow_level(*lvl, u, v, cfg)
    return DenseFlow(u=u, v=v, status=status)


def flow_consistency(fwd: DenseFlow, bwd: DenseFlow,
                     max_err: float = 0.5
                     ) -> tuple[jax.Array, jax.Array]:
    """Forward-backward flow consistency (occlusion detection).

    Round-trip error per pixel: e(p) = |flow_fwd(p) + flow_bwd(p +
    flow_fwd(p))| — near zero where both directions see the same
    surface, large where the pixel is occluded or mistracked. Returns
    (err [H, W], valid [H, W] bool); valid requires the forward status
    TRACKED, a TRACKED backward status at the landing pixel (nearest
    neighbor), and err <= max_err.
    """
    ub = warp_image(bwd.u, fwd.u, fwd.v)
    vb = warp_image(bwd.v, fwd.u, fwd.v)
    err = jnp.hypot(fwd.u + ub, fwd.v + vb)
    h, w = fwd.u.shape
    lx = jnp.clip(jnp.round(
        jnp.arange(w, dtype=fwd.u.dtype)[None, :] + fwd.u), 0,
        w - 1).astype(jnp.int32)
    ly = jnp.clip(jnp.round(
        jnp.arange(h, dtype=fwd.v.dtype)[:, None] + fwd.v), 0,
        h - 1).astype(jnp.int32)
    bwd_ok = bwd.status[ly, lx] == 0
    valid = (fwd.status == 0) & bwd_ok & (err <= max_err)
    return err, valid


@functools.partial(jax.jit, static_argnames=("cfg", "max_err"))
def dense_flow_fb(pyr1: TrackPyramids, pyr2: TrackPyramids, cfg,
                  max_err: float = 0.5
                  ) -> tuple[DenseFlow, jax.Array, jax.Array]:
    """Dense flow with the forward-backward occlusion gate: returns
    (forward DenseFlow, round-trip err map, valid mask)."""
    fwd = dense_flow_pyramids.__wrapped__(pyr1, pyr2, cfg)
    bwd = dense_flow_pyramids.__wrapped__(pyr2, pyr1, cfg)
    err, valid = flow_consistency(fwd, bwd, max_err=max_err)
    return fwd, err, valid


@functools.partial(jax.jit, static_argnames=("cfg",))
def dense_flow_batched(imgs1: jax.Array, imgs2: jax.Array,
                       cfg) -> DenseFlow:
    """Dense flow for B frame pairs as ONE vmapped program (the dense
    analogue of the sparse lockstep multi-stream path,
    models/chunked.track_chunks_batched): imgs1/imgs2 are [B, H, W]
    float32 stacks, the result maps are [B, H, W]. Amortizes the
    per-dispatch floor across streams on dispatch-taxed backends and
    keeps one fused program on direct silicon."""
    from .track import build_track_pyramids

    build = jax.vmap(lambda im: build_track_pyramids(im, cfg))
    p1 = build(imgs1.astype(jnp.float32))
    p2 = build(imgs2.astype(jnp.float32))
    return jax.vmap(
        lambda a, b: dense_flow_pyramids.__wrapped__(a, b, cfg))(p1, p2)


def compute_dense_flow(img1, img2, cfg=None) -> DenseFlow:
    """High-level entry: dense flow from frame 1 to frame 2 (images in
    any array form; uint8 staged host-side per the staging rule)."""
    from ..config import create_config
    from ..utils.staging import stage_f32
    from .track import build_track_pyramids_jit

    cfg = (cfg or create_config()).validated_window()
    p1 = build_track_pyramids_jit(stage_f32(img1), cfg)
    p2 = build_track_pyramids_jit(stage_f32(img2), cfg)
    return dense_flow_pyramids(p1, p2, cfg)


def flow_to_rgb(u, v, max_mag: float | None = None):
    """Flow-wheel visualization: hue = direction, saturation = magnitude.
    Returns a uint8 [H, W, 3] numpy array (for utils/io.ppm_write)."""
    import numpy as np

    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    mag = np.hypot(u, v)
    if max_mag is None:
        max_mag = max(float(np.percentile(mag, 99)), 1e-6)
    ang = (np.arctan2(-v, -u) / np.pi + 1.0) / 2.0  # [0, 1)
    sat = np.clip(mag / max_mag, 0.0, 1.0)
    # minimal HSV->RGB (value fixed at 1)
    i = np.floor(ang * 6.0).astype(np.int32) % 6
    f = ang * 6.0 - np.floor(ang * 6.0)
    p = 1.0 - sat
    q = 1.0 - sat * f
    t = 1.0 - sat * (1.0 - f)
    one = np.ones_like(sat)
    lut = np.stack([
        np.stack([one, t, p], -1), np.stack([q, one, p], -1),
        np.stack([p, one, t], -1), np.stack([p, q, one], -1),
        np.stack([t, p, one], -1), np.stack([one, p, q], -1)], 0)
    rgb = np.take_along_axis(lut, i[None, ..., None], axis=0)[0]
    return (rgb * 255.0 + 0.5).astype(np.uint8)
