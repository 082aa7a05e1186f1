"""Dense rectified-stereo disparity vs its float64 oracle + physics.

Oracle-parity tests pin ops/disparity.py to oracle/disparity_oracle.py
(SURVEY.md §0 protocol); physics tests recover known piecewise-planar
disparity maps, exercise the hypothesis sweep on a displacement far
beyond the pyramid search range, gate occlusions with the LR check, and
confirm metric depth against the sparse stereo path's convention.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from conftest import make_textured_image, shift_image_bilinear
from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.ops.disparity import (DenseDisparity, _box_sum,
                                              dense_depth,
                                              dense_disparity,
                                              dense_disparity_lr,
                                              dense_disparity_pyramids,
                                              disparity_lr_consistency)
from pyfeaturetrack_tpu.ops.track import build_track_pyramids
from pyfeaturetrack_tpu.oracle import disparity_oracle


def _pyramids(img1, img2, cfg):
    build = jax.jit(build_track_pyramids, static_argnames=("cfg",))
    return (build(jnp.asarray(img1, jnp.float32), cfg),
            build(jnp.asarray(img2, jnp.float32), cfg))


def test_box_sum_matches_direct():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 10, (17, 23)).astype(np.float32)
    hw, hh = 3, 2
    got = np.asarray(_box_sum(jnp.asarray(a), hw, hh))
    pad = np.pad(a, ((hh, hh), (hw, hw)))
    want = np.zeros_like(a)
    for y in range(a.shape[0]):
        for x in range(a.shape[1]):
            want[y, x] = pad[y:y + 2 * hh + 1, x:x + 2 * hw + 1].sum()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_disparity_matches_oracle_subpixel():
    """Constant subpixel disparity, max_disparity below the hypothesis
    stride so both implementations take the deterministic pure-
    refinement path: statuses bit-equal, disparity to float tolerance."""
    cfg = create_config()
    right = make_textured_image(96, 128, seed=11)
    left = shift_image_bilinear(right, 1.5, 0.0)
    p_l, p_r = _pyramids(left, right, cfg)
    got = dense_disparity_pyramids(p_l, p_r, cfg, max_disparity=3.0)

    lvl = lambda t: [np.asarray(a, np.float64) for a in t]  # noqa: E731
    od, ost = disparity_oracle.dense_disparity(
        lvl(p_l.img), lvl(p_l.gradx), lvl(p_l.grady),
        lvl(p_r.img), lvl(p_r.gradx), lvl(p_r.grady), cfg,
        max_disparity=3.0)

    st = np.asarray(got.status)
    np.testing.assert_array_equal(st, ost)
    ok = st == 0
    assert ok.mean() > 0.5
    np.testing.assert_allclose(np.asarray(got.d)[ok], od[ok], atol=2e-2)
    # and the physics: recovered disparity ~1.5 px on the interior
    interior = np.zeros_like(ok)
    interior[10:-10, 10:-10] = True
    med = np.median(np.asarray(got.d)[ok & interior])
    assert abs(med - 1.5) < 0.15, med


def test_hypothesis_sweep_recovers_large_disparity():
    """40 px true disparity at default config (pyramid search range
    ~14 px): only the coarse SSD hypothesis sweep can reach it."""
    cfg = create_config()
    tex = make_textured_image(96, 260, seed=5)
    # left[y,x] = T[y,x], right[y,x] = T[y,x+40] -> left x matches right
    # at x-40: d = x_L - x_R = +40
    left = tex[:, :200]
    right = tex[:, 40:240]
    p_l, p_r = _pyramids(left, right, cfg)
    got = dense_disparity_pyramids(p_l, p_r, cfg, max_disparity=64.0)

    lvl = lambda t: [np.asarray(a, np.float64) for a in t]  # noqa: E731
    od, ost = disparity_oracle.dense_disparity(
        lvl(p_l.img), lvl(p_l.gradx), lvl(p_l.grady),
        lvl(p_r.img), lvl(p_r.gradx), lvl(p_r.grady), cfg,
        max_disparity=64.0)
    np.testing.assert_array_equal(np.asarray(got.status), ost)

    st = np.asarray(got.status)
    d = np.asarray(got.d)
    # pixels whose right-image window exists (x >= 40 + border)
    feasible = np.zeros_like(st, bool)
    feasible[10:-10, 50:-10] = True
    ok = (st == 0) & feasible
    assert (st == 0)[feasible].mean() > 0.3
    assert abs(np.median(d[ok]) - 40.0) < 0.2
    assert (np.abs(d[ok] - 40.0) < 1.0).mean() > 0.9


def test_piecewise_planes_and_lr_occlusion_gate():
    """Two fronto-parallel planes with INDEPENDENT textures composited
    with real visibility: a near box (d=10) over a background (d=2).
    Interiors recover their disparity through the LR gate; the
    background band just left of the box — whose true right-image match
    is hidden BEHIND the box — is flagged invalid (left-occlusion)."""
    cfg = create_config()
    H, W = 120, 200
    B = make_textured_image(H, W + 16, seed=7)    # background plane
    F = make_textured_image(H, W + 16, seed=8)    # foreground box plane
    b0, b1 = 60, 140                              # box span, RIGHT coords
    y0, y1 = 30, 90
    xs = np.arange(W)[None, :]
    ys = np.arange(H)[:, None]
    in_box_r = (xs >= b0) & (xs < b1) & (ys >= y0) & (ys < y1)
    # right view: box texture where the box is, else background (bg
    # disparity 2 -> right bg samples B at x+2... choose B indexed by
    # right coords + per-plane offset so left/right stay consistent:
    # bg: left[y,x] = B[y,x], right[y,x] = B[y,x+2]  (d = 2)
    # box: left[y,x] = F[y,x], right[y,x] = F[y,x+10] (d = 10)
    right = np.where(in_box_r, F[:, 10:W + 10], B[:, 2:W + 2])
    in_box_l = (xs >= b0 + 10) & (xs < b1 + 10) & (ys >= y0) & (ys < y1)
    left = np.where(in_box_l, F[:, :W], B[:, :W])

    dl, err, valid = dense_disparity_lr(left, right, cfg,
                                        max_disparity=16.0)
    d = np.asarray(dl.d)
    v = np.asarray(valid)

    bg = np.zeros_like(v)
    bg[10:-10, 12:58] = True       # background well left of the box
    box = np.zeros_like(v)
    box[y0 + 8:y1 - 8, b0 + 18:b1 + 2] = True   # box interior (left)
    assert v[bg].mean() > 0.6, v[bg].mean()
    assert v[box].mean() > 0.6, v[box].mean()
    assert abs(np.median(d[bg & v]) - 2.0) < 0.3
    assert abs(np.median(d[box & v]) - 10.0) < 0.3

    # left-occlusion band: left bg pixels x in [b0+2, b0+10) match right
    # x-2 in [b0, b0+8) — covered by the box in the right view, so their
    # true correspondence is hidden; the LR gate must reject most
    occ = np.zeros_like(v)
    occ[y0 + 8:y1 - 8, b0 + 3:b0 + 9] = True
    assert v[occ].mean() < 0.4, v[occ].mean()


def test_dense_depth_metric_convention():
    """depth = fx * baseline / d, matching sfm/stereo.stereo_depth."""
    cfg = create_config()
    tex = make_textured_image(96, 180, seed=9)
    left = tex[:, :160]
    right = tex[:, 8:168]          # constant d = +8
    K = np.array([[100.0, 0, 80], [0, 100.0, 48], [0, 0, 1]])
    depth, d, v = dense_depth(left, right, K, baseline=0.5, cfg=cfg,
                              max_disparity=16.0)
    inner = np.zeros_like(v)
    inner[10:-10, 20:-10] = True
    got = np.median(depth[v & inner])
    assert abs(got - 100.0 * 0.5 / 8.0) < 0.1, got
    assert (depth[~v] == 0).all()


def test_high_level_entry_uint8():
    """dense_disparity accepts uint8 frames (staging rule) and returns
    a DenseDisparity with finite maps."""
    tex = make_textured_image(64, 120, seed=3)
    left = tex[:, :100].astype(np.uint8)
    right = tex[:, 4:104].astype(np.uint8)  # constant d = +4
    out = dense_disparity(left, right, max_disparity=8.0)
    assert isinstance(out, DenseDisparity)
    st = np.asarray(out.status)
    d = np.asarray(out.d)
    ok = st == 0
    assert ok.mean() > 0.4
    assert np.isfinite(d).all()
    assert abs(np.median(d[ok]) - 4.0) < 0.5


def test_lr_consistency_shapes_and_trivial_pass():
    """A pair with zero disparity everywhere: LR check validates the
    interior (err ~ 0) once min_disparity is lowered."""
    cfg = create_config()
    img = make_textured_image(64, 96, seed=1)
    p1, p2 = _pyramids(img, img, cfg)
    dl = dense_disparity_pyramids(p1, p2, cfg, max_disparity=3.0)
    err, valid = disparity_lr_consistency(dl, dl, min_disparity=-1.0)
    e = np.asarray(err)
    v = np.asarray(valid)
    assert e.shape == np.asarray(dl.d).shape
    assert v[10:-10, 10:-10].mean() > 0.8
    assert np.median(e[v]) < 0.05
