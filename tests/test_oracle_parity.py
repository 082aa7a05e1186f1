"""The XLA tracking path against the float64 oracle, scenario by
scenario: status triggers, odd and non-power-of-two image sizes, window
sizes, pyramid shapes, the affine modes with and without the lighting-
insensitive residual, bfloat16 storage, and refill against the host
greedy (whose exhaustion the device path must flag, never hide).

Statuses are asserted EXACTLY equal; lanes that may differ are
enumerated by cause where a scenario has any (none does today).
Positions: float32 tracker vs float64 oracle agree to ~1e-5 px
(test_track.py); 1e-3 here leaves room for the iterated-to-the-cap
lanes, 5e-3 for the lighting-insensitive gain/offset solve, and 0.1 for
bfloat16 storage (8-bit mantissa intensities).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import pyfeaturetrack_tpu as pft
from pyfeaturetrack_tpu.features import (KLT_NOT_FOUND,
                                         feature_state_from_numpy)
from pyfeaturetrack_tpu.oracle import affine_oracle
from pyfeaturetrack_tpu.oracle import klt_oracle as oracle

from conftest import make_textured_image, shift_image_bilinear


def _track(cfg, img1, img2, feats):
    fl2, _ = pft.KLTTrackFeatures(cfg, img1, img2,
                                  feature_state_from_numpy(feats))
    return np.stack([np.asarray(fl2.x, np.float64),
                     np.asarray(fl2.y, np.float64),
                     np.asarray(fl2.val, np.float64)], 1)


def _assert_parity(cfg, img1, img2, feats, atol=1e-3, min_tracked=0):
    got = _track(cfg, img1, img2, feats)
    want, _ = oracle.track_features(img1, img2, feats, cfg)
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    both = (got[:, 2] == 0) & (want[:, 2] == 0)
    assert both.sum() >= min_tracked
    np.testing.assert_allclose(got[both, :2], want[both, :2], atol=atol)
    return got[:, 2]


def _grid_feats(cfg, h, w, n_side=4, margin=None):
    m = max(cfg.borderx, cfg.bordery) + 2 if margin is None else margin
    xs = np.linspace(m, w - 1 - m, n_side)
    ys = np.linspace(m, h - 1 - m, n_side)
    g = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    return np.concatenate([g, np.full((len(g), 1), 100.0)], 1)


# -- status triggers -------------------------------------------------

def _trigger_case(scenario, li):
    cfg = pft.create_config(lighting_insensitive=li)
    h, w = 96, 128
    if scenario == "oob_border":
        img1 = make_textured_image(h, w, seed=1)
        img2 = shift_image_bilinear(img1, -3.0, -2.5)
        b = cfg.borderx
        feats = np.array([[b + 1.0 + k, b + 1.5 + k, 100.0]
                          for k in range(6)])
        expect = pft.KLT_OOB
    elif scenario == "small_det_flat":
        cfg = cfg.replace(**{"nPyramidLevels": 1})
        img1 = img2 = np.full((h, w), 100.0)
        feats = _grid_feats(cfg, h, w, 3, margin=20)
        expect = pft.KLT_SMALL_DET
    elif scenario == "large_residue":
        cfg = cfg.replace(step_factor=0.0)
        img1 = make_textured_image(h, w, seed=1)
        img2 = make_textured_image(h, w, seed=2)
        feats = _grid_feats(cfg, h, w, 3)
        expect = pft.KLT_LARGE_RESIDUE
    elif scenario == "max_iterations":
        cfg = cfg.replace(min_displacement=0.0)
        img1 = img2 = make_textured_image(h, w, seed=1)
        feats = _grid_feats(cfg, h, w, 3)
        expect = pft.KLT_MAX_ITERATIONS
    else:  # identity
        img1 = img2 = make_textured_image(h, w, seed=1)
        feats = _grid_feats(cfg, h, w, 3)
        expect = pft.KLT_TRACKED
    return cfg, img1, img2, feats, expect


@pytest.mark.parametrize("li", [False, True], ids=["plain", "li"])
@pytest.mark.parametrize("scenario", ["oob_border", "small_det_flat",
                                      "large_residue", "max_iterations",
                                      "identity"])
def test_status_trigger_matches_oracle(scenario, li):
    cfg, img1, img2, feats, expect = _trigger_case(scenario, li)
    st = _assert_parity(cfg, img1, img2, feats,
                        atol=5e-3 if li else 1e-3)
    assert (st == expect).any(), (scenario, np.unique(st))


# -- image sizes -----------------------------------------------------

@pytest.mark.parametrize("shape", [(97, 131), (100, 150), (121, 163),
                                   (75, 203), (130, 98), (64, 96)])
def test_odd_and_non_power_of_two_sizes_match_oracle(shape):
    h, w = shape
    cfg = pft.create_config()
    img1 = make_textured_image(h, w, seed=h + w)
    img2 = shift_image_bilinear(img1, 1.3, -0.7)
    feats = oracle.select_good_features(img1, 20, cfg)
    _assert_parity(cfg, img1, img2, feats, min_tracked=5)


# -- window sizes ----------------------------------------------------

@pytest.mark.parametrize("win", [(3, 3), (5, 5), (9, 9), (11, 11),
                                 (13, 13), (15, 15), (7, 5), (5, 9),
                                 (9, 7)])
def test_window_sizes_match_oracle(win):
    ww, wh = win
    cfg = pft.create_config().replace(window_width=ww, window_height=wh)
    img1 = make_textured_image(112, 144, seed=ww * 10 + wh)
    img2 = shift_image_bilinear(img1, 0.9, 1.2)
    feats = oracle.select_good_features(img1, 20, cfg)
    _assert_parity(cfg, img1, img2, feats, min_tracked=5)


# -- pyramid shapes --------------------------------------------------

@pytest.mark.parametrize("levels,sub", [(1, 2), (2, 2), (3, 2), (2, 4),
                                        (3, 3)])
def test_pyramid_shapes_match_oracle(levels, sub):
    cfg = pft.create_config().replace(nPyramidLevels=levels,
                                      subsampling=sub)
    img1 = make_textured_image(144, 176, seed=levels * 7 + sub)
    img2 = shift_image_bilinear(img1, 2.1, -1.6)
    feats = oracle.select_good_features(img1, 20, cfg)
    _assert_parity(cfg, img1, img2, feats, min_tracked=5)


# -- affine consistency check, with and without the LI residual --------

def _oracle_affine_pipeline(cfg, frames, feats0):
    """Oracle composition of two KLTTrackFeatures calls with the affine
    check: templates captured at frame 0 on the first track, checked by
    Gauss-Newton from the translational result on the second."""
    img0, img1, img2 = frames
    t1, _ = oracle.track_features(img0, img1, feats0, cfg)
    p0, gx0, gy0 = oracle.build_track_pyramids(img0, cfg)
    tw, th = cfg.affine_window_width, cfg.affine_window_height
    tmpls = {i: affine_oracle.get_template(p0[0], gx0[0], gy0[0],
                                           feats0[i, 0], feats0[i, 1],
                                           tw, th)
             for i in range(len(feats0)) if t1[i, 2] == 0}
    t2, pyr2 = oracle.track_features(img1, img2, t1, cfg)
    p2, gx2, gy2 = pyr2
    out = t2.copy()
    for i, tm in tmpls.items():
        if t2[i, 2] != 0:
            continue
        x, y, _, st = affine_oracle.am_track_feature_affine(
            t2[i, 0], t2[i, 1], tm, p2[0], gx2[0], gy2[0], np.eye(2), cfg,
            cfg.affineConsistencyCheck)
        out[i] = (x, y, 0) if st == 0 else (-1.0, -1.0, st)
    return out


@pytest.mark.parametrize("li", [False, True], ids=["plain", "li"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_affine_modes_match_oracle(mode, li):
    cfg = pft.create_config(affineConsistencyCheck=mode,
                            lighting_insensitive=li)
    img0 = make_textured_image(120, 160, seed=31)
    img1 = shift_image_bilinear(img0, 0.7, -0.5)
    img2 = shift_image_bilinear(img1, 0.6, 0.4)
    if li:
        img2 = np.clip(img2 * 0.9 + 12.0, 0, 255)
    feats0 = oracle.select_good_features(img0, 16, cfg)
    want = _oracle_affine_pipeline(cfg, (img0, img1, img2), feats0)
    fl0 = feature_state_from_numpy(feats0)
    fl1, _ = pft.KLTTrackFeatures(cfg, img0, img1, fl0)
    fl2, _ = pft.KLTTrackFeatures(cfg, img1, img2, fl1)
    got_v = np.asarray(fl2.val, np.float64)
    np.testing.assert_array_equal(got_v, want[:, 2])
    ok = (got_v == 0) & (want[:, 2] == 0)
    assert ok.sum() >= 5
    got_xy = np.stack([np.asarray(fl2.x), np.asarray(fl2.y)], 1)
    np.testing.assert_allclose(got_xy[ok], want[ok, :2], atol=0.02)


# -- bfloat16 storage ------------------------------------------------

@pytest.mark.parametrize("seed", [3, 17, 29, 41])
def test_bfloat16_storage_statuses_match_oracle(seed):
    """bf16 pyramid storage rounds intensities to 8 mantissa bits; the
    statuses still equal the float64 oracle's on these scenes (no lane
    is enumerated as a bf16 exception) and positions stay within 0.1 px."""
    cfg = pft.create_config().replace(image_dtype="bfloat16")
    img1 = make_textured_image(120, 160, seed=seed)
    img2 = shift_image_bilinear(img1, 1.1, -0.6)
    feats = oracle.select_good_features(img1, 24, cfg)
    bf16_status_exceptions: list[int] = []
    got = _track(cfg, img1, img2, feats)
    want, _ = oracle.track_features(img1, img2, feats, cfg)
    flipped = np.flatnonzero(got[:, 2] != want[:, 2]).tolist()
    assert flipped == bf16_status_exceptions
    both = (got[:, 2] == 0) & (want[:, 2] == 0)
    assert both.sum() >= 5
    np.testing.assert_allclose(got[both, :2], want[both, :2], atol=0.1)


# -- refill vs the host greedy ---------------------------------------

def _device_refill(img, existing, cfg, top_k):
    from pyfeaturetrack_tpu.ops.select_device import select_features_device
    xs, ys, vs, filled, exhausted = select_features_device(
        jnp.asarray(img, jnp.float32),
        jnp.asarray(existing[:, 0], jnp.float32),
        jnp.asarray(existing[:, 1], jnp.float32),
        jnp.asarray(existing[:, 2], jnp.int32), cfg, replacing=True,
        top_k=top_k)
    out = np.stack([np.asarray(xs, np.float64), np.asarray(ys, np.float64),
                    np.asarray(vs, np.float64)], -1)
    return out, np.asarray(filled), bool(exhausted)


@pytest.mark.parametrize("mindist,lost_every", [(5, 3), (8, 2), (10, 4),
                                                (12, 5)])
def test_refill_matches_oracle_replace_lost(mindist, lost_every):
    """Device refill with the whole candidate pool == the float64
    oracle's KLTReplaceLostFeatures, slot for slot."""
    img = make_textured_image(120, 160, seed=mindist)
    cfg = pft.create_config(mindist=mindist)
    base = oracle.select_good_features(img, 30, cfg)
    lost = base.copy()
    lost[::lost_every] = (-1.0, -1.0, -1.0)
    want = oracle.replace_lost_features(img, lost.copy(), cfg)
    got, _, exhausted = _device_refill(img, lost.copy(), cfg, 1 << 20)
    assert not exhausted
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_k", [8, 16])
def test_refill_exhaustion_is_flagged_against_host_greedy(top_k):
    """A refill whose capped top-K rung runs dry while candidates remain
    must raise the exhaustion flag; the slots it did fill are exactly
    the host greedy's (greedy is prefix-stable), and the host's full
    scan fills more."""
    from pyfeaturetrack_tpu.ops.select import select_good_features_arrays
    img = make_textured_image(120, 160, seed=77)
    cfg = pft.create_config(mindist=10)
    n = 200
    empty = np.tile([(-1.0, -1.0, float(KLT_NOT_FOUND))], (n, 1))
    host = select_good_features_arrays(img, n, cfg, existing=empty.copy())
    got, filled, exhausted = _device_refill(img, empty.copy(), cfg, top_k)
    assert exhausted
    host_filled = host[:, 2] >= 0
    assert filled.sum() < host_filled.sum()
    np.testing.assert_array_equal(got[filled], host[filled])
