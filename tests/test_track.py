"""Tracking vs the float64 oracle + dedicated status-code triggers
(SURVEY.md sections 3.2, 7.4)."""

import numpy as np
import pytest

import pyfeaturetrack_tpu as pft
from pyfeaturetrack_tpu.features import feature_state_from_numpy
from pyfeaturetrack_tpu.oracle import klt_oracle as oracle

from conftest import make_textured_image, shift_image_bilinear


@pytest.fixture(scope="module")
def cfg():
    return pft.create_config()


@pytest.fixture(scope="module")
def pair():
    img1 = make_textured_image(96, 128, seed=11)
    img2 = shift_image_bilinear(img1, 1.6, -1.1)
    return img1, img2


@pytest.fixture(scope="module")
def tracked(cfg, pair):
    img1, img2 = pair
    feats = oracle.select_good_features(img1, 40, cfg)
    fl = feature_state_from_numpy(feats)
    fl2, _ = pft.KLTTrackFeatures(cfg, img1, img2, fl)
    want, _ = oracle.track_features(img1, img2, feats, cfg)
    got = np.stack([np.asarray(fl2.x, np.float64),
                    np.asarray(fl2.y, np.float64),
                    np.asarray(fl2.val, np.float64)], 1)
    return got, want


def test_statuses_match_oracle(tracked):
    """Status parity vs the float64 oracle is EXACT (VERDICT r1 item 1:
    the historical 95% tolerance was slack, not a real f32/f64 gap —
    instrumented 2026-08-17: zero disagreeing lanes across the default,
    config-matrix, and noisy stress scenarios)."""
    got, want = tracked
    np.testing.assert_array_equal(got[:, 2], want[:, 2])


def test_positions_match_oracle(tracked):
    got, want = tracked
    both = (got[:, 2] == 0) & (want[:, 2] == 0)
    assert both.sum() >= 10
    # float32 tracker vs float64 oracle: measured max gap ~1e-5 px
    np.testing.assert_allclose(got[both, :2], want[both, :2], atol=1e-4)


@pytest.mark.parametrize("scenario", ["noisy_shift", "noisy_shift_li",
                                      "raw_texture_small_window"])
def test_statuses_match_oracle_stress(scenario):
    """Exact status parity holds in residue-threshold-straddling regimes
    (sensor noise, gain/bias change, harsh unsmoothed texture)."""
    img1 = make_textured_image(128, 160, seed=91)
    r = np.random.default_rng(0)
    if scenario == "noisy_shift":
        img2 = np.clip(shift_image_bilinear(img1, 3.7, -2.9)
                       + r.normal(0, 6, img1.shape), 0, 255)
        cfg = pft.create_config()
    elif scenario == "noisy_shift_li":
        img2 = np.clip((shift_image_bilinear(img1, 3.7, -2.9)
                        + r.normal(0, 6, img1.shape)) * 0.7 + 30, 0, 255)
        cfg = pft.create_config(lighting_insensitive=True)
    else:
        img1 = make_textured_image(128, 160, seed=13, smooth=False)
        img2 = shift_image_bilinear(img1, 2.2, 1.4)
        cfg = pft.create_config(window_width=5, window_height=5)
    feats = oracle.select_good_features(img1, 100, cfg)
    fl2, _ = pft.KLTTrackFeatures(cfg, img1, img2,
                                  feature_state_from_numpy(feats))
    want, _ = oracle.track_features(img1, img2, feats, cfg)
    np.testing.assert_array_equal(np.asarray(fl2.val, np.int64),
                                  want[:, 2])


def test_known_flow_recovered(cfg, pair):
    img1, img2 = pair
    feats = oracle.select_good_features(img1, 40, cfg)
    fl = feature_state_from_numpy(feats)
    fl2, _ = pft.KLTTrackFeatures(cfg, img1, img2, fl)
    tv = np.asarray(fl2.val)
    live = tv == 0
    assert live.sum() >= 10
    dx = np.asarray(fl2.x)[live] - feats[live, 0]
    dy = np.asarray(fl2.y)[live] - feats[live, 1]
    # interior flow is the constant shift; tolerate interpolation error
    assert abs(np.median(dx) - 1.6) < 0.1
    assert abs(np.median(dy) - (-1.1)) < 0.1


def test_bilinear_matches_oracle(pair):
    from pyfeaturetrack_tpu.ops.interp import bilinear
    import jax.numpy as jnp
    img1, _ = pair
    r = np.random.default_rng(0)
    xs = r.uniform(1, img1.shape[1] - 2, 50)
    ys = r.uniform(1, img1.shape[0] - 2, 50)
    want = np.array([oracle.interpolate(x, y, img1) for x, y in zip(xs, ys)])
    got = np.asarray(bilinear(jnp.asarray(img1, jnp.float32),
                              jnp.asarray(xs, jnp.float32),
                              jnp.asarray(ys, jnp.float32)), np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


def _track_single(cfg, img1, img2, x, y):
    fl = feature_state_from_numpy(np.array([[x, y, 100.0]]))
    fl2, _ = pft.KLTTrackFeatures(cfg, img1, img2, fl)
    return (float(fl2.x[0]), float(fl2.y[0]), int(fl2.val[0]))


def test_status_oob(pair):
    """Feature right at the border walks out -> KLT_OOB."""
    cfg = pft.create_config()
    img1, img2 = pair
    x, y, v = _track_single(cfg, img1, img2, cfg.borderx + 1.0,
                            cfg.bordery + 1.0)
    # shifted image moves features toward the border; whatever the track
    # result, a lost feature must be parked at (-1, -1)
    if v != pft.KLT_TRACKED:
        assert (x, y) == (-1.0, -1.0)


def test_status_small_det():
    """Flat image -> zero gradients -> KLT_SMALL_DET (single-level config
    so the break-level coordinates face the border check unscaled)."""
    cfg = pft.create_config(search_range=2)  # 1 pyramid level
    assert cfg.nPyramidLevels == 1
    img = np.full((96, 128), 100.0)
    x, y, v = _track_single(cfg, img, img, 60.0, 48.0)
    assert v == pft.KLT_SMALL_DET
    assert (x, y) == (-1.0, -1.0)


def test_status_small_det_coarse_break_is_oob():
    """Reference quirk, preserved: a SMALL_DET break at a coarse level
    leaves the position at that level's scale, and the final border check
    runs on it UN-rescaled — so near-border coarse breaks report OOB.
    The oracle is the spec; both paths must agree."""
    cfg = pft.create_config()  # 2 levels, subsampling 4, border 24
    img = np.full((96, 128), 100.0)
    feats = np.array([[60.0, 48.0, 100.0]])
    want, _ = oracle.track_features(img, img, feats, cfg)
    assert want[0, 2] == pft.KLT_OOB  # coarse coords (15, 12) < border
    x, y, v = _track_single(cfg, img, img, 60.0, 48.0)
    assert v == int(want[0, 2])
    assert (x, y) == (-1.0, -1.0)


def test_status_large_residue():
    """step_factor=0 freezes the solve; tracking between uncorrelated
    images then fails the residue check."""
    cfg = pft.create_config(step_factor=0.0)
    img1 = make_textured_image(96, 128, seed=1)
    img2 = make_textured_image(96, 128, seed=2)
    x, y, v = _track_single(cfg, img1, img2, 60.0, 48.0)
    assert v == pft.KLT_LARGE_RESIDUE


def test_status_max_iterations():
    """min_displacement=0 never converges -> KLT_MAX_ITERATIONS."""
    cfg = pft.create_config(min_displacement=0.0)
    img = make_textured_image(96, 128, seed=1)
    x, y, v = _track_single(cfg, img, img, 60.0, 48.0)
    assert v == pft.KLT_MAX_ITERATIONS


def test_status_tracked_identity():
    """Identity tracking converges immediately with zero residue."""
    cfg = pft.create_config()
    img = make_textured_image(96, 128, seed=1)
    x, y, v = _track_single(cfg, img, img, 60.0, 48.0)
    assert v == pft.KLT_TRACKED
    assert abs(x - 60.0) < 1e-3 and abs(y - 48.0) < 1e-3


def test_lighting_insensitive_tracks_gain_bias(cfg):
    """Gain+bias change breaks plain LK residue, lighting-insensitive
    mode survives it (reference trackFeatures.py LI variants)."""
    img1 = make_textured_image(96, 128, seed=5)
    img2 = np.clip(shift_image_bilinear(img1, 0.8, 0.5) * 0.6 + 40.0, 0, 255)
    feats = oracle.select_good_features(img1, 20, cfg)
    li_cfg = cfg.replace(lighting_insensitive=True)
    fl = feature_state_from_numpy(feats)
    fl_li, _ = pft.KLTTrackFeatures(li_cfg, img1, img2, fl)
    v_li = np.asarray(fl_li.val)
    assert (v_li == 0).sum() >= 10
    # and it matches the oracle's LI path
    want, _ = oracle.track_features(
        img1, img2, feats, li_cfg)
    both = (v_li == 0) & (want[:, 2] == 0)
    np.testing.assert_allclose(
        np.stack([np.asarray(fl_li.x)[both], np.asarray(fl_li.y)[both]], 1),
        want[both, :2], atol=5e-3)


def test_sequential_cache_equivalence(cfg, pair):
    """Passing the cached pyramid must equal rebuilding it."""
    img1, img2 = pair
    feats = oracle.select_good_features(img1, 20, cfg)
    fl = feature_state_from_numpy(feats)
    from pyfeaturetrack_tpu.ops.track import build_track_pyramids
    import jax.numpy as jnp
    cache = build_track_pyramids(jnp.asarray(img1, jnp.float32),
                                 cfg.validated_window())
    a, _ = pft.KLTTrackFeatures(cfg, img1, img2, fl)
    b, _ = pft.KLTTrackFeatures(cfg, img1, img2, fl, pyramid_last=cache)
    np.testing.assert_array_equal(np.asarray(a.x), np.asarray(b.x))
    np.testing.assert_array_equal(np.asarray(a.val), np.asarray(b.val))


def test_track_all_dead_features_is_noop():
    """An all-dead feature list passes through tracking unchanged."""
    cfg = pft.create_config()
    img = make_textured_image(96, 128, seed=2)
    fl = pft.KLTCreateFeatureList(8)  # all KLT_NOT_FOUND
    out, _ = pft.KLTTrackFeatures(cfg, img, img, fl)
    np.testing.assert_array_equal(np.asarray(out.val), np.asarray(fl.val))
    np.testing.assert_array_equal(np.asarray(out.x), np.asarray(fl.x))


def test_bfloat16_image_storage_mode():
    """cfg.image_dtype='bfloat16' (storage knob, beyond the
    reference): cached pyramid levels are stored bf16 while blending and
    reductions stay f32 — tracks must agree with the f32 path to the
    rounding of 8-bit-mantissa intensities (sub-0.1 px)."""
    import jax
    import jax.numpy as jnp
    from conftest import make_textured_image, shift_image_bilinear
    from pyfeaturetrack_tpu.config import create_config
    from pyfeaturetrack_tpu.ops.track import (build_track_pyramids_jit,
                                              track_features_pyramids)

    img1 = make_textured_image(120, 160, seed=31)
    img2 = shift_image_bilinear(img1, 1.3, -0.8)
    rng = np.random.default_rng(0)
    n = 64
    cfg32 = create_config()
    x = jnp.asarray(rng.uniform(cfg32.borderx + 2, 160 - cfg32.borderx - 3,
                                n), jnp.float32)
    y = jnp.asarray(rng.uniform(cfg32.bordery + 2, 120 - cfg32.bordery - 3,
                                n), jnp.float32)
    val = jnp.ones((n,), jnp.int32)

    outs = {}
    for name, cfg in (("f32", cfg32),
                      ("bf16", cfg32.replace(image_dtype="bfloat16"))):
        p1 = build_track_pyramids_jit(jnp.asarray(img1, jnp.float32), cfg)
        p2 = build_track_pyramids_jit(jnp.asarray(img2, jnp.float32), cfg)
        if name == "bf16":
            assert p1.img[0].dtype == jnp.bfloat16
            assert p1.gradx[1].dtype == jnp.bfloat16
        nx, ny, nv = jax.jit(track_features_pyramids,
                             static_argnames=("cfg",))(p1, p2, x, y, val,
                                                       cfg)
        outs[name] = (np.asarray(nx), np.asarray(ny), np.asarray(nv))

    v32, vbf = outs["f32"][2], outs["bf16"][2]
    # Lane-enumeration discipline (VERDICT r2 item 5): the old blanket
    # ">=95% agree" tolerance hid nothing — measured ZERO flipped lanes
    # on this scenario (2026-08-19, CPU backend and the 8-device mesh).
    # Assert the exclusion list explicitly; if a future numerics change
    # flips a lane, classify it (borderline residue/bounds/iterations)
    # and extend the list rather than re-blanketing.
    bf16_status_exclusions: list[int] = []
    flipped = np.where(v32 != vbf)[0]
    assert sorted(flipped.tolist()) == bf16_status_exclusions, (
        f"unclassified bf16 status flips at lanes {flipped.tolist()}: "
        f"{[(int(v32[i]), int(vbf[i])) for i in flipped]}")
    both = (v32 == 0) & (vbf == 0)
    assert both.sum() >= n // 2
    np.testing.assert_allclose(outs["bf16"][0][both], outs["f32"][0][both],
                               atol=0.1)
    np.testing.assert_allclose(outs["bf16"][1][both], outs["f32"][1][both],
                               atol=0.1)
