"""The GPU LK level kernel (ops/lk_gpu) == the XLA level
(ops/track.track_feature_level), which test_track.py pins to the
float64 oracle.

On the CPU the kernel body runs in Pallas interpret mode. Tests with a
``compiled`` parameter also run the kernel as compiled for the card;
those carry the ``gpu`` marker and skip anywhere else.

Tolerances: statuses and iteration counts are asserted EXACTLY equal.
Positions get 1e-3 px: the kernel has no matrix product (no TF32), so
they differ only by FMA contraction and the order of the window sums,
which compound over at most max_iterations Newton steps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.ops import lk_gpu
from pyfeaturetrack_tpu.ops import track as track_mod
from pyfeaturetrack_tpu.ops.convolve import (compute_gradients,
                                             compute_smoothed_image)
from pyfeaturetrack_tpu.ops.track import track_feature_level

_ATOL = 1e-3
MODES = ["interpret", pytest.param("compiled", marks=pytest.mark.gpu)]


def _level_inputs(h, w, shift=(1, 2), seed=0, smooth_passes=1):
    rng = np.random.default_rng(seed)
    pad = max(8, *shift)
    base = rng.uniform(0, 255, (h + pad, w + pad))
    k = np.array([1.0, 4, 6, 4, 1]) / 16.0
    for _ in range(smooth_passes):
        for axis in (0, 1):
            base = np.apply_along_axis(
                lambda m: np.convolve(m, k, mode="same"), axis, base)
    dy, dx = shift
    img1 = jnp.asarray(base[:h, :w], jnp.float32)
    img2 = jnp.asarray(base[dy:h + dy, dx:w + dx], jnp.float32)
    return img1, img2


def _prep(cfg, img1, img2):
    s1 = compute_smoothed_image(img1, cfg.smooth_sigma)
    s2 = compute_smoothed_image(img2, cfg.smooth_sigma)
    gx1, gy1 = compute_gradients(s1, cfg.grad_sigma)
    gx2, gy2 = compute_gradients(s2, cfg.grad_sigma)
    return s1, gx1, gy1, s2, gx2, gy2


def _kernel(x, y, lvl, cfg, act, mode="interpret", **kw):
    return lk_gpu.track_level_kernel(x, y, x, y, *lvl, cfg, act,
                                     interpret=mode == "interpret", **kw)


def _assert_matches(cfg, lvl, x, y, act, mode="interpret", atol=_ATOL,
                    **kw):
    kx, ky, ks, ki = _kernel(x, y, lvl, cfg, act, mode, **kw)
    rx, ry, rs, ri = track_feature_level(x, y, x, y, *lvl, cfg, act)
    np.testing.assert_array_equal(np.asarray(ks), np.asarray(rs))
    np.testing.assert_array_equal(np.asarray(ki), np.asarray(ri))
    np.testing.assert_allclose(np.asarray(kx), np.asarray(rx), atol=atol)
    np.testing.assert_allclose(np.asarray(ky), np.asarray(ry), atol=atol)
    return np.asarray(rs)


def _compare(cfg, h=120, w=160, n=64, seed=0, shift=(1, 2),
             active_frac=1.0, near_border=False, mode="interpret", **kw):
    assert lk_gpu.kernel_supported((h, w), cfg)
    img1, img2 = _level_inputs(h, w, shift=shift, seed=seed)
    lvl = _prep(cfg, img1, img2)
    rng = np.random.default_rng(seed + 1)
    if near_border:
        x = jnp.asarray(rng.uniform(3.0, 6.0, n), jnp.float32)
        y = jnp.asarray(rng.uniform(3.0, 6.0, n), jnp.float32)
    else:
        x = jnp.asarray(rng.uniform(8, w - 9, n), jnp.float32)
        y = jnp.asarray(rng.uniform(8, h - 9, n), jnp.float32)
    act = jnp.asarray(rng.uniform(size=n) < active_frac)
    rs = _assert_matches(cfg, lvl, x, y, act, mode=mode, **kw)
    return rs, np.asarray(act)


@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_xla_default(mode):
    rs, act = _compare(create_config(), mode=mode)
    assert (rs[act] == 0).sum() > 10


def test_kernel_positions_near_bitwise_equal():
    """Interpret mode evaluates the kernel's arithmetic on the CPU, so
    every lane lands within float32 rounding of the XLA level."""
    cfg = create_config()
    h, w, n = 120, 160, 64
    img1, img2 = _level_inputs(h, w, seed=0)
    lvl = _prep(cfg, img1, img2)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.uniform(8, w - 9, n), jnp.float32)
    y = jnp.asarray(rng.uniform(8, h - 9, n), jnp.float32)
    act = jnp.ones((n,), bool)
    _assert_matches(cfg, lvl, x, y, act, atol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_kernel_large_shift_matches_xla(mode):
    """A large shift drives tracks far from their entry position and
    through many iterations; the in-kernel loop must keep every lane's
    status and iteration count."""
    cfg = create_config()
    h, w, n = 120, 160, 96
    img1, img2 = _level_inputs(h, w, shift=(5, 9), seed=2)
    lvl = _prep(cfg, img1, img2)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.uniform(12, w - 13, n), jnp.float32)
    y = jnp.asarray(rng.uniform(12, h - 13, n), jnp.float32)
    act = jnp.ones((n,), bool)
    _assert_matches(cfg, lvl, x, y, act, mode=mode)


def test_kernel_inactive_lanes_pass_through():
    _compare(create_config(), active_frac=0.6, seed=3)


@pytest.mark.parametrize("mode", MODES)
def test_kernel_near_border_oob(mode):
    rs, act = _compare(create_config(), near_border=True, seed=4,
                       mode=mode)
    assert (rs[act] == -4).any()  # KLT_OOB exercised


def test_kernel_right_bottom_edge_band():
    cfg = create_config()
    h, w = 120, 160
    img1, img2 = _level_inputs(h, w, shift=(1, 1), seed=12)
    lvl = _prep(cfg, img1, img2)
    hw = cfg.window_width // 2
    rng = np.random.default_rng(13)
    n = 40
    x = np.concatenate([rng.uniform(w - hw - 2.0, w - hw - 1.01, n // 2),
                        rng.uniform(10, 20, n - n // 2)])
    y = np.concatenate([rng.uniform(10, 20, n // 2),
                        rng.uniform(h - hw - 2.0, h - hw - 1.01,
                                    n - n // 2)])
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    act = jnp.ones((n,), bool)
    _assert_matches(cfg, lvl, x, y, act)


@pytest.mark.parametrize("mode", MODES)
def test_kernel_small_det(mode):
    cfg = create_config()
    h, w, n = 120, 160, 16
    img = jnp.full((h, w), 100.0, jnp.float32)
    lvl = _prep(cfg, img, img)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(10, w - 11, n), jnp.float32)
    y = jnp.asarray(rng.uniform(10, h - 11, n), jnp.float32)
    act = jnp.ones((n,), bool)
    rs = _assert_matches(cfg, lvl, x, y, act, mode=mode)
    assert (rs == -2).all()  # KLT_SMALL_DET


@pytest.mark.parametrize("mode", MODES)
def test_kernel_max_iterations_and_residue(mode):
    cfg = create_config().replace(max_iterations=3,
                                  min_displacement=1e-6,
                                  max_residue=2.0)
    img1, _ = _level_inputs(120, 160, seed=0)
    _, img2 = _level_inputs(120, 160, seed=9)
    lvl = _prep(cfg, img1, img2)
    rng = np.random.default_rng(2)
    n = 48
    x = jnp.asarray(rng.uniform(10, 149, n), jnp.float32)
    y = jnp.asarray(rng.uniform(10, 109, n), jnp.float32)
    act = jnp.ones((n,), bool)
    rs = _assert_matches(cfg, lvl, x, y, act, mode=mode)
    assert set(np.unique(rs)) & {-3, -5}


@pytest.mark.parametrize("mode", MODES)
def test_kernel_lighting_insensitive(mode):
    cfg = create_config().replace(lighting_insensitive=True)
    img1, img2 = _level_inputs(120, 160, seed=5)
    img2 = img2 * 1.3 + 12.0
    lvl = _prep(cfg, img1, img2)
    rng = np.random.default_rng(6)
    n = 40
    x = jnp.asarray(rng.uniform(8, 151, n), jnp.float32)
    y = jnp.asarray(rng.uniform(8, 111, n), jnp.float32)
    act = jnp.ones((n,), bool)
    _assert_matches(cfg, lvl, x, y, act, mode=mode, atol=2e-3)


@pytest.mark.parametrize("wsz", [5, 9, 13])
def test_kernel_window_sizes(wsz):
    cfg = create_config().replace(window_width=wsz, window_height=wsz)
    _compare(cfg, seed=wsz)


@pytest.mark.parametrize("n", [1, 31, 33, 70])
def test_kernel_partial_last_block(n):
    """Feature counts that leave the last program's block partly padded:
    padded lanes are inactive and never leak into real ones."""
    _compare(create_config(), n=n, seed=40 + n)


def test_kernel_all_inactive_block():
    """A block whose lanes are all inactive exits its loop at once and
    passes positions through with TRACKED status and zero iterations."""
    cfg = create_config()
    img1, img2 = _level_inputs(120, 160, seed=41)
    lvl = _prep(cfg, img1, img2)
    rng = np.random.default_rng(42)
    n = 64
    x = jnp.asarray(rng.uniform(10, 149, n), jnp.float32)
    y = jnp.asarray(rng.uniform(10, 109, n), jnp.float32)
    act = jnp.asarray(np.arange(n) >= 32)   # block 0 all inactive
    kx, ky, ks, ki = _kernel(x, y, lvl, cfg, act)
    np.testing.assert_array_equal(np.asarray(kx)[:32], np.asarray(x)[:32])
    np.testing.assert_array_equal(np.asarray(ks)[:32], 0)
    np.testing.assert_array_equal(np.asarray(ki)[:32], 0)
    _assert_matches(cfg, lvl, x, y, act)


@pytest.mark.parametrize("block", [8, 32, 64])
def test_kernel_block_size_invariant(block):
    """Results do not depend on how lanes are blocked into programs."""
    cfg = create_config()
    img1, img2 = _level_inputs(120, 160, seed=17)
    lvl = _prep(cfg, img1, img2)
    rng = np.random.default_rng(18)
    n = 48
    x = jnp.asarray(rng.uniform(8, 151, n), jnp.float32)
    y = jnp.asarray(rng.uniform(8, 111, n), jnp.float32)
    act = jnp.asarray(rng.uniform(size=n) < 0.9)
    a = _kernel(x, y, lvl, cfg, act, block=block)
    b = _kernel(x, y, lvl, cfg, act, block=16)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_kernel_vmapped_equals_looped():
    """Under jax.vmap the stream axis becomes one more grid dimension;
    each stream's result equals its own unbatched call."""
    cfg = create_config()
    streams = [_prep(cfg, *_level_inputs(96, 128, seed=50 + s))
               for s in range(3)]
    rng = np.random.default_rng(53)
    n = 40
    x = jnp.asarray(rng.uniform(8, 119, (3, n)), jnp.float32)
    y = jnp.asarray(rng.uniform(8, 87, (3, n)), jnp.float32)
    act = jnp.ones((3, n), bool)
    lvls = tuple(jnp.stack([s[i] for s in streams]) for i in range(6))
    batched = jax.vmap(lambda xx, yy, aa, *lv: lk_gpu.track_level_kernel(
        xx, yy, xx, yy, *lv, cfg, aa, interpret=True))(x, y, act, *lvls)
    for s in range(3):
        one = _kernel(x[s], y[s], streams[s], cfg, act[s])
        for u, v in zip(batched, one):
            np.testing.assert_array_equal(np.asarray(u)[s], np.asarray(v))


def test_kernel_rejects_mismatched_planes():
    """All six level planes must share one shape: the kernel indexes
    them with one flat stride."""
    cfg = create_config()
    img1, img2 = _level_inputs(64, 96, seed=70)
    lvl = list(_prep(cfg, img1, img2))
    lvl[3] = lvl[3][:, :-1]
    x = jnp.full((4,), 40.0, jnp.float32)
    with pytest.raises(ValueError, match="share one shape"):
        _kernel(x, x, lvl, cfg, jnp.ones((4,), bool))


@pytest.mark.parametrize("shape,window,taken", [
    ((480, 640), (7, 7), True),
    ((1088, 1920), (7, 7), True),
    ((7, 9), (7, 5), True),        # rows 7 >= 5 + 1, cols 9 >= 7 + 1
    ((8, 8), (7, 7), True),
    ((7, 8), (7, 7), False),       # 7 rows < 7 + 1
    ((480, 640), (15, 15), True),  # 16 x 16 = MAX_TAPS
    ((480, 640), (17, 15), False),  # 32 x 16 taps
    ((46341, 46341), (7, 7), False),  # flat index overflows int32
])
def test_kernel_shape_gate(shape, window, taken):
    """The written rule: the kernel takes a level when its padded window
    has at most MAX_TAPS taps, the image holds the window and its flat
    index fits in int32; anything else runs the XLA level."""
    cfg = create_config().replace(window_width=window[0],
                                  window_height=window[1])
    assert lk_gpu.kernel_supported(shape, cfg) is taken


def _patch_dispatch_to_kernel(monkeypatch):
    """Route ops/track.track_level through the kernel in interpret mode
    wherever the shape gate takes the level (what CUDA lowers to)."""
    def routed(*a):
        cfg, act = a[10], a[11]
        if not lk_gpu.kernel_supported(a[4].shape, cfg):
            return track_feature_level(*a)
        return lk_gpu.track_level_kernel(*a[:10], cfg, act,
                                         interpret=True)
    monkeypatch.setattr(track_mod, "track_level", routed)


def test_track_pyramids_through_kernel_matches_xla(monkeypatch):
    """track_features_pyramids with its levels on the kernel equals the
    XLA pyramid path."""
    from pyfeaturetrack_tpu.ops.track import (build_track_pyramids,
                                              track_features_pyramids)
    cfg = create_config()
    h, w, n = 104, 224, 30
    img1, img2 = _level_inputs(h, w, seed=7)
    build = jax.jit(build_track_pyramids, static_argnames=("cfg",))
    p1 = build(img1, cfg)
    p2 = build(img2, cfg)
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.uniform(cfg.borderx + 1, w - cfg.borderx - 2, n),
                    jnp.float32)
    y = jnp.asarray(rng.uniform(cfg.bordery + 1, h - cfg.bordery - 2, n),
                    jnp.float32)
    val = jnp.ones((n,), jnp.int32)

    rx, ry, rv = track_features_pyramids.__wrapped__(p1, p2, x, y, val, cfg)
    _patch_dispatch_to_kernel(monkeypatch)
    kx, ky, kv = track_features_pyramids.__wrapped__(p1, p2, x, y, val, cfg)
    np.testing.assert_array_equal(np.asarray(kv), np.asarray(rv))
    np.testing.assert_allclose(np.asarray(kx), np.asarray(rx), atol=_ATOL)
    np.testing.assert_allclose(np.asarray(ky), np.asarray(ry), atol=_ATOL)


def test_dispatch_on_cpu_is_the_xla_level():
    """On a non-CUDA platform track_level lowers only the XLA branch:
    results are bitwise those of track_feature_level, and the CPU
    program holds no Triton call."""
    cfg = create_config()
    img1, img2 = _level_inputs(96, 128, seed=60)
    lvl = _prep(cfg, img1, img2)
    rng = np.random.default_rng(61)
    n = 40
    x = jnp.asarray(rng.uniform(8, 119, n), jnp.float32)
    y = jnp.asarray(rng.uniform(8, 87, n), jnp.float32)
    act = jnp.ones((n,), bool)
    f = jax.jit(lambda *a: track_mod.track_level(*a, cfg, act))
    got = f(x, y, x, y, *lvl)
    want = jax.jit(lambda *a: track_feature_level(*a, cfg, act))(
        x, y, x, y, *lvl)
    for u, v in zip(got, want):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    hlo = f.lower(x, y, x, y, *lvl).as_text()
    assert "triton" not in hlo.lower()


def test_gate_rejects_oversized_window_and_dispatch_falls_back(monkeypatch):
    """A window the gate refuses (17x15 pads to 512 taps) runs the XLA
    level even where the kernel would be chosen: end-to-end results
    equal the XLA run bitwise."""
    from pyfeaturetrack_tpu.ops.track import (build_track_pyramids,
                                              track_features_pyramids)
    cfg = create_config().replace(window_width=17, window_height=15)
    assert not lk_gpu.kernel_supported((120, 160), cfg)
    h, w, n = 120, 160, 32
    img1, img2 = _level_inputs(h, w, seed=31)
    build = jax.jit(build_track_pyramids, static_argnames=("cfg",))
    p1, p2 = build(img1, cfg), build(img2, cfg)
    rng = np.random.default_rng(32)
    x = jnp.asarray(rng.uniform(cfg.borderx + 1, w - cfg.borderx - 2, n),
                    jnp.float32)
    y = jnp.asarray(rng.uniform(cfg.bordery + 1, h - cfg.bordery - 2, n),
                    jnp.float32)
    val = jnp.ones((n,), jnp.int32)
    ref = track_features_pyramids.__wrapped__(p1, p2, x, y, val, cfg)
    _patch_dispatch_to_kernel(monkeypatch)
    got = track_features_pyramids.__wrapped__(p1, p2, x, y, val, cfg)
    for u, v in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_kernel_bf16_storage_matches_xla_bf16(monkeypatch):
    """bf16 image storage: the kernel loads bf16 taps and upcasts them
    to f32 before blending, as the XLA path does at its gather, so
    statuses are exact and positions agree to float tolerance."""
    from pyfeaturetrack_tpu.ops.track import (build_track_pyramids,
                                              track_features_pyramids)
    cfg = create_config().replace(image_dtype="bfloat16")
    h, w, n = 112, 208, 30
    img1, img2 = _level_inputs(h, w, seed=23)
    build = jax.jit(build_track_pyramids, static_argnames=("cfg",))
    p1 = build(img1, cfg)
    p2 = build(img2, cfg)
    assert p1.img[0].dtype == jnp.bfloat16
    rng = np.random.default_rng(24)
    x = jnp.asarray(rng.uniform(cfg.borderx + 1, w - cfg.borderx - 2, n),
                    jnp.float32)
    y = jnp.asarray(rng.uniform(cfg.bordery + 1, h - cfg.bordery - 2, n),
                    jnp.float32)
    val = jnp.ones((n,), jnp.int32)

    rx, ry, rv = track_features_pyramids.__wrapped__(p1, p2, x, y, val, cfg)
    _patch_dispatch_to_kernel(monkeypatch)
    kx, ky, kv = track_features_pyramids.__wrapped__(p1, p2, x, y, val, cfg)
    np.testing.assert_array_equal(np.asarray(kv), np.asarray(rv))
    np.testing.assert_allclose(np.asarray(kx), np.asarray(rx), atol=_ATOL)
    np.testing.assert_allclose(np.asarray(ky), np.asarray(ry), atol=_ATOL)


@pytest.mark.parametrize("mode", ["grad", "jvp",
                                  pytest.param("grad_on_card",
                                               marks=pytest.mark.gpu)])
def test_gradient_rule_is_the_xla_level(mode):
    """Differentiating ops/track.track_level gives the derivatives of
    track_feature_level, whichever route the primal takes (on the card
    the primal is the kernel, whose in-program loop has no reverse-mode
    rule): bit for bit on the CPU, to float32 rounding on the card."""
    cfg = create_config()
    img1, img2 = _level_inputs(64, 96, seed=80)
    lvl = _prep(cfg, img1, img2)
    rng = np.random.default_rng(81)
    n = 24
    x = jnp.asarray(rng.uniform(10, 85, n), jnp.float32)
    y = jnp.asarray(rng.uniform(10, 53, n), jnp.float32)
    act = jnp.ones((n,), bool)

    def loss(level_fn, im2):
        ox, oy, _, _ = level_fn(x, y, x, y, *lvl[:3], im2, *lvl[4:], cfg,
                                act)
        return jnp.sum(ox * ox + oy)

    routed = functools.partial(loss, track_mod.track_level)
    ref = functools.partial(loss, track_feature_level)
    if mode == "jvp":
        t = jnp.ones_like(lvl[3])
        got = jax.jvp(routed, (lvl[3],), (t,))[1]
        want = jax.jvp(ref, (lvl[3],), (t,))[1]
    else:
        got = jax.grad(routed)(lvl[3])
        want = jax.grad(ref)(lvl[3])
    got, want = np.asarray(got), np.asarray(want)
    if mode == "grad_on_card":
        # Two separately compiled GPU programs may contract the same
        # multiply-adds differently: equal up to float32 rounding.
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)
    assert np.any(want != 0)
