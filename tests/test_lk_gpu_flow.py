"""Dense flow through the GPU LK level kernel (ops/lk_gpu) == XLA dense
flow (interpret mode on the CPU; tests with a ``compiled`` parameter run
the kernel as compiled for the card and carry the ``gpu`` marker).

Two things are pinned here:

1. the kernel's grid over feature blocks (a ragged tail padded into the
   last block) returns bit-equal results for every block size, and
   matches the XLA level;
2. ops/flow.flow_level and dense_flow_pyramids with their levels on the
   kernel match the XLA dense path exactly on statuses and to float
   tolerance on flow (no matrix product in the kernel: the gap is FMA
   contraction and summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.ops import flow as flow_mod
from pyfeaturetrack_tpu.ops import lk_gpu
from pyfeaturetrack_tpu.ops.convolve import (compute_gradients,
                                             compute_smoothed_image)
from pyfeaturetrack_tpu.ops.flow import dense_flow_pyramids, flow_level
from pyfeaturetrack_tpu.ops.track import (build_track_pyramids_jit,
                                          track_feature_level)

MODES = ["interpret", pytest.param("compiled", marks=pytest.mark.gpu)]


def _pair(h, w, shift=(1, 2), seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h + 8, w + 8))
    k = np.array([1.0, 4, 6, 4, 1]) / 16.0
    for axis in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), axis, base)
    dy, dx = shift
    return (jnp.asarray(base[:h, :w], jnp.float32),
            jnp.asarray(base[dy:h + dy, dx:w + dx], jnp.float32))


def _level(cfg, img1, img2):
    s1 = compute_smoothed_image(img1, cfg.smooth_sigma)
    s2 = compute_smoothed_image(img2, cfg.smooth_sigma)
    return (s1, *compute_gradients(s1, cfg.grad_sigma),
            s2, *compute_gradients(s2, cfg.grad_sigma))


def _route_flow_to_kernel(monkeypatch, mode="interpret"):
    """flow_level's track_level -> the kernel (what CUDA lowers to)."""
    def routed(*a):
        return lk_gpu.track_level_kernel(*a[:10], a[10], a[11],
                                         interpret=mode == "interpret")
    monkeypatch.setattr(flow_mod, "track_level", routed)


def test_block_grid_matches_single_block_and_xla():
    """block=16 over n=50 (ragged tail -> padded grid) == one block of
    64 == XLA level, statuses bit-equal."""
    cfg = create_config()
    h, w = 96, 128
    assert lk_gpu.kernel_supported((h, w), cfg)
    lvl = _level(cfg, *_pair(h, w))
    rng = np.random.default_rng(7)
    n = 50
    x = jnp.asarray(rng.uniform(8, w - 9, n), jnp.float32)
    y = jnp.asarray(rng.uniform(8, h - 9, n), jnp.float32)
    act = jnp.asarray(rng.uniform(size=n) < 0.8)

    cx, cy, cs, ci = lk_gpu.track_level_kernel(
        x, y, x, y, *lvl, cfg, act, interpret=True, block=16)
    sx, sy, ss, si = lk_gpu.track_level_kernel(
        x, y, x, y, *lvl, cfg, act, interpret=True, block=64)
    rx, ry, rs, ri = track_feature_level(x, y, x, y, *lvl, cfg, act)

    np.testing.assert_array_equal(np.asarray(cs), np.asarray(ss))
    np.testing.assert_array_equal(np.asarray(ci), np.asarray(si))
    np.testing.assert_array_equal(np.asarray(cx), np.asarray(sx))
    np.testing.assert_array_equal(np.asarray(cy), np.asarray(sy))
    np.testing.assert_array_equal(np.asarray(cs), np.asarray(rs))
    np.testing.assert_allclose(np.asarray(cx), np.asarray(rx), atol=1e-3)
    np.testing.assert_allclose(np.asarray(cy), np.asarray(ry), atol=1e-3)


@pytest.mark.parametrize("mode", MODES)
def test_flow_level_kernel_matches_xla(monkeypatch, mode):
    """flow_level with every pixel through the kernel: status maps
    bit-equal, flow to float tolerance."""
    cfg = create_config()
    h, w = 40, 56
    lvl = _level(cfg, *_pair(h, w, shift=(1, 1), seed=3))
    rng = np.random.default_rng(4)
    u0 = jnp.asarray(rng.uniform(-0.5, 0.5, (h, w)), jnp.float32)
    v0 = jnp.asarray(rng.uniform(-0.5, 0.5, (h, w)), jnp.float32)

    ur, vr, sr = flow_level(*lvl, u0, v0, cfg)
    _route_flow_to_kernel(monkeypatch, mode)
    uf, vf, sf = flow_level(*lvl, u0, v0, cfg)

    np.testing.assert_array_equal(np.asarray(sf), np.asarray(sr))
    np.testing.assert_allclose(np.asarray(uf), np.asarray(ur), atol=1e-3)
    np.testing.assert_allclose(np.asarray(vf), np.asarray(vr), atol=1e-3)


def test_dense_flow_pyramids_kernel_matches_xla(monkeypatch):
    """Full coarse-to-fine dense flow through the kernel == XLA dense
    flow (eager __wrapped__ calls so the routed level is traced)."""
    cfg = create_config().validated_window()
    h, w = 48, 64
    img1, img2 = _pair(h, w, shift=(1, 2), seed=5)
    p1 = build_track_pyramids_jit(img1, cfg)
    p2 = build_track_pyramids_jit(img2, cfg)

    ref = dense_flow_pyramids.__wrapped__(p1, p2, cfg)
    _route_flow_to_kernel(monkeypatch)
    got = dense_flow_pyramids.__wrapped__(p1, p2, cfg)

    np.testing.assert_array_equal(np.asarray(got.status),
                                  np.asarray(ref.status))
    tracked = np.asarray(ref.status) == 0
    assert tracked.sum() > 0.5 * tracked.size
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(ref.u),
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(got.v), np.asarray(ref.v),
                               atol=2e-3)


def test_dense_flow_kernel_matches_flow_oracle(monkeypatch):
    """Dense flow on the kernel against the float64 flow oracle: the
    kernel inherits the XLA path's oracle parity (statuses equal except
    lanes at a threshold, which this scene has none of)."""
    from pyfeaturetrack_tpu.oracle import flow_oracle
    cfg = create_config().validated_window()
    h, w = 48, 64
    img1, img2 = _pair(h, w, shift=(1, 2), seed=6)
    p1 = build_track_pyramids_jit(img1, cfg)
    p2 = build_track_pyramids_jit(img2, cfg)
    _route_flow_to_kernel(monkeypatch)
    got = dense_flow_pyramids.__wrapped__(p1, p2, cfg)
    f64 = lambda t: [np.asarray(a, np.float64) for a in t]  # noqa: E731
    u, v, st = flow_oracle.dense_flow(
        f64(p1.img), f64(p1.gradx), f64(p1.grady),
        f64(p2.img), f64(p2.gradx), f64(p2.grady), cfg)
    np.testing.assert_array_equal(np.asarray(got.status), st)
    ok = st == 0
    np.testing.assert_allclose(np.asarray(got.u)[ok], u[ok], atol=2e-3)
    np.testing.assert_allclose(np.asarray(got.v)[ok], v[ok], atol=2e-3)


def test_dense_flow_batched_through_kernel(monkeypatch):
    """dense_flow_batched vmaps the level kernel over the pair axis:
    each pair equals its own unbatched kernel flow."""
    cfg = create_config().validated_window()
    h, w = 40, 48
    pairs = [_pair(h, w, shift=(1, 1 + b), seed=70 + b) for b in range(2)]
    _route_flow_to_kernel(monkeypatch)
    batched = flow_mod.dense_flow_batched.__wrapped__(
        jnp.stack([p[0] for p in pairs]), jnp.stack([p[1] for p in pairs]),
        cfg)
    for b, (a1, a2) in enumerate(pairs):
        one = dense_flow_pyramids.__wrapped__(
            build_track_pyramids_jit(a1, cfg),
            build_track_pyramids_jit(a2, cfg), cfg)
        np.testing.assert_array_equal(np.asarray(batched.status)[b],
                                      np.asarray(one.status))
        np.testing.assert_allclose(np.asarray(batched.u)[b],
                                   np.asarray(one.u), atol=1e-4)
