"""Streaming/serving path == the device-resident sequence loop."""

import numpy as np
import pytest

from conftest import make_textured_image

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.errors import KLTError
from pyfeaturetrack_tpu.models.device_sequence import track_sequence_device
from pyfeaturetrack_tpu.serving import (BatchedStreamingTracker,
                                        StreamingTracker,
                                        prefetch_to_device, serve_stream)


def _rolling_frames(n_frames=6, shift=4, seed=13):
    base = make_textured_image(120, 160, seed=seed)
    return [np.roll(base, shift * i, axis=1) for i in range(n_frames)]


@pytest.mark.parametrize("chain,prefetch", [(1, 2), (3, 2), (4, 0)])
def test_serve_stream_matches_device_loop(chain, prefetch):
    """serve_stream (prefetch thread on or off, chained or per-step)
    produces the identical track table to track_sequence_device."""
    frames = _rolling_frames(n_frames=7)
    cfg = create_config(mindist=8)
    dx, dy, dv = track_sequence_device(frames, cfg=cfg, n_features=40,
                                       replace_lost=True, chain=chain)
    sx, sy, sv = serve_stream(iter(frames), cfg=cfg, n_features=40,
                              replace_lost=True, chain=chain,
                              prefetch=prefetch)
    np.testing.assert_array_equal(sv, dv)
    np.testing.assert_allclose(sx, dx, atol=1e-5)
    np.testing.assert_allclose(sy, dy, atol=1e-5)


def test_serve_stream_uint8_staging_exact():
    """8-bit staged frames (4x less h2d) track identically to float32
    staging when the source is uint8 (the PGM lineage)."""
    frames = [f.astype(np.uint8) for f in _rolling_frames(n_frames=6)]
    cfg = create_config(mindist=8)
    fx, fy, fv = serve_stream(iter(frames), cfg=cfg, n_features=30,
                              chain=2, stage_uint8=False)
    ux, uy, uv = serve_stream(iter(frames), cfg=cfg, n_features=30,
                              chain=2, stage_uint8=True)
    np.testing.assert_array_equal(uv, fv)
    np.testing.assert_allclose(ux, fx, atol=1e-6)
    np.testing.assert_allclose(uy, fy, atol=1e-6)


def test_streaming_tracker_incremental_partial_chain():
    """Feeding one frame at a time with chain=4 and a stream length that
    leaves a partial chain (flush path) still matches per-step."""
    frames = _rolling_frames(n_frames=6)  # 5 tracked frames: 4 + partial 1
    cfg = create_config(mindist=8)
    dx, dy, dv = track_sequence_device(frames, cfg=cfg, n_features=30)
    tr = StreamingTracker(cfg, n_features=30, chain=4)
    for f in frames:
        tr.feed(f)
    sx, sy, sv = tr.table()
    assert sx.shape == dx.shape
    np.testing.assert_array_equal(sv, dv)
    np.testing.assert_allclose(sx, dx, atol=1e-5)


def test_streaming_tracker_emit_every():
    frames = _rolling_frames(n_frames=5)
    tr = StreamingTracker(create_config(mindist=8), n_features=20,
                          emit_every=2)
    emitted = [tr.feed(f) for f in frames]
    # fires on frames 2 and 4 (1-based), None otherwise
    assert [e is not None for e in emitted] == [False, True, False, True,
                                               False]
    x2, _, _ = emitted[1]
    assert x2.shape == (2, 20)
    x4, _, v4 = emitted[3]
    assert x4.shape == (4, 20)
    # emitted prefixes are consistent with the final table
    fx, _, fv = tr.table()
    assert fx.shape == (5, 20)
    np.testing.assert_allclose(fx[:4], x4, atol=1e-6)
    np.testing.assert_array_equal(fv[:4], v4)


def test_streaming_tracker_drain_releases_history():
    """drain() returns only rows since the previous drain and releases
    them (bounded memory for unbounded streams)."""
    frames = _rolling_frames(n_frames=7)
    cfg = create_config(mindist=8)
    full_x, _, full_v = serve_stream(iter(frames), cfg=cfg, n_features=20)
    tr = StreamingTracker(cfg, n_features=20)
    for f in frames[:4]:
        tr.feed(f)
    x1, _, v1 = tr.drain()
    assert x1.shape == (4, 20)
    for f in frames[4:]:
        tr.feed(f)
    x2, _, v2 = tr.drain()
    assert x2.shape == (3, 20)
    np.testing.assert_allclose(np.concatenate([x1, x2]), full_x,
                               atol=1e-5)
    np.testing.assert_array_equal(np.concatenate([v1, v2]), full_v)
    # empty interval: empty arrays, not an error
    x3, _, _ = tr.drain()
    assert x3.shape == (0, 20)


def test_prefetch_abandoned_consumer_stops_worker():
    """Breaking out of a prefetch iterator unblocks and stops the
    staging thread (no leak of the source or staged frames)."""
    import threading
    import time

    pulled = []

    def source():
        for i in range(100):
            pulled.append(i)
            yield np.zeros((4, 4), np.float32)

    before = threading.active_count()
    it = prefetch_to_device(source(), depth=2)
    next(it)
    it.close()  # abandon (same path as break / GC)
    for _ in range(50):
        if threading.active_count() <= before:
            break
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert len(pulled) < 100  # source was not fully consumed


def test_streaming_tracker_table_before_feed_raises():
    with pytest.raises(KLTError):
        StreamingTracker(create_config()).table()
    with pytest.raises(KLTError):
        StreamingTracker(create_config(), chain=0)


@pytest.mark.parametrize("replace_lost,affine,chain", [
    (True, -1, 1), (False, -1, 2), (True, 2, 2)])
def test_batched_streaming_matches_independent_streams(replace_lost,
                                                       affine, chain):
    """B lockstep streams == B independent StreamingTrackers, frame for
    frame (incl. replace-lost, affine mode 2, and a real partial-chain
    flush: 7 tracked frames with chain=2 leave a 1-tick tail)."""
    B, n = 3, 25
    cfg = create_config(mindist=8, affineConsistencyCheck=affine)
    streams = [_rolling_frames(n_frames=8, shift=3 + b, seed=20 + b)
               for b in range(B)]
    singles = []
    for b in range(B):
        tr = StreamingTracker(cfg, n_features=n,
                              replace_lost=replace_lost, chain=chain)
        for f in streams[b]:
            tr.feed(f)
        singles.append(tr.table())
    bt = BatchedStreamingTracker(cfg, n_streams=B, n_features=n,
                                 replace_lost=replace_lost, chain=chain)
    for i in range(8):
        bt.feed(np.stack([streams[b][i] for b in range(B)]))
    bx, by, bv = bt.table()
    assert bx.shape == (8, B, n)
    for b in range(B):
        np.testing.assert_array_equal(bv[:, b], singles[b][2])
        np.testing.assert_allclose(bx[:, b], singles[b][0], atol=1e-4)
        np.testing.assert_allclose(by[:, b], singles[b][1], atol=1e-4)


def test_batched_streaming_drain_and_validation():
    cfg = create_config(mindist=8)
    bt = BatchedStreamingTracker(cfg, n_streams=2, n_features=10)
    with pytest.raises(KLTError):
        bt.feed(np.zeros((3, 32, 32)))  # wrong stream count
    frames = _rolling_frames(n_frames=3)
    for i in range(3):
        bt.feed(np.stack([frames[i], frames[i]]))
    x1, _, _ = bt.drain()
    assert x1.shape == (3, 2, 10)
    x2, _, _ = bt.drain()
    assert x2.shape == (0, 2, 10)


def test_prefetch_to_device_order_and_residency():
    frames = [np.full((8, 8), i, np.float32) for i in range(5)]
    out = list(prefetch_to_device(iter(frames), depth=2))
    assert len(out) == 5
    for i, a in enumerate(out):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(a), frames[i])


def test_prefetch_to_device_relays_source_exception():
    def bad_source():
        yield np.zeros((4, 4), np.float32)
        raise RuntimeError("decoder died")

    it = prefetch_to_device(bad_source(), depth=2)
    next(it)
    with pytest.raises(RuntimeError, match="decoder died"):
        list(it)


def test_prefetch_depth_validation():
    with pytest.raises(KLTError):
        list(prefetch_to_device([], depth=0))


def test_batched_streaming_through_level_kernel_matches_xla(monkeypatch):
    """The batched tick vmaps one stream body over the stream axis; with
    its LK levels on the GPU level kernel (interpret mode, routed where
    CUDA would route them) the kernel takes the stream axis as a grid
    dimension. Statuses must equal the XLA tick exactly, positions to
    float tolerance."""
    import jax

    from pyfeaturetrack_tpu.ops import lk_gpu
    from pyfeaturetrack_tpu.ops import track as track_mod

    B, n = 3, 20
    cfg = create_config(mindist=8)
    streams = [_rolling_frames(n_frames=6, shift=3 + b, seed=40 + b)
               for b in range(B)]

    def run():
        bt = BatchedStreamingTracker(cfg, n_streams=B, n_features=n,
                                     replace_lost=True, chain=2)
        for i in range(6):
            bt.feed(np.stack([streams[b][i] for b in range(B)]))
        return bt.table()

    rx, ry, rv = run()

    def routed(*a):
        return lk_gpu.track_level_kernel(*a[:10], a[10], a[11],
                                         interpret=True)
    monkeypatch.setattr(track_mod, "track_level", routed)
    jax.clear_caches()   # the routed level must be traced afresh
    gx, gy, gv = run()
    jax.clear_caches()
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_allclose(gx, rx, atol=1e-3)
    np.testing.assert_allclose(gy, ry, atol=1e-3)
