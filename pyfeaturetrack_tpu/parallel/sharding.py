"""Multi-device sharding for the tracker.

The reference is single-threaded (SURVEY.md section 2.4) — this layer is
greenfield, designed per SURVEY.md sections 5.7/5.8: the parallel axes of
the KLT problem are

* ``frame`` — independent frame *pairs* (selection / two-frame LK), a
  data-parallel axis across chips;
* ``feature`` — features within a frame are fully independent (the
  reference's inner for-loop proves it), a model-parallel-like axis with
  zero cross-feature communication.

Communication is XLA collectives over the interconnect via ``jax.sharding`` +
``pjit``-style jit shardings on a `jax.sharding.Mesh`; images replicate
over the feature axis (cheap: one 640x480 frame is ~1.2 MB) while feature
state shards over it, so the batched bilinear gathers partition cleanly
with no resharding. Sequence chunk-and-stitch across hosts lives in
models/sequence.py's chunked driver.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..features import FeatureState
from ..ops.track import build_track_pyramids, track_features_pyramids

FRAME_AXIS = "frame"
FEATURE_AXIS = "feature"


def make_mesh(n_frame: int | None = None, n_feature: int = 1,
              devices=None) -> Mesh:
    """Build a (frame, feature) device mesh over all available devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_frame is None:
        n_frame = devices.size // n_feature
    devices = devices[:n_frame * n_feature].reshape(n_frame, n_feature)
    return Mesh(devices, (FRAME_AXIS, FEATURE_AXIS))


def shard_feature_state(fl: FeatureState, mesh: Mesh) -> FeatureState:
    """Place feature arrays sharded over the feature axis."""
    sh = NamedSharding(mesh, P(FEATURE_AXIS))
    return FeatureState(
        x=jax.device_put(fl.x, sh),
        y=jax.device_put(fl.y, sh),
        val=jax.device_put(fl.val, sh),
        aff=fl.aff,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def _track_pair_batch(imgs1, imgs2, x, y, val, cfg):
    """vmapped two-frame track over a batch of frame pairs.

    imgs*: [B, H, W]; x/y/val: [B, N]."""
    def one(i1, i2, xx, yy, vv):
        p1 = build_track_pyramids(i1, cfg)
        p2 = build_track_pyramids(i2, cfg)
        return track_features_pyramids(p1, p2, xx, yy, vv, cfg)
    return jax.vmap(one, in_axes=(0, 0, 0, 0, 0))(imgs1, imgs2, x, y, val)


def track_batch_sharded(imgs1, imgs2, x, y, val, cfg, mesh: Mesh):
    """Track B frame pairs x N features over the device mesh.

    Frame pairs shard over the ``frame`` axis, features over ``feature``;
    images are replicated along ``feature``. Everything below is one jit:
    XLA partitions the batched gathers and window reductions with no
    collectives on the hot path (features are independent).
    """
    img_sh = NamedSharding(mesh, P(FRAME_AXIS, None, None))
    feat_sh = NamedSharding(mesh, P(FRAME_AXIS, FEATURE_AXIS))
    imgs1 = jax.device_put(jnp.asarray(imgs1, jnp.float32), img_sh)
    imgs2 = jax.device_put(jnp.asarray(imgs2, jnp.float32), img_sh)
    x = jax.device_put(jnp.asarray(x, jnp.float32), feat_sh)
    y = jax.device_put(jnp.asarray(y, jnp.float32), feat_sh)
    val = jax.device_put(jnp.asarray(val, jnp.int32), feat_sh)
    return _track_pair_batch(imgs1, imgs2, x, y, val, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _full_pair_batch(imgs1, imgs2, x, y, val, cfg):
    """Reference-complete per-pair body: track + affine consistency +
    on-device replace-lost, vmapped over frame pairs. Exercises every
    pipeline stage under the mesh."""
    from ..ops.affine import affine_consistency_check, make_affine_state
    from ..ops.select import quantized_min_eig_map
    from ..ops.select_device import select_features_from_eig_device

    def one(i1, i2, xx, yy, vv):
        p1 = build_track_pyramids(i1, cfg)
        p2 = build_track_pyramids(i2, cfg)
        nx, ny, nv = track_features_pyramids(p1, p2, xx, yy, vv, cfg)
        aff = make_affine_state(xx.shape[0], cfg)
        fl_before = FeatureState(x=xx, y=yy, val=vv, aff=aff)
        fl_after = FeatureState(x=nx, y=ny, val=nv, aff=aff)
        fl_after = affine_consistency_check(p1, p2, fl_before, fl_after,
                                            cfg)
        eig = quantized_min_eig_map(p2.gradx[0], p2.grady[0],
                                    int(cfg.window_width),
                                    int(cfg.window_height))
        rx, ry, rv, _, _ = select_features_from_eig_device(
            eig, fl_after.x, fl_after.y, fl_after.val, cfg,
            replacing=True, top_k=256)
        return rx, ry, rv

    return jax.vmap(one, in_axes=(0, 0, 0, 0, 0))(imgs1, imgs2, x, y, val)


PIXROW_AXIS = "pixrow"


def dense_flow_sharded(img1, img2, cfg, mesh: Mesh | None = None):
    """Dense per-pixel flow for ONE frame pair with the pixel-row axis
    sharded over the mesh (pixels are features — the feature-axis design
    applies unchanged: images replicate, per-pixel state shards, the
    gathers partition with no collectives). Output (u, v, status) maps
    are row-sharded; image heights at every pyramid level must divide
    the device count.
    """
    from ..ops.flow import DenseFlow, dense_flow_pyramids
    from ..ops.track import build_track_pyramids

    if mesh is None:
        mesh = Mesh(np.asarray(jax.devices()), (PIXROW_AXIS,))
    flat = Mesh(mesh.devices.reshape(-1), (PIXROW_AXIS,))
    row_sh = NamedSharding(flat, P(PIXROW_AXIS, None))

    @functools.partial(
        jax.jit, static_argnames=("cfg",),
        out_shardings=DenseFlow(u=row_sh, v=row_sh, status=row_sh))
    def _flow(i1, i2, cfg):
        p1 = build_track_pyramids(i1, cfg)
        p2 = build_track_pyramids(i2, cfg)
        return dense_flow_pyramids.__wrapped__(p1, p2, cfg)

    rep = NamedSharding(flat, P())
    with flat:
        return _flow(jax.device_put(jnp.asarray(img1, jnp.float32), rep),
                     jax.device_put(jnp.asarray(img2, jnp.float32), rep),
                     cfg)


def dense_disparity_sharded(left, right, cfg, mesh: Mesh | None = None,
                            max_disparity: float = 64.0):
    """Dense rectified-stereo disparity for ONE pair with the pixel-row
    axis sharded over the mesh (same design as dense_flow_sharded:
    images replicate, per-pixel state shards, no collectives — the SSD
    hypothesis sweep and the 1-D LK are both row-local). Output (d,
    status) maps are row-sharded; level heights must divide the device
    count."""
    from ..ops.disparity import DenseDisparity, dense_disparity_pyramids
    from ..ops.track import build_track_pyramids

    if mesh is None:
        mesh = Mesh(np.asarray(jax.devices()), (PIXROW_AXIS,))
    flat = Mesh(mesh.devices.reshape(-1), (PIXROW_AXIS,))
    row_sh = NamedSharding(flat, P(PIXROW_AXIS, None))

    @functools.partial(
        jax.jit, static_argnames=("cfg", "max_disparity"),
        out_shardings=DenseDisparity(d=row_sh, status=row_sh))
    def _disp(i1, i2, cfg, max_disparity):
        p1 = build_track_pyramids(i1, cfg)
        p2 = build_track_pyramids(i2, cfg)
        return dense_disparity_pyramids.__wrapped__(
            p1, p2, cfg, max_disparity=max_disparity)

    rep = NamedSharding(flat, P())
    with flat:
        return _disp(jax.device_put(jnp.asarray(left, jnp.float32), rep),
                     jax.device_put(jnp.asarray(right, jnp.float32),
                                    rep),
                     cfg, float(max_disparity))


def multichip_track_step(n_devices: int, cfg=None,
                         image_shape=(64, 96), n_features: int = 64):
    """Compile + run ONE sharded tracking step on tiny shapes.

    Used by __graft_entry__.dryrun_multichip to validate the multi-chip
    sharding path compiles and executes (typically on a virtual CPU mesh).
    Returns the tracked (x, y, val) arrays.
    """
    from ..config import create_config
    if cfg is None:
        cfg = create_config()

    devices = jax.devices()
    assert len(devices) >= n_devices, (
        f"need {n_devices} devices, have {len(devices)}")
    n_feat_axis = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_frame=n_devices // n_feat_axis,
                     n_feature=n_feat_axis, devices=devices[:n_devices])

    b = int(np.prod(mesh.devices.shape[:1]))
    h, w = image_shape
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, size=(b, h, w))
    imgs1 = base
    imgs2 = np.roll(base, 1, axis=-1)
    xs = rng.uniform(cfg.borderx + 1, w - cfg.borderx - 2, (b, n_features))
    ys = rng.uniform(cfg.bordery + 1, h - cfg.bordery - 2, (b, n_features))
    vals = np.ones((b, n_features), np.int32)

    with mesh:
        nx, ny, nval = track_batch_sharded(imgs1, imgs2, xs, ys, vals,
                                           cfg, mesh)
        jax.block_until_ready((nx, ny, nval))
    return nx, ny, nval


def multichip_full_step(n_devices: int, image_shape=(64, 96),
                        n_features: int = 64):
    """Compile + run ONE sharded FULL-pipeline step (translational LK +
    lighting-insensitive residuals + affine consistency + on-device
    replace-lost) on tiny shapes over the (frame x feature) mesh."""
    from ..config import create_config
    cfg = create_config(affineConsistencyCheck=2,
                        lighting_insensitive=True).validated_window()

    devices = jax.devices()
    assert len(devices) >= n_devices, (
        f"need {n_devices} devices, have {len(devices)}")
    n_feat_axis = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_frame=n_devices // n_feat_axis,
                     n_feature=n_feat_axis, devices=devices[:n_devices])

    b = int(np.prod(mesh.devices.shape[:1]))
    h, w = image_shape
    rng = np.random.default_rng(0)
    imgs1 = rng.uniform(0, 255, size=(b, h, w))
    imgs2 = np.roll(imgs1, 2, axis=-1)
    xs = rng.uniform(cfg.borderx + 1, w - cfg.borderx - 2, (b, n_features))
    ys = rng.uniform(cfg.bordery + 1, h - cfg.bordery - 2, (b, n_features))
    vals = np.ones((b, n_features), np.int32)

    img_sh = NamedSharding(mesh, P(FRAME_AXIS, None, None))
    feat_sh = NamedSharding(mesh, P(FRAME_AXIS, FEATURE_AXIS))
    with mesh:
        out = _full_pair_batch(
            jax.device_put(jnp.asarray(imgs1, jnp.float32), img_sh),
            jax.device_put(jnp.asarray(imgs2, jnp.float32), img_sh),
            jax.device_put(jnp.asarray(xs, jnp.float32), feat_sh),
            jax.device_put(jnp.asarray(ys, jnp.float32), feat_sh),
            jax.device_put(jnp.asarray(vals, jnp.int32), feat_sh), cfg)
        jax.block_until_ready(out)
    return out


def multichip_chunked_sequence(n_devices: int, image_shape=(64, 96),
                               n_frames: int = 4, n_features: int = 16,
                               chain: int = 2):
    """Compile + run the chunk-and-stitch lockstep sequence driver
    (models/chunked.track_chunks_batched, replace-lost ON, micro-chained)
    with the CHUNK axis sharded over the mesh — one device per video
    chunk, the production shape for long-video chunk parallelism
    (every multi-device path is exercised, not just single steps).
    Returns the [C, F, N] history."""
    from ..config import create_config
    from ..models.chunked import track_chunks_batched
    cfg = create_config().replace(sequentialMode=True).validated_window()

    devices = jax.devices()
    assert len(devices) >= n_devices, (
        f"need {n_devices} devices, have {len(devices)}")
    mesh = Mesh(np.asarray(devices[:n_devices]), (FRAME_AXIS,))

    c = n_devices
    h, w = image_shape
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 255, size=(c, h, w)).astype(np.float32)
    img_sh = NamedSharding(mesh, P(FRAME_AXIS, None, None))
    feat_sh = NamedSharding(mesh, P(FRAME_AXIS, None))
    frame_steps = [
        jax.device_put(jnp.asarray(np.roll(base, 2 * i, axis=-1)),
                       img_sh)
        for i in range(n_frames)]
    xs = rng.uniform(cfg.borderx + 1, w - cfg.borderx - 2,
                     (c, n_features))
    ys = rng.uniform(cfg.bordery + 1, h - cfg.bordery - 2,
                     (c, n_features))
    vals = np.ones((c, n_features), np.int32)
    with mesh:
        out = track_chunks_batched(
            frame_steps,
            jax.device_put(jnp.asarray(xs, jnp.float32), feat_sh),
            jax.device_put(jnp.asarray(ys, jnp.float32), feat_sh),
            jax.device_put(jnp.asarray(vals), feat_sh),
            cfg, replace_lost=True, chain=chain)
        jax.block_until_ready(out[:3])
    return out[:3]


def multichip_batched_serving(n_devices: int, image_shape=(64, 96),
                              n_features: int = 16, n_steps: int = 3):
    """Compile + run the batched serving tick (serving._select_batch +
    _step_batch: B lockstep camera streams, one program per chained
    tick, replace-lost ON) with the STREAM axis sharded over the mesh —
    the multi-camera serving shape at one stream per device."""
    from ..config import create_config
    from ..serving import _select_batch, _step_batch
    cfg = create_config().replace(sequentialMode=True).validated_window()

    devices = jax.devices()
    assert len(devices) >= n_devices, (
        f"need {n_devices} devices, have {len(devices)}")
    mesh = Mesh(np.asarray(devices[:n_devices]), (FRAME_AXIS,))

    b = n_devices
    h, w = image_shape
    rng = np.random.default_rng(9)
    base = rng.uniform(0, 255, size=(b, h, w)).astype(np.float32)
    img_sh = NamedSharding(mesh, P(FRAME_AXIS, None, None))
    ticks = [jax.device_put(jnp.asarray(np.roll(base, 2 * i, axis=-1)),
                            img_sh)
             for i in range(n_steps)]
    top_k = 64
    with mesh:
        pyr, x, y, val, aff, _ = _select_batch(ticks[0], cfg,
                                               n_features, top_k)
        out = _step_batch(pyr, tuple(ticks), x, y, val, cfg, True,
                          top_k, aff, n_steps=n_steps,
                          stream_mesh=mesh)
        jax.block_until_ready(out[2])
    return out
