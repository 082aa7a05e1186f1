"""Device-resident sequence tracking: the example3 loop with ZERO
per-frame host synchronization.

Reference parity: example3.py / SURVEY.md section 3.5 — the same
select -> (track -> replace-lost)* recurrence as models.sequence, but
with the whole per-frame body (pyramid build, batched pyramidal LK, and
on-device replace-lost from ops.select_device) fused into one jitted
program whose state (pyramids + feature arrays) never leaves the
device. This is the BASELINE config-2 serving path: the host loop only
*issues* steps and pulls the stacked track table once at the end.

Replacement is lax.cond-gated on "any feature lost", so frames where
every feature tracks pay zero selection cost. The affine-consistency
stage (cfg.affineConsistencyCheck >= 0) runs device-side too, carrying
the AffineState (templates + warps) between steps.
"""

from __future__ import annotations

import functools
from typing import Iterable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import TrackerConfig, create_config
from ..features import KLT_NOT_FOUND
from ..ops.select import quantized_min_eig_map, selection_eig_map_core
from ..ops.select_device import (DEFAULT_TOP_K,
                                 select_features_from_eig_device)
from ..ops.track import (TrackPyramids, build_track_pyramids,
                         track_features_pyramids)


def _selection_eig_from_pyr(img: jax.Array, pyr: TrackPyramids, cfg
                            ) -> jax.Array:
    """Min-eig map for selection, reusing the tracking pyramid's level-0
    gradients when the configs coincide (smoothBeforeSelecting=True means
    selection smooths with smooth_sigma exactly like the pyramid base)."""
    if cfg.smoothBeforeSelecting:
        return quantized_min_eig_map(pyr.gradx[0], pyr.grady[0],
                                     int(cfg.window_width),
                                     int(cfg.window_height))
    return selection_eig_map_core(
        img, window_width=int(cfg.window_width),
        window_height=int(cfg.window_height), smooth_before=False,
        smooth_sigma=float(cfg.smooth_sigma),
        grad_sigma=float(cfg.grad_sigma))


@functools.partial(jax.jit, static_argnames=("cfg", "n_features", "top_k"))
def select_step_device(img: jax.Array, cfg, n_features: int,
                       top_k: int = DEFAULT_TOP_K):
    """Frame-0 step: build pyramids + select n_features on device.

    Returns (pyr, x, y, val, aff, exhausted) — ``aff`` is a fresh
    AffineState when cfg.affineConsistencyCheck >= 0, else None."""
    from ..ops.affine import make_affine_state
    img = jnp.asarray(img, jnp.float32)
    pyr = build_track_pyramids(img, cfg)
    eig = _selection_eig_from_pyr(img, pyr, cfg)
    x0 = jnp.full((n_features,), -1.0, jnp.float32)
    y0 = jnp.full((n_features,), -1.0, jnp.float32)
    v0 = jnp.full((n_features,), KLT_NOT_FOUND, jnp.int32)
    x, y, val, _, exhausted = select_features_from_eig_device(
        eig, x0, y0, v0, cfg, replacing=False, top_k=top_k)
    aff = (make_affine_state(n_features, cfg)
           if cfg.affineConsistencyCheck >= 0 else None)
    return pyr, x, y, val, aff, exhausted


def _sequence_step_body(pyr_prev: TrackPyramids, img_new: jax.Array,
                        x: jax.Array, y: jax.Array, val: jax.Array,
                        cfg, replace_lost: bool,
                        top_k: int, aff):
    """Traceable one-frame body shared by the per-step and micro-chained
    drivers. Returns (pyr_new, x, y, val, aff, exhausted) —
    ``exhausted`` is True when a refill ran out of top-K candidates with
    free slots left (the one case where the device path can fill fewer
    slots than the host's full candidate scan; drivers surface it as a
    warning)."""
    from ..features import FeatureState, reset_affine
    img_new = jnp.asarray(img_new, jnp.float32)
    pyr_new = build_track_pyramids(img_new, cfg)
    nx, ny, nval = track_features_pyramids(pyr_prev, pyr_new, x, y, val,
                                           cfg)

    if cfg.affineConsistencyCheck >= 0:
        from ..ops.affine import affine_consistency_check
        fl_before = FeatureState(x=x, y=y, val=val, aff=aff)
        fl_after = FeatureState(x=nx, y=ny, val=nval, aff=aff)
        fl_after = affine_consistency_check(pyr_prev, pyr_new, fl_before,
                                            fl_after, cfg)
        nx, ny, nval, aff = (fl_after.x, fl_after.y, fl_after.val,
                             fl_after.aff)

    exhausted = jnp.asarray(False)
    if replace_lost:
        def refill(op):
            xx, yy, vv, av, _ = op
            eig = _selection_eig_from_pyr(img_new, pyr_new, cfg)
            rx, ry, rv, _, ex = select_features_from_eig_device(
                eig, xx, yy, vv, cfg, replacing=True, top_k=top_k)
            if av is not None:
                # refilled slots are fresh features: recapture templates
                # (reference frees aff_img when a feature is replaced)
                av = reset_affine(av, vv < 0)
            return rx, ry, rv, av, ex

        nx, ny, nval, aff, exhausted = lax.cond(
            jnp.any(nval < 0), refill, lambda op: op,
            (nx, ny, nval, aff, exhausted))
    return pyr_new, nx, ny, nval, aff, exhausted


@functools.partial(jax.jit, static_argnames=("cfg", "replace_lost",
                                             "top_k"))
def sequence_step_device(pyr_prev: TrackPyramids, img_new: jax.Array,
                         x: jax.Array, y: jax.Array, val: jax.Array,
                         cfg, replace_lost: bool = True,
                         top_k: int = DEFAULT_TOP_K, aff=None):
    """One frame step: track into img_new, run the affine consistency
    stage when configured, then (conditionally) refill lost slots — all
    device-side. Returns (pyr_new, x, y, val, aff, exhausted)."""
    return _sequence_step_body(pyr_prev, img_new, x, y, val, cfg,
                               replace_lost, top_k, aff)


@functools.partial(jax.jit, static_argnames=("cfg", "replace_lost",
                                             "top_k"))
def sequence_chain_device(pyr_prev: TrackPyramids, imgs: tuple,
                          x: jax.Array, y: jax.Array, val: jax.Array,
                          cfg, replace_lost: bool = True,
                          top_k: int = DEFAULT_TOP_K, aff=None):
    """Micro-chained steps: advance len(imgs) frames in ONE program.

    Amortizes the per-dispatch cost over the chain. Same math as
    repeated sequence_step_device calls. Returns (pyr, hist, final, aff,
    exhausted): hist = per-frame (x, y, val) stacked [k, N]; final = the
    UNSTACKED last (x, y, val) — pass ``final`` into the next call
    rather than slicing hist[-1]; exhausted = any step's refill ran out
    of top-K candidates. Compile time grows with k, so pick k to match
    the serving pattern.
    """
    xs, ys, vs = [], [], []
    pyr = pyr_prev
    exhausted = jnp.asarray(False)
    for img in imgs:
        pyr, x, y, val, aff, ex = _sequence_step_body(
            pyr, img, x, y, val, cfg, replace_lost, top_k, aff)
        exhausted = exhausted | ex
        xs.append(x)
        ys.append(y)
        vs.append(val)
    hist = (jnp.stack(xs), jnp.stack(ys), jnp.stack(vs))
    return pyr, hist, (x, y, val), aff, exhausted


def warn_selection_exhausted(where: str, top_k: int) -> None:
    """Shared warning for device-selection top-K exhaustion (the one
    case where the device path can fill fewer slots than the host's
    full candidate scan). Selection auto-escalates K through 2x/8x
    rungs before flagging (ops/select_device.py), so this fires only
    when even the capped rung ran dry on a saturated pool."""
    from ..errors import KLTWarning
    from ..ops.select_device import _ESCALATION_CAP_FACTOR
    KLTWarning(
        "(%s) a selection ran out of candidates with free slots left "
        "even after escalating to %dx top-%d — the host full-scan path "
        "may fill more; raise top_k for exact parity", where,
        _ESCALATION_CAP_FACTOR, top_k)


def stack_history_chunks(chunks) -> tuple:
    """Concatenate per-frame history chunks ([k, N] triplets from
    chained steps, [N] rows from single steps) into stacked
    [n_frames, N] numpy (x, y, val)."""
    cols = [[np.atleast_2d(np.asarray(c[j])) for c in chunks]
            for j in range(3)]
    return tuple(np.concatenate(col, axis=0) for col in cols)


def track_sequence_device(frames: Iterable, cfg: Optional[TrackerConfig]
                          = None, n_features: int = 150,
                          replace_lost: bool = True,
                          top_k: int = DEFAULT_TOP_K, chain: int = 1):
    """Track a whole sequence device-resident; one host pull at the end.

    Returns (x, y, val) stacked [n_frames, n_features] numpy arrays —
    the FeatureTable contents of models.sequence.track_sequence.
    ``chain`` > 1 advances that many frames per dispatched program
    (sequence_chain_device), amortizing the per-dispatch floor; the
    tail shorter than ``chain`` falls back to per-step calls.
    """
    cfg = (cfg if cfg is not None else create_config()).replace(
        sequentialMode=True).validated_window()
    frames = list(frames)

    def dev(j):
        # frames are staged as they are consumed (only `chain` at a
        # time): a long video held fully device-resident would exceed
        # device memory (3600 x 1080p f32 = ~30 GB).
        return jnp.asarray(np.asarray(frames[j], np.float32))

    pyr, x, y, val, aff, exhausted = select_step_device(
        dev(0), cfg, n_features, top_k)
    # history accumulates as whole device chunks ([k, N] per chain call,
    # [N] rows per single step) — concatenated once on host at the end
    chunks = [(x, y, val)]
    i = 1
    while i < len(frames):
        k = len(frames) - i
        if chain > 1 and k >= chain:
            pyr, hist, (x, y, val), aff, ex = sequence_chain_device(
                pyr, tuple(dev(i + j) for j in range(chain)), x, y,
                val, cfg, replace_lost, top_k, aff)
            chunks.append(hist)
            i += chain
        else:
            pyr, x, y, val, aff, ex = sequence_step_device(
                pyr, dev(i), x, y, val, cfg, replace_lost, top_k, aff)
            chunks.append((x, y, val))
            i += 1
        exhausted = exhausted | ex
    jax.block_until_ready(val)
    if bool(exhausted):
        warn_selection_exhausted("track_sequence_device", top_k)
    return stack_history_chunks(chunks)
