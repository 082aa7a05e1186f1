"""Shi-Tomasi (min-eigenvalue) feature selection.

Reference parity: selectGoodFeatures.py -> KLTSelectGoodFeatures /
KLTReplaceLostFeatures / _KLTSelectGoodFeatures / _sortPointList /
_enforceMinimumDistance / _fillFeaturemap (see SURVEY.md section 3.1).

Split of the work:

* The O(H*W*w*h) windowed structure tensor + min-eigenvalue map — the hot
  part — runs on device as three separable box-filter convolutions over
  (gx*gx, gx*gy, gy*gy) followed by a fused eigenvalue formula. This is
  exactly the math of the reference's per-pixel loop, evaluated for every
  pixel at once.
* The greedy min-distance suppression is inherently sequential (each
  acceptance masks later candidates); it runs host-side over the sorted
  candidate list with early exit once all slots fill. The reference's qsort
  tie order is unspecified; we pin ties to scan order (y-major) which makes
  selection deterministic.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..errors import KLTWarning, verbose_print
from ..features import KLT_NOT_FOUND, FeatureState
from .convolve import compute_gradients, compute_smoothed_image, to_float_image
from ..utils.staging import stage_f32

# Selection keeps EXACT fp32 window sums regardless of PFT_CONV_PRECISION:
# the (gxx - gyy) cancellation in the min-eigenvalue formula amplifies
# bf16 rounding and can reorder near-tie candidates, cascading through the
# greedy mindist suppression.
_PRECISION = lax.Precision.HIGHEST
# Largest float32 strictly below 2^31: clipping to float(2^31-1) would
# round UP to 2^31 and the float->int32 cast would overflow (undefined in
# XLA, typically INT32_MIN) instead of saturating like the reference's
# int clamp. 2147483520 = 2^31 - 128 is exactly representable.
_EIG_LIMIT = 2147483520.0


def _window_sum(img: jax.Array, window_height: int, window_width: int) -> jax.Array:
    """'Valid' box-filter sum, zero-padded back to input shape (the oracle
    writes results only for fully-interior windows and leaves borders 0).

    A single conv op per pass keeps the accumulation order stable under
    XLA fusion: host selection and device selection trace this function
    inside different programs, and a multi-op form could get different
    FMA contractions in each (measured: ±1 int at ~0.01% of pixels),
    silently flipping candidate ranks between the two lanes."""
    h, w = img.shape
    x = img.reshape((1, 1, h, w))
    ones_v = jnp.ones((1, 1, window_height, 1), img.dtype)
    ones_h = jnp.ones((1, 1, 1, window_width), img.dtype)
    s = lax.conv_general_dilated(x, ones_v, (1, 1), ((0, 0), (0, 0)),
                                 dimension_numbers=("NCHW", "OIHW", "NCHW"),
                                 precision=_PRECISION)
    s = lax.conv_general_dilated(s, ones_h, (1, 1), ((0, 0), (0, 0)),
                                 dimension_numbers=("NCHW", "OIHW", "NCHW"),
                                 precision=_PRECISION)
    hh, hw = window_height // 2, window_width // 2
    return jnp.pad(s[0, 0], ((hh, hh), (hw, hw)))


def compute_min_eig_map(gradx: jax.Array, grady: jax.Array,
                        window_width: int, window_height: int) -> jax.Array:
    """Per-pixel min eigenvalue of the windowed structure tensor.

    Reference parity: selectGoodFeatures.py -> _KLTSelectGoodFeatures hot
    loop (_minEigenvalue in the C lineage).
    """
    gxx = _window_sum(gradx * gradx, window_height, window_width)
    gxy = _window_sum(gradx * grady, window_height, window_width)
    gyy = _window_sum(grady * grady, window_height, window_width)
    disc = jnp.sqrt((gxx - gyy) * (gxx - gyy) + 4.0 * gxy * gxy)
    return ((gxx + gyy) - disc) * 0.5


def quantized_min_eig_map(gradx: jax.Array, grady: jax.Array,
                          window_width: int, window_height: int) -> jax.Array:
    """Min-eig map cast to the reference's int32 candidate values.

    The int cast truncates toward zero like the reference's (int) cast;
    clamp to the int limit (the reference warns on overflow). Traceable —
    shared by the host selection path and the on-device selection in
    select_device.py.
    """
    # upcast: gradients may be stored bfloat16 (cfg.image_dtype); the
    # structure-tensor sums always accumulate in float32
    eig = compute_min_eig_map(jnp.asarray(gradx, jnp.float32),
                              jnp.asarray(grady, jnp.float32),
                              window_width, window_height)
    return jnp.clip(eig, max=_EIG_LIMIT).astype(jnp.int32)


def selection_eig_map_core(img: jax.Array, *, window_width: int,
                           window_height: int, smooth_before: bool,
                           smooth_sigma: float, grad_sigma: float
                           ) -> jax.Array:
    """float image -> (optional smooth) -> gradients -> min-eig map."""
    fimg = to_float_image(img)
    if smooth_before:
        fimg = compute_smoothed_image(fimg, smooth_sigma)
    gradx, grady = compute_gradients(fimg, grad_sigma)
    return quantized_min_eig_map(gradx, grady, window_width, window_height)


_selection_eig_map = functools.partial(jax.jit, static_argnames=(
    "window_width", "window_height", "smooth_before", "smooth_sigma",
    "grad_sigma"))(selection_eig_map_core)


def _write_internal_images(img, cfg) -> None:
    """Debug-dump the smoothed image and gradients to PGM files.

    Reference parity: tc.writeInternalImages (klt_util.py ->
    _KLTWriteFloatImageToPGM): writes kltimg_sgfrlf.pgm and
    kltimg_sgfrlf_gx/_gy.pgm in the working directory.
    """
    from ..utils.io import float_image_to_pgm
    fimg = stage_f32(img)
    if cfg.smoothBeforeSelecting:
        fimg = compute_smoothed_image(fimg, cfg.smooth_sigma)
    gradx, grady = compute_gradients(fimg, cfg.grad_sigma)
    float_image_to_pgm("kltimg_sgfrlf.pgm", np.asarray(fimg), scale=False)
    float_image_to_pgm("kltimg_sgfrlf_gx.pgm", np.asarray(gradx))
    float_image_to_pgm("kltimg_sgfrlf_gy.pgm", np.asarray(grady))


def _enforce_minimum_distance(xs: np.ndarray, ys: np.ndarray,
                              vals: np.ndarray, order: np.ndarray,
                              feats: np.ndarray, shape: tuple[int, int],
                              mindist: int, min_eigenvalue: int,
                              overwrite_all: bool) -> np.ndarray:
    """Greedy best-first acceptance with a mindist-radius occupancy map.

    Reference parity: selectGoodFeatures.py -> _enforceMinimumDistance.
    ``feats`` is (N, 3) float64 of (x, y, val); modified copy returned.
    """
    nrows, ncols = shape
    n_features = feats.shape[0]
    mindist = mindist - 1  # reference decrements before use
    featuremap = np.zeros(shape, dtype=bool)

    def fill_map(x: int, y: int) -> None:
        y0, y1 = max(y - mindist, 0), min(y + mindist, nrows - 1)
        x0, x1 = max(x - mindist, 0), min(x + mindist, ncols - 1)
        featuremap[y0:y1 + 1, x0:x1 + 1] = True

    out = feats.copy()
    if not overwrite_all:
        for fx, fy, fv in out:
            if fv >= 0:
                fill_map(int(fx), int(fy))

    indx = 0
    ci = 0
    ncand = order.shape[0]
    while True:
        if ci >= ncand:
            while indx < n_features:
                if overwrite_all or out[indx, 2] < 0:
                    out[indx] = (-1.0, -1.0, KLT_NOT_FOUND)
                indx += 1
            break
        i = order[ci]
        x, y, val = int(xs[i]), int(ys[i]), int(vals[i])
        ci += 1
        while (not overwrite_all) and indx < n_features and out[indx, 2] >= 0:
            indx += 1
        if indx >= n_features:
            break
        if not featuremap[y, x] and val >= min_eigenvalue:
            out[indx] = (float(x), float(y), float(val))
            indx += 1
            fill_map(x, y)
    return out


def select_good_features_arrays(img, n_features: int, cfg,
                                existing: np.ndarray | None = None
                                ) -> np.ndarray:
    """Array-level selection: returns (N, 3) float64 of (x, y, val).

    Reference parity: selectGoodFeatures.py -> _KLTSelectGoodFeatures
    (mode SELECTING_ALL when ``existing`` is None, else REPLACING_SOME).
    """
    img = np.asarray(img)
    nrows, ncols = img.shape

    mode = "Replacing" if existing is not None else "Selecting"
    verbose_print(f"(KLT) {mode} the {n_features} best features "
                  f"from a {ncols} by {nrows} image...  ")

    if cfg.writeInternalImages:
        _write_internal_images(img, cfg)

    eig = np.asarray(_selection_eig_map(
        stage_f32(img),
        window_width=int(cfg.window_width),
        window_height=int(cfg.window_height),
        smooth_before=bool(cfg.smoothBeforeSelecting),
        smooth_sigma=float(cfg.smooth_sigma),
        grad_sigma=float(cfg.grad_sigma)))

    window_hw = max(cfg.window_width // 2, 1)
    window_hh = max(cfg.window_height // 2, 1)
    borderx = max(cfg.borderx, window_hw)
    bordery = max(cfg.bordery, window_hh)
    step = cfg.nSkippedPixels + 1

    ys_r = np.arange(bordery, nrows - bordery, step)
    xs_r = np.arange(borderx, ncols - borderx, step)
    if ys_r.size == 0 or xs_r.size == 0:
        KLTWarning("(select_good_features) no room for features "
                   "(border too large for image)")
        vals = np.zeros((0,), np.int64)
        xs = ys = np.zeros((0,), np.int64)
    else:
        grid_y, grid_x = np.meshgrid(ys_r, xs_r, indexing="ij")
        vals = eig[grid_y, grid_x].astype(np.int64).ravel()
        xs = grid_x.ravel().astype(np.int64)
        ys = grid_y.ravel().astype(np.int64)

    if existing is None and vals.size < n_features:
        KLTWarning("(select_good_features) fewer candidate pixels (%d) than "
                   "requested features (%d)", vals.size, n_features)

    # descending by value, ties in scan order (stable mergesort on -vals)
    order = np.argsort(-vals, kind="stable")

    overwrite_all = existing is None
    if existing is None:
        feats = np.full((n_features, 3), -1.0, dtype=np.float64)
        feats[:, 2] = KLT_NOT_FOUND
    else:
        feats = np.asarray(existing, dtype=np.float64)

    from ..utils import native
    if native.available():
        out = native.enforce_min_distance(
            xs, ys, vals, order, feats, (nrows, ncols),
            int(cfg.mindist), max(int(cfg.min_eigenvalue), 1), overwrite_all)
    else:
        out = _enforce_minimum_distance(
            xs, ys, vals, order, feats, (nrows, ncols),
            int(cfg.mindist), max(int(cfg.min_eigenvalue), 1), overwrite_all)
    verbose_print(f"\t{int((out[:, 2] >= 0).sum())} features found.")
    return out


def replace_lost_features_arrays(img, feats: np.ndarray, cfg) -> np.ndarray:
    """Reference parity: selectGoodFeatures.py -> KLTReplaceLostFeatures."""
    feats = np.asarray(feats, dtype=np.float64)
    if (feats[:, 2] < 0).any():
        return select_good_features_arrays(img, feats.shape[0], cfg,
                                           existing=feats)
    return feats.copy()


def select_good_features(img, n_features: int, cfg) -> FeatureState:
    """High-level selection returning a FeatureState.

    Reference parity: selectGoodFeatures.py -> KLTSelectGoodFeatures.
    """
    from ..features import feature_state_from_numpy
    return feature_state_from_numpy(
        select_good_features_arrays(img, n_features, cfg))


def replace_lost_features(img, fl: FeatureState, cfg) -> FeatureState:
    """Reference parity: selectGoodFeatures.py -> KLTReplaceLostFeatures."""
    from ..features import (feature_state_from_numpy, feature_state_to_numpy,
                            reset_affine)
    old = feature_state_to_numpy(fl)
    arr = replace_lost_features_arrays(img, old, cfg)
    aff = fl.aff
    if aff is not None:
        # Refilled (previously lost) slots are fresh features: their
        # first-frame templates must be recaptured (the reference frees
        # aff_img when a feature is replaced).
        drop = jnp.asarray(old[:, 2] < 0)
        aff = reset_affine(aff, drop)
    return feature_state_from_numpy(arr, aff=aff)
