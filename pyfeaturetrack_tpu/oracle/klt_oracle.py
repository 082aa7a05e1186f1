"""Float64 NumPy oracle for the KLT algorithm suite — TEST-ONLY golden source.

The reference repo (TimSC/PyFeatureTrack) was unavailable at build time
(empty mount, see SURVEY.md section 0), so this oracle *is* the behavioral
specification: a direct, loop-level transcription of SURVEY.md sections 2-3
(which reconstruct the reference's algorithms: selectGoodFeatures.py,
trackFeatures.py, convolve.py, pyramid.py). It is deliberately slow and
scalar — clarity over speed — and is compared against the JAX path in tests.

Status codes (reference parity: klt.py constants):
  KLT_TRACKED 0, KLT_NOT_FOUND -1, KLT_SMALL_DET -2, KLT_MAX_ITERATIONS -3,
  KLT_OOB -4, KLT_LARGE_RESIDUE -5.
"""

from __future__ import annotations

import math

import numpy as np

KLT_TRACKED = 0
KLT_NOT_FOUND = -1
KLT_SMALL_DET = -2
KLT_MAX_ITERATIONS = -3
KLT_OOB = -4
KLT_LARGE_RESIDUE = -5

MAX_KERNEL_WIDTH = 71


# --------------------------------------------------------------------------
# Kernels + convolution (reference parity: convolve.py)
# --------------------------------------------------------------------------

def compute_kernels(sigma: float) -> tuple[np.ndarray, np.ndarray]:
    hw = MAX_KERNEL_WIDTH // 2
    i = np.arange(-hw, hw + 1, dtype=np.float64)
    gauss = np.exp(-(i * i) / (2.0 * sigma * sigma))
    deriv = -i * gauss
    factor = 0.01
    max_gauss, max_deriv = 1.0, sigma * math.exp(-0.5)

    gw = MAX_KERNEL_WIDTH
    k = 0
    while abs(gauss[k] / max_gauss) < factor:
        gw -= 2
        k += 1
    dw = MAX_KERNEL_WIDTH
    k = 0
    while abs(deriv[k] / max_deriv) < factor:
        dw -= 2
        k += 1
    assert gw < MAX_KERNEL_WIDTH and dw < MAX_KERNEL_WIDTH, "sigma too large"

    gauss = gauss[(MAX_KERNEL_WIDTH - gw) // 2:(MAX_KERNEL_WIDTH - gw) // 2 + gw].copy()
    deriv = deriv[(MAX_KERNEL_WIDTH - dw) // 2:(MAX_KERNEL_WIDTH - dw) // 2 + dw].copy()
    gauss /= gauss.sum()
    dhw = dw // 2
    idx = np.arange(-dhw, dhw + 1, dtype=np.float64)
    deriv /= -(idx * deriv).sum()
    return gauss, deriv


def get_kernel_widths(sigma: float) -> tuple[int, int]:
    g, d = compute_kernels(sigma)
    return g.shape[0], d.shape[0]


def convolve_horiz(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    radius = kernel.shape[0] // 2
    out = np.zeros_like(img)
    krev = kernel[::-1]
    if radius == 0:
        return img * krev[0]
    sw = np.lib.stride_tricks.sliding_window_view(img, kernel.shape[0], axis=1)
    out[:, radius:-radius] = sw @ krev
    return out


def convolve_vert(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    return convolve_horiz(img.T, kernel).T


def convolve_separate(img, hk, vk):
    return convolve_vert(convolve_horiz(img, hk), vk)


def compute_smoothed_image(img: np.ndarray, sigma: float) -> np.ndarray:
    gauss, _ = compute_kernels(sigma)
    return convolve_separate(img, gauss, gauss)


def compute_gradients(img: np.ndarray, sigma: float):
    gauss, deriv = compute_kernels(sigma)
    return convolve_separate(img, deriv, gauss), convolve_separate(img, gauss, deriv)


# --------------------------------------------------------------------------
# Pyramid (reference parity: pyramid.py -> _KLTComputePyramid)
# --------------------------------------------------------------------------

def compute_pyramid(img: np.ndarray, subsampling: int, nlevels: int,
                    sigma_fact: float) -> list[np.ndarray]:
    subhalf = subsampling // 2
    sigma = subsampling * sigma_fact
    levels = [img.astype(np.float64)]
    for _ in range(1, nlevels):
        prev = levels[-1]
        sm = compute_smoothed_image(prev, sigma)
        h, w = prev.shape[0] // subsampling, prev.shape[1] // subsampling
        lvl = sm[subhalf::subsampling, subhalf::subsampling][:h, :w].copy()
        levels.append(lvl)
    return levels


# --------------------------------------------------------------------------
# Feature selection (reference parity: selectGoodFeatures.py)
# --------------------------------------------------------------------------

def min_eig_map(gradx: np.ndarray, grady: np.ndarray, window_width: int,
                window_height: int) -> np.ndarray:
    """Per-pixel windowed structure tensor -> min eigenvalue (float64)."""
    nrows, ncols = gradx.shape
    hw, hh = window_width // 2, window_height // 2

    def wsum(a):
        sw = np.lib.stride_tricks.sliding_window_view(
            a, (window_height, window_width))
        return sw.sum(axis=(-2, -1))

    gxx = wsum(gradx * gradx)
    gxy = wsum(gradx * grady)
    gyy = wsum(grady * grady)
    val = ((gxx + gyy) - np.sqrt((gxx - gyy) ** 2 + 4.0 * gxy * gxy)) / 2.0
    out = np.zeros((nrows, ncols), dtype=np.float64)
    out[hh:nrows - hh, hw:ncols - hw] = val
    return out


def select_good_features(img: np.ndarray, n_features: int, cfg,
                         existing: np.ndarray | None = None):
    """Shi-Tomasi selection with greedy min-distance suppression.

    Reference parity: selectGoodFeatures.py -> _KLTSelectGoodFeatures.
    ``cfg`` is a TrackerConfig-like object. ``existing`` is an (N,3) float
    array of (x, y, val) — when given, runs in REPLACING_SOME mode (only
    slots with val < 0 are refilled and survivors pre-mark the featuremap).
    Returns (N,3) float64 array of (x, y, val).
    """
    nrows, ncols = img.shape
    fimg = img.astype(np.float64)
    if cfg.smoothBeforeSelecting:
        fimg = compute_smoothed_image(
            fimg, cfg.smooth_sigma_fact * max(cfg.window_width, cfg.window_height))
    gradx, grady = compute_gradients(fimg, cfg.grad_sigma)

    window_hw = max(cfg.window_width // 2, 1)
    window_hh = max(cfg.window_height // 2, 1)
    borderx = max(cfg.borderx, window_hw)
    bordery = max(cfg.bordery, window_hh)

    # candidate scan: y outer, x inner, stride nSkippedPixels+1
    eig = min_eig_map(gradx, grady, cfg.window_width, cfg.window_height)
    limit = 2 ** 31 - 1
    cands = []
    step = cfg.nSkippedPixels + 1
    for y in range(bordery, nrows - bordery, step):
        for x in range(borderx, ncols - borderx, step):
            val = eig[y, x]
            if val > limit:
                val = float(limit)
            cands.append((x, y, int(val)))

    # sort by val desc; stable tie-break on scan order (deterministic — the
    # reference's qsort tie order is unspecified, we pin scan order)
    order = sorted(range(len(cands)), key=lambda i: (-cands[i][2], i))

    min_eigenvalue = max(int(cfg.min_eigenvalue), 1)
    mindist = cfg.mindist - 1  # reference decrements before use

    overwrite_all = existing is None
    if existing is None:
        feats = np.full((n_features, 3), -1.0, dtype=np.float64)
        feats[:, 2] = KLT_NOT_FOUND
    else:
        feats = existing.astype(np.float64).copy()

    featuremap = np.zeros((nrows, ncols), dtype=bool)

    def fill_map(x, y):
        y0, y1 = max(y - mindist, 0), min(y + mindist, nrows - 1)
        x0, x1 = max(x - mindist, 0), min(x + mindist, ncols - 1)
        featuremap[y0:y1 + 1, x0:x1 + 1] = True

    if not overwrite_all:
        for fx, fy, fv in feats:
            if fv >= 0:
                fill_map(int(fx), int(fy))

    indx = 0
    ci = 0
    while True:
        if ci >= len(order):
            while indx < n_features:
                if overwrite_all or feats[indx, 2] < 0:
                    feats[indx] = (-1.0, -1.0, KLT_NOT_FOUND)
                indx += 1
            break
        x, y, val = cands[order[ci]]
        ci += 1
        while (not overwrite_all) and indx < n_features and feats[indx, 2] >= 0:
            indx += 1
        if indx >= n_features:
            break
        if not featuremap[y, x] and val >= min_eigenvalue:
            feats[indx] = (float(x), float(y), float(val))
            indx += 1
            fill_map(x, y)
    return feats


def replace_lost_features(img, feats, cfg):
    """Reference parity: selectGoodFeatures.py -> KLTReplaceLostFeatures."""
    if (feats[:, 2] < 0).any():
        return select_good_features(img, feats.shape[0], cfg, existing=feats)
    return feats.copy()


# --------------------------------------------------------------------------
# Tracking (reference parity: trackFeatures.py)
# --------------------------------------------------------------------------

def interpolate(x: float, y: float, img: np.ndarray) -> float:
    """4-tap bilinear. Reference parity: trackFeatures.py -> _interpolate."""
    xt, yt = int(x), int(y)
    ax, ay = x - xt, y - yt
    return ((1 - ax) * (1 - ay) * img[yt, xt] +
            ax * (1 - ay) * img[yt, xt + 1] +
            (1 - ax) * ay * img[yt + 1, xt] +
            ax * ay * img[yt + 1, xt + 1])


def _window_iter(hw, hh):
    for j in range(-hh, hh + 1):
        for i in range(-hw, hw + 1):
            yield i, j


def interpolate_window(img, x, y, w, h):
    """Vectorized bilinear samples on the (w x h) window grid around (x, y),
    flattened j-outer/i-inner like the reference's window iteration."""
    hw, hh = w // 2, h // 2
    xs = x + np.arange(-hw, hw + 1, dtype=np.float64)[None, :]
    ys = y + np.arange(-hh, hh + 1, dtype=np.float64)[:, None]
    xs, ys = np.broadcast_arrays(xs + 0.0 * ys, ys + 0.0 * xs)
    xt = xs.astype(np.int64)  # int() truncation, as in scalar interpolate
    yt = ys.astype(np.int64)
    ax, ay = xs - xt, ys - yt
    vals = ((1 - ax) * (1 - ay) * img[yt, xt] +
            ax * (1 - ay) * img[yt, xt + 1] +
            (1 - ax) * ay * img[yt + 1, xt] +
            ax * ay * img[yt + 1, xt + 1])
    return vals.ravel()


def compute_intensity_difference(img1, img2, x1, y1, x2, y2, w, h):
    return (interpolate_window(img1, x1, y1, w, h) -
            interpolate_window(img2, x2, y2, w, h))


def compute_gradient_sum(gx1, gy1, gx2, gy2, x1, y1, x2, y2, w, h):
    gx = (interpolate_window(gx1, x1, y1, w, h) +
          interpolate_window(gx2, x2, y2, w, h))
    gy = (interpolate_window(gy1, x1, y1, w, h) +
          interpolate_window(gy2, x2, y2, w, h))
    return gx, gy


def compute_intensity_difference_li(img1, img2, x1, y1, x2, y2, w, h):
    """Lighting-insensitive residual: gain (alpha) from RMS ratio, bias (beta)
    from means. Reference parity: trackFeatures.py ->
    _computeIntensityDifferenceLightingInsensitive."""
    g1 = interpolate_window(img1, x1, y1, w, h)
    g2 = interpolate_window(img2, x2, y2, w, h)
    n = w * h
    alpha = math.sqrt((g1 * g1).sum() / n / ((g2 * g2).sum() / n))
    beta = g1.sum() / n - alpha * (g2.sum() / n)
    return g1 - g2 * alpha - beta


def compute_gradient_sum_li(gx1, gy1, gx2, gy2, img1, img2,
                            x1, y1, x2, y2, w, h):
    """Reference parity: trackFeatures.py -> _computeGradientSumLightingInsensitive."""
    i1 = interpolate_window(img1, x1, y1, w, h)
    i2 = interpolate_window(img2, x2, y2, w, h)
    n = w * h
    alpha = math.sqrt((i1 * i1).sum() / n / ((i2 * i2).sum() / n))
    gx = (interpolate_window(gx1, x1, y1, w, h) +
          alpha * interpolate_window(gx2, x2, y2, w, h))
    gy = (interpolate_window(gy1, x1, y1, w, h) +
          alpha * interpolate_window(gy2, x2, y2, w, h))
    return gx, gy


def track_feature(x1, y1, x2, y2, img1, gx1, gy1, img2, gx2, gy2, cfg):
    """Single-level iterative translational LK.

    Reference parity: trackFeatures.py -> _trackFeature. Returns
    (x2, y2, status, iterations).
    """
    w, h = cfg.window_width, cfg.window_height
    hw, hh = w // 2, h // 2
    nr, nc = img1.shape
    one_plus_eps = 1.001
    th = cfg.min_displacement
    iteration = 0
    status = KLT_TRACKED
    dx = dy = 0.0

    while True:
        if (x1 - hw < 0.0 or nc - (x1 + hw) < one_plus_eps or
                x2 - hw < 0.0 or nc - (x2 + hw) < one_plus_eps or
                y1 - hh < 0.0 or nr - (y1 + hh) < one_plus_eps or
                y2 - hh < 0.0 or nr - (y2 + hh) < one_plus_eps):
            status = KLT_OOB
            break

        if cfg.lighting_insensitive:
            imgdiff = compute_intensity_difference_li(img1, img2, x1, y1, x2, y2, w, h)
            gx, gy = compute_gradient_sum_li(gx1, gy1, gx2, gy2, img1, img2,
                                             x1, y1, x2, y2, w, h)
        else:
            imgdiff = compute_intensity_difference(img1, img2, x1, y1, x2, y2, w, h)
            gx, gy = compute_gradient_sum(gx1, gy1, gx2, gy2, x1, y1, x2, y2, w, h)

        gxx = float((gx * gx).sum())
        gxy = float((gx * gy).sum())
        gyy = float((gy * gy).sum())
        ex = cfg.step_factor * float((imgdiff * gx).sum())
        ey = cfg.step_factor * float((imgdiff * gy).sum())

        det = gxx * gyy - gxy * gxy
        if det < cfg.min_determinant:
            status = KLT_SMALL_DET
            break
        dx = (gyy * ex - gxy * ey) / det
        dy = (gxx * ey - gxy * ex) / det
        x2 += dx
        y2 += dy
        iteration += 1

        if not ((abs(dx) >= th or abs(dy) >= th) and iteration < cfg.max_iterations):
            break

    # final bounds check
    if (x2 - hw < 0.0 or nc - (x2 + hw) < one_plus_eps or
            y2 - hh < 0.0 or nr - (y2 + hh) < one_plus_eps):
        status = KLT_OOB

    # residue check
    if status == KLT_TRACKED:
        if cfg.lighting_insensitive:
            imgdiff = compute_intensity_difference_li(img1, img2, x1, y1, x2, y2, w, h)
        else:
            imgdiff = compute_intensity_difference(img1, img2, x1, y1, x2, y2, w, h)
        if np.abs(imgdiff).sum() / (w * h) > cfg.max_residue:
            status = KLT_LARGE_RESIDUE

    if status == KLT_SMALL_DET:
        return x2, y2, KLT_SMALL_DET, iteration
    if status == KLT_OOB:
        return x2, y2, KLT_OOB, iteration
    if status == KLT_LARGE_RESIDUE:
        return x2, y2, KLT_LARGE_RESIDUE, iteration
    if iteration >= cfg.max_iterations:
        return x2, y2, KLT_MAX_ITERATIONS, iteration
    return x2, y2, KLT_TRACKED, iteration


def _out_of_bounds(x, y, ncols, nrows, borderx, bordery):
    return (x < borderx or x > ncols - 1 - borderx or
            y < bordery or y > nrows - 1 - bordery)


def build_track_pyramids(img: np.ndarray, cfg):
    """float -> smooth -> pyramid -> per-level gradients, as in
    KLTTrackFeatures' pyramid-build phase."""
    fimg = compute_smoothed_image(
        img.astype(np.float64),
        cfg.smooth_sigma_fact * max(cfg.window_width, cfg.window_height))
    pyr = compute_pyramid(fimg, cfg.subsampling, cfg.nPyramidLevels,
                          cfg.pyramid_sigma_fact)
    gxs, gys = [], []
    for lvl in pyr:
        gx, gy = compute_gradients(lvl, cfg.grad_sigma)
        gxs.append(gx)
        gys.append(gy)
    return pyr, gxs, gys


def track_features(img1, img2, feats, cfg, pyr1=None):
    """Pyramidal LK over a feature array (N,3) of (x, y, val).

    Reference parity: trackFeatures.py -> KLTTrackFeatures (translational
    path; the affine consistency check is oracle/affine_oracle.py).
    Returns (new_feats, pyramids_of_img2) — the latter is the
    sequential-mode cache.
    """
    nrows, ncols = img1.shape
    if pyr1 is None:
        pyr1 = build_track_pyramids(img1, cfg)
    pyr2 = build_track_pyramids(img2, cfg)
    p1, gx1, gy1 = pyr1
    p2, gx2, gy2 = pyr2

    out = feats.astype(np.float64).copy()
    s = cfg.subsampling
    for idx in range(feats.shape[0]):
        if feats[idx, 2] < 0:
            continue
        xloc, yloc = float(feats[idx, 0]), float(feats[idx, 1])
        for _ in range(cfg.nPyramidLevels):
            xloc /= s
            yloc /= s
        xout, yout = xloc, yloc
        val = KLT_TRACKED
        for r in range(cfg.nPyramidLevels - 1, -1, -1):
            xloc *= s
            yloc *= s
            xout *= s
            yout *= s
            xout, yout, val, _ = track_feature(
                xloc, yloc, xout, yout,
                p1[r], gx1[r], gy1[r], p2[r], gx2[r], gy2[r], cfg)
            if val in (KLT_SMALL_DET, KLT_OOB):
                break
        if val == KLT_OOB:
            out[idx] = (-1.0, -1.0, KLT_OOB)
        elif _out_of_bounds(xout, yout, ncols, nrows, cfg.borderx, cfg.bordery):
            out[idx] = (-1.0, -1.0, KLT_OOB)
        elif val == KLT_SMALL_DET:
            out[idx] = (-1.0, -1.0, KLT_SMALL_DET)
        elif val == KLT_LARGE_RESIDUE:
            out[idx] = (-1.0, -1.0, KLT_LARGE_RESIDUE)
        elif val == KLT_MAX_ITERATIONS:
            out[idx] = (-1.0, -1.0, KLT_MAX_ITERATIONS)
        else:
            out[idx] = (xout, yout, KLT_TRACKED)
    return out, pyr2
