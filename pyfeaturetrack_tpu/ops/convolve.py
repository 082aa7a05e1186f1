"""Separable convolution, smoothing, and gradients.

Reference parity: convolve.py -> _convolveImageHoriz / _convolveImageVert /
_convolveSeparate / _KLTComputeSmoothedImage / _KLTComputeGradients.

Semantics reproduced exactly:

* true convolution (kernel flipped relative to cross-correlation);
* output border of ``kernel_width // 2`` pixels is ZEROED on each side along
  the convolved axis (the reference writes 0.0 there instead of padding);
* separable order is horizontal first, then vertical;
* gradx = conv(img, deriv_x (x) gauss_y), grady = conv(img, gauss_x (x) deriv_y).

Notes: images are float32; convs go through ``lax.conv_general_dilated``
with ``precision=HIGHEST`` so XLA keeps full fp32 (no TF32) and fuses the
border masking. Shapes are static under jit (kernel widths are trace-time
constants from ops/kernels.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .kernels import compute_kernels


def _precision_from_env():
    """Conv precision mode, read ONCE at import (set the env var before
    importing, or call set_conv_precision). PFT_CONV_PRECISION=fast lets
    XLA choose its default conv precision for the image/pyramid pipeline
    (TF32 on GPUs that have it), a serving-mode knob whose error the
    parity tests do not cover. Anything else is
    exact fp32 (HIGHEST), which the oracle-parity guarantees assume.
    Selection (ops/select.py) always stays exact."""
    import os
    mode = os.environ.get("PFT_CONV_PRECISION", "exact").lower()
    if mode in ("fast", "bf16"):
        return lax.Precision.DEFAULT
    if mode not in ("exact", "highest", ""):
        from ..errors import KLTWarning
        KLTWarning(
            "PFT_CONV_PRECISION=%r not recognized (use 'fast' or 'exact'); "
            "using exact", mode)
    return lax.Precision.HIGHEST


_PRECISION = _precision_from_env()


def set_conv_precision(mode: str) -> None:
    """Switch the image-pipeline conv precision at runtime ('fast' or
    'exact'). Only affects compilations AFTER the call — already-jitted
    programs keep the precision they were traced with."""
    global _PRECISION
    if mode.lower() in ("fast", "bf16"):
        _PRECISION = lax.Precision.DEFAULT
    elif mode.lower() in ("exact", "highest"):
        _PRECISION = lax.Precision.HIGHEST
    else:
        raise ValueError(f"unknown conv precision mode: {mode!r}")


def _conv1d(img: jax.Array, kernel: np.ndarray, axis: int) -> jax.Array:
    """Convolve the last-two-dims image along ``axis`` (0=rows/vert, 1=cols/horiz)
    with zeroed borders, matching the reference's border semantics."""
    k = np.asarray(kernel, dtype=np.float32)
    radius = k.shape[0] // 2
    *batch, h, w = img.shape
    # degenerate case: kernel wider than the image along the conv axis
    # (deep KLTChangeTCPyramid configs on small frames, e.g. search
    # range 60+ at 240x320 -> subsampling 8 with sigma 7.2 smoothing a
    # 30x40 level). The reference zeroes a ``radius`` border; when
    # 2*radius >= extent the border covers everything — return zeros
    # instead of handing XLA a negative-size valid conv.
    if 2 * radius >= (w if axis == 1 else h):
        return jnp.zeros_like(img)
    x = img.reshape((-1, 1, h, w))

    if axis == 1:  # horizontal
        rhs = jnp.asarray(k[::-1].reshape(1, 1, 1, -1))
        window_strides = (1, 1)
        pad = ((0, 0), (0, 0))
    else:  # vertical
        rhs = jnp.asarray(k[::-1].reshape(1, 1, -1, 1))
        window_strides = (1, 1)
        pad = ((0, 0), (0, 0))

    valid = lax.conv_general_dilated(
        x, rhs, window_strides, pad,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=_PRECISION,
    )
    if axis == 1:
        out = jnp.pad(valid, ((0, 0), (0, 0), (0, 0), (radius, radius)))
    else:
        out = jnp.pad(valid, ((0, 0), (0, 0), (radius, radius), (0, 0)))
    return out.reshape(img.shape)


def convolve_horiz(img: jax.Array, kernel: np.ndarray) -> jax.Array:
    """Reference parity: convolve.py -> _convolveImageHoriz."""
    return _conv1d(img, kernel, axis=1)


def convolve_vert(img: jax.Array, kernel: np.ndarray) -> jax.Array:
    """Reference parity: convolve.py -> _convolveImageVert."""
    return _conv1d(img, kernel, axis=0)


def convolve_separate(img: jax.Array, horiz_kernel: np.ndarray,
                      vert_kernel: np.ndarray) -> jax.Array:
    """Horizontal pass then vertical pass.

    Reference parity: convolve.py -> _convolveSeparate.
    """
    return convolve_vert(convolve_horiz(img, horiz_kernel), vert_kernel)


def compute_smoothed_image(img: jax.Array, sigma: float) -> jax.Array:
    """Gaussian smoothing with the trimmed kernel for ``sigma``.

    Reference parity: convolve.py -> _KLTComputeSmoothedImage.
    """
    gauss, _ = compute_kernels(float(sigma))
    return convolve_separate(img, gauss, gauss)


def compute_gradients(img: jax.Array, sigma: float) -> tuple[jax.Array, jax.Array]:
    """Derivative-of-Gaussian gradient pair (gradx, grady).

    Reference parity: convolve.py -> _KLTComputeGradients. When the
    trimmed gauss/deriv kernels have equal width (true for the default
    sigmas), both gradients are produced by ONE 1->2-channel horizontal
    conv + ONE grouped 2->2 vertical conv — half the passes over the
    image, same math per element.
    """
    gauss, deriv = compute_kernels(float(sigma))
    if gauss.shape[0] != deriv.shape[0] or img.ndim != 2:
        gradx = convolve_separate(img, deriv, gauss)
        grady = convolve_separate(img, gauss, deriv)
        return gradx, grady
    return _gradients_fused(img, gauss, deriv)


def _gradients_fused(img: jax.Array, gauss: np.ndarray, deriv: np.ndarray
                     ) -> tuple[jax.Array, jax.Array]:
    """Fused gradient pair for equal-width kernels.

    channel 0: horiz deriv then vert gauss  -> gradx
    channel 1: horiz gauss then vert deriv  -> grady
    Borders of kernel_width//2 are zeroed on each convolved axis, exactly
    as in _conv1d.
    """
    radius = gauss.shape[0] // 2
    h, w = img.shape
    x = img.reshape(1, 1, h, w)

    # horizontal: 1 input channel -> 2 output channels
    kh = np.stack([deriv[::-1], gauss[::-1]]).reshape(2, 1, 1, -1)
    mid = lax.conv_general_dilated(
        x, jnp.asarray(kh), (1, 1), ((0, 0), (0, 0)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"), precision=_PRECISION)
    mid = jnp.pad(mid, ((0, 0), (0, 0), (0, 0), (radius, radius)))

    # vertical: grouped 2 -> 2 (each channel gets its own kernel)
    kv = np.stack([gauss[::-1], deriv[::-1]]).reshape(2, 1, -1, 1)
    out = lax.conv_general_dilated(
        mid, jnp.asarray(kv), (1, 1), ((0, 0), (0, 0)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=2, precision=_PRECISION)
    out = jnp.pad(out, ((0, 0), (0, 0), (radius, radius), (0, 0)))
    return out[0, 0], out[0, 1]


def to_float_image(img) -> jax.Array:
    """uint8/any image -> float32 image (values preserved, 0..255 scale).

    Reference parity: klt_util.py -> _KLTToFloatImage.
    """
    return jnp.asarray(img, dtype=jnp.float32)
