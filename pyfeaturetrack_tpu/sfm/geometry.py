"""SO(3)/SE(3) primitives and the pinhole camera model.

All functions are batched (leading dims broadcast) and jit/vmap-friendly;
float32 with HIGHEST-precision matmuls in the solve paths.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_EPS = 1e-8


def _mm(a: jax.Array, b: jax.Array) -> jax.Array:
    """Full-fp32 matmul (the default precision may round operands to
    TF32 or bf16 — fatal for rotation algebra)."""
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)


def skew(v: jax.Array) -> jax.Array:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack([
        jnp.stack([zero, -z, y], -1),
        jnp.stack([z, zero, -x], -1),
        jnp.stack([-y, x, zero], -1),
    ], -2)


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues: [..., 3] rotation vector -> [..., 3, 3] rotation matrix."""
    theta = jnp.linalg.norm(w, axis=-1, keepdims=True)
    theta = jnp.maximum(theta, _EPS)
    axis = w / theta
    K = skew(axis)
    th = theta[..., None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), K.shape)
    R = eye + jnp.sin(th) * K + (1.0 - jnp.cos(th)) * _mm(K, K)
    small = (theta[..., None] < 10 * _EPS)
    return jnp.where(small, eye + skew(w), R)


def so3_log(R: jax.Array) -> jax.Array:
    """[..., 3, 3] rotation matrix -> [..., 3] rotation vector."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    w_hat = jnp.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)
    s = jnp.maximum(2.0 * jnp.sin(theta), _EPS)[..., None]
    # small-angle: w ~ w_hat / 2
    return jnp.where((theta[..., None] < 1e-4),
                     w_hat / 2.0, w_hat * (theta[..., None] / s))


def se3_apply(R: jax.Array, t: jax.Array, X: jax.Array) -> jax.Array:
    """Y = R X + t. R: [..., 3, 3], t: [..., 3], X: [..., 3]."""
    return jnp.einsum("...ij,...j->...i", R, X,
                      precision=lax.Precision.HIGHEST) + t


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) o (Rb, tb): apply b then a."""
    return _mm(Ra, Rb), se3_apply(Ra, ta, tb)


def se3_inverse(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, t,
                           precision=lax.Precision.HIGHEST)


def se3_exp(xi: jax.Array):
    """[..., 6] (rotation, translation) tangent vector -> (R, t).
    First-order coupling (V ~ I) is sufficient for GN increments."""
    return so3_exp(xi[..., :3]), xi[..., 3:]


def project(K: jax.Array, R: jax.Array, t: jax.Array, X: jax.Array
            ) -> tuple[jax.Array, jax.Array]:
    """Pinhole projection. Returns (uv [..., 2], depth [...])."""
    Y = se3_apply(R, t, X)
    z = jnp.maximum(Y[..., 2], _EPS)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    u = fx * Y[..., 0] / z + cx
    v = fy * Y[..., 1] / z + cy
    return jnp.stack([u, v], -1), Y[..., 2]
