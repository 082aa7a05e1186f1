"""Batched linear (DLT) triangulation."""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def triangulate_dlt(K: jax.Array, Rs: jax.Array, ts: jax.Array,
                    uvs: jax.Array, mask: jax.Array) -> jax.Array:
    """Triangulate L landmarks from up to C views each.

    K: [3, 3]; Rs/ts: [C, 3, 3]/[C, 3] world->camera; uvs: [L, C, 2]
    pixel observations; mask: [L, C] validity. Returns X: [L, 3].

    Standard DLT: for each observation, two rows of A X_h = 0 with
    A rows = u * P_2 - P_0 and v * P_2 - P_1 (P = K [R | t]); solved per
    landmark via the normal equations (masked rows are zero).
    """
    P = jnp.einsum("ij,cjk->cik", K, jnp.concatenate(
        [Rs, ts[..., None]], axis=-1),
        precision=lax.Precision.HIGHEST)  # [C, 3, 4]

    u = uvs[..., 0]  # [L, C]
    v = uvs[..., 1]
    m = mask.astype(uvs.dtype)[..., None]  # [L, C, 1]
    row_u = (u[..., None] * P[None, :, 2, :] - P[None, :, 0, :]) * m
    row_v = (v[..., None] * P[None, :, 2, :] - P[None, :, 1, :]) * m
    A = jnp.concatenate([row_u, row_v], axis=1)  # [L, 2C, 4]

    # min ||A x||, x = (X, 1): solve A33 X = -a4 where A = [A33 | a4]
    AtA = jnp.einsum("lri,lrj->lij", A, A,
                     precision=lax.Precision.HIGHEST)  # [L, 4, 4]
    M = AtA[:, :3, :3]
    b = -AtA[:, :3, 3]
    # Regularize singular systems (too few views) minimally; closed-form
    # batched 3x3 inverse (no pivoted LU).
    from ..ops.linalg import inv3x3
    eye = jnp.eye(3, dtype=A.dtype) * 1e-6
    Minv, _ = inv3x3(M + eye[None])
    return jnp.einsum("lij,lj->li", Minv, b,
                      precision=lax.Precision.HIGHEST)
