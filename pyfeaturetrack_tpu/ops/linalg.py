"""Batched small-matrix linear algebra, unpivoted and vectorized.

``jnp.linalg.{det,solve,inv}`` on [N, P, P] batches of tiny matrices
lowers to pivoted LU, whose row swaps serialize each tiny solve. The normal
matrices in this framework (LK 2x2, affine 4x4/6x6, BA landmark 3x3) are
symmetric (semi)definite, so unpivoted Gauss-Jordan / closed-form
adjugates are numerically fine and fully vectorize as elementwise
work over the batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def inv3x3(M: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Closed-form inverse + determinant of [..., 3, 3] matrices.
    Singular inputs give garbage inverses — callers mask on |det|."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    safe = jnp.where(jnp.abs(det) < 1e-30, 1.0, det)
    adj = jnp.stack([
        jnp.stack([A, -(b * i - c * h), b * f - c * e], -1),
        jnp.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        jnp.stack([C, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj / safe[..., None, None], det


def gauss_solve_det(A: jax.Array, b: jax.Array
                    ) -> tuple[jax.Array, jax.Array]:
    """Solve A x = b for [..., P, P] / [..., P] batches via unpivoted
    Gauss-Jordan (statically unrolled over P). Returns (x, det).

    This is the batched form of the reference's
    _am_gauss_jordan_elimination (trackFeatures.py); pivoting is dropped
    because the systems are SPD normal matrices (Cholesky-safe), and
    near-singular lanes are detected by |det| and masked by callers.
    """
    p = A.shape[-1]
    aug = jnp.concatenate([A, b[..., None]], axis=-1)  # [..., P, P+1]
    det = jnp.ones(A.shape[:-2], A.dtype)
    idx = jnp.arange(p)
    for k in range(p):
        piv = aug[..., k, k]
        det = det * piv
        safe = jnp.where(jnp.abs(piv) < 1e-30, 1.0, piv)
        row = aug[..., k, :] / safe[..., None]          # [..., P+1]
        factors = aug[..., :, k]                        # [..., P]
        elim = aug - factors[..., :, None] * row[..., None, :]
        aug = jnp.where((idx == k)[..., :, None], row[..., None, :], elim)
    return aug[..., :, p], det
