"""Camera pose from 3D-2D correspondences: motion-only Gauss-Newton
("PnP refinement") and batched DLT-PnP RANSAC.

Beyond the reference (no SfM layer): with epipolar.two_view_bootstrap
this completes the pose chain of BASELINE.md config 5's front-end —
every new keyframe localizes against the current landmark map, no
external poses anywhere.

Batched shape: the GN normal equations are one [6, 6] solve per iteration
(ops/linalg Gauss-Jordan; Jacobians shared with sfm/ba._obs_terms so
motion-only and full BA agree about the parameterization), and RANSAC
is ONE batched program — S minimal 6-point DLT systems ([S, 12, 12]
normal matrices, smallest eigenvector by inverse power), rotations
orthogonalized by a batched Newton polar iteration (no per-hypothesis
host SVD), all S x N reprojection errors scored in one batch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.linalg import gauss_solve_det
from .epipolar import normalize_points, smallest_eigvec
from .geometry import so3_exp

_PREC = lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("n_iters", "huber_delta"))
def refine_pose(K, R0, t0, X, uv, w, n_iters: int = 10,
                huber_delta: float | None = None, damping: float = 1e-6):
    """Motion-only GN: refine ONE camera pose against fixed landmarks.

    X [N, 3] world points, uv [N, 2] pixels, w [N] weights (0 masks).
    Returns (R, t, cost): cost is the final weighted squared pixel
    error (device scalar — don't pull it mid-pipeline).
    Shares _obs_terms with bundle adjustment: identical residuals,
    left-multiplicative rotation update, Huber IRLS semantics.
    """
    from .ba import _obs_terms
    n = X.shape[0]
    cam_idx = jnp.zeros((n,), jnp.int32)
    pt_idx = jnp.arange(n)

    def body(_, state):
        R, t, _ = state
        r, Jc, _, cost = _obs_terms(K, R[None], t[None], X, cam_idx,
                                    pt_idx, uv, w, huber_delta)
        H = jnp.einsum("mri,mrj->ij", Jc, Jc, precision=_PREC)
        g = -jnp.einsum("mri,mr->i", Jc, r, precision=_PREC)
        H = H + damping * jnp.eye(6, dtype=H.dtype) * (
            1.0 + jnp.diagonal(H))
        dx, _ = gauss_solve_det(H, g)
        R_new = jnp.matmul(so3_exp(dx[:3]), R, precision=_PREC)
        return R_new, t + dx[3:], cost

    R, t, cost = lax.fori_loop(
        0, n_iters, body,
        (jnp.asarray(R0, jnp.float32), jnp.asarray(t0, jnp.float32),
         jnp.asarray(0.0, jnp.float32)))
    return R, t, cost


def _dlt_rows(X, x):
    """[..., N, 2, 12] DLT constraint rows for normalized pixels x and
    world points X; p = rows of P = [R | t] flattened row-major."""
    Xh = jnp.concatenate([X, jnp.ones_like(X[..., :1])], -1)  # [..., N, 4]
    zero = jnp.zeros_like(Xh)
    ru = jnp.concatenate([Xh, zero, -x[..., 0:1] * Xh], -1)
    rv = jnp.concatenate([zero, Xh, -x[..., 1:2] * Xh], -1)
    return jnp.stack([ru, rv], -2)


def _polar_orthogonalize(M, n_iter: int = 6):
    """Nearest rotation to near-orthogonal [..., 3, 3] batches by Newton
    polar iteration R <- 1.5 R - 0.5 R R^T R (quadratic convergence for
    inputs near O(3); minimal-sample DLT cameras are)."""
    def body(_, R):
        RtR = jnp.einsum("...ji,...jk->...ik", R, R, precision=_PREC)
        return 1.5 * R - 0.5 * jnp.einsum("...ij,...jk->...ik", R, RtR,
                                          precision=_PREC)
    return lax.fori_loop(0, n_iter, body, M)


@jax.jit
def _pnp_core(x, X, valid, idx, thresh_sq):
    """All S minimal DLT hypotheses + scoring in one program. Returns
    (R [S,3,3], t [S,3], err [S,N], counts [S])."""
    rows = _dlt_rows(X, x)                              # [N, 2, 12]
    hyp = rows[idx].reshape(idx.shape[0], -1, 12)       # [S, 12, 12]
    AtA = jnp.einsum("shi,shj->sij", hyp, hyp, precision=_PREC)
    p = smallest_eigvec(AtA)                            # [S, 12]
    P = p.reshape(-1, 3, 4)
    M = P[:, :, :3]
    from ..ops.linalg import inv3x3
    _, det = inv3x3(M)  # closed-form batched det (no lax LinAlg)
    # fix projective sign/scale: det(M/s) = 1 for s = cbrt(det)
    s = jnp.sign(det) * jnp.abs(det) ** (1.0 / 3.0)
    s = jnp.where(jnp.abs(s) < 1e-12, 1e-12, s)[:, None, None]
    R = _polar_orthogonalize(M / s)
    t = P[:, :, 3] / s[:, :, 0]
    # reprojection in normalized coords
    Y = jnp.einsum("sij,nj->sni", R, X, precision=_PREC) + t[:, None]
    z = Y[..., 2]
    front = z > 1e-6
    zs = jnp.where(front, z, 1.0)
    pred = Y[..., :2] / zs[..., None]
    err = jnp.sum((pred - x[None]) ** 2, -1)
    err = jnp.where(front, err, jnp.inf)
    inl = (err < thresh_sq) & valid[None]
    return R, t, err, jnp.sum(inl, -1)


def pnp_ransac(K, X, uv, valid=None, n_hypotheses: int = 256,
               thresh_px: float = 3.0, seed: int = 0,
               refine_iters: int = 10):
    """Robust pose from [N, 3] world points and [N, 2] pixels, no prior.

    One batched device program for hypotheses + scoring; winner refined
    by motion-only GN on its inliers. Returns (R, t, inliers) numpy.
    """
    X = jnp.asarray(X, jnp.float32)
    uv = jnp.asarray(uv, jnp.float32)
    n = X.shape[0]
    if valid is None:
        valid = np.ones((n,), bool)
    vnp = np.asarray(valid)
    cand = np.nonzero(vnp)[0]
    if cand.size < 6:
        raise ValueError(
            f"(pnp_ransac) need >= 6 valid points, got {cand.size}")
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(cand, size=6, replace=False)
                    for _ in range(n_hypotheses)])
    Kn = np.asarray(K, np.float64)
    x = normalize_points(Kn, uv)
    thr = (thresh_px / float(0.5 * (Kn[0, 0] + Kn[1, 1]))) ** 2
    Rs, ts, err, counts = _pnp_core(x, X, jnp.asarray(vnp),
                                    jnp.asarray(idx), thr)
    best = int(np.argmax(np.asarray(counts)))
    inliers = np.asarray(err)[best] < thr
    R, t, _ = refine_pose(jnp.asarray(Kn, jnp.float32), Rs[best],
                          ts[best], X, uv,
                          jnp.asarray(inliers & vnp, jnp.float32),
                          n_iters=refine_iters, huber_delta=2.0)
    return np.asarray(R, np.float64), np.asarray(t, np.float64), inliers
