"""Two-view epipolar geometry: batched 8-point essential matrix, RANSAC,
and relative-pose recovery.

Beyond the reference (which has no SfM layer) — this is the pose
BOOTSTRAP of BASELINE.md config 5's "full front-end": the tracker's
correspondences alone, with no external initial poses, seed the
pose-graph/BA back-end.

Batched shape: RANSAC is not a sequential hypothesis loop but ONE
batched program — S minimal 8-point subsets are solved simultaneously
([S, 9, 9] normal matrices, smallest eigenvector by inverse-power
iteration on the unpivoted Gauss-Jordan solver in ops/linalg — lax's
pivoted eig/svd on tiny batched matrices serializes each solve,
DESIGN.md §2), and all S x N Sampson errors are two einsums. The only host
steps are the 3x3 SVD enforcing the essential structure of the single
winning E (microseconds, once per bootstrap) and the 4-way cheirality
argmax.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.linalg import gauss_solve_det
from .triangulate import triangulate_dlt

_PREC = lax.Precision.HIGHEST


def normalize_points(K, uv):
    """Pixel coordinates [..., 2] -> normalized camera-plane coordinates
    (K^-1 applied; pinhole K with zero skew, as in geometry.project)."""
    K = jnp.asarray(K)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    return jnp.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)


def _epipolar_rows(x1, x2):
    """[..., N, 9] rows a s.t. a . vec(E) = x2h^T E x1h (homogeneous)."""
    ones = jnp.ones_like(x1[..., 0])
    return jnp.stack([
        x2[..., 0] * x1[..., 0], x2[..., 0] * x1[..., 1], x2[..., 0],
        x2[..., 1] * x1[..., 0], x2[..., 1] * x1[..., 1], x2[..., 1],
        x1[..., 0], x1[..., 1], ones,
    ], -1)


def smallest_eigvec(M, n_iter: int = 16):
    """Unit eigenvector of the smallest eigenvalue of symmetric PSD
    [..., P, P] batches, by inverse-power iteration on (M + eps I) —
    every solve is the statically-unrolled Gauss-Jordan (SPD-safe), so
    the whole batch stays one vectorized program."""
    p = M.shape[-1]
    tr = jnp.trace(M, axis1=-2, axis2=-1)[..., None, None]
    A = M + (1e-9 * tr / p + 1e-12) * jnp.eye(p, dtype=M.dtype)
    # fixed full-spectrum start vector (deterministic; any vector not
    # orthogonal to the null space works — exact orthogonality is
    # measure-zero and broken by the first iteration's rounding anyway)
    v = jnp.full(M.shape[:-1], 1.0, M.dtype) + 0.01 * jnp.arange(
        p, dtype=M.dtype)
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)

    def body(_, v):
        v, _ = gauss_solve_det(A, v)
        return v / (jnp.linalg.norm(v, axis=-1, keepdims=True) + 1e-30)

    return lax.fori_loop(0, n_iter, body, v)


def essential_from_matches(x1, x2, w=None):
    """Least-squares (unenforced) essential matrix from >= 8 normalized
    matches: E = argmin ||diag(w) A vec(E)||, ||E||_F = 1. Batched over
    leading dims."""
    rows = _epipolar_rows(x1, x2)
    if w is not None:
        rows = rows * w[..., None]
    AtA = jnp.einsum("...ni,...nj->...ij", rows, rows, precision=_PREC)
    e = smallest_eigvec(AtA)
    return e.reshape(e.shape[:-1] + (3, 3))


def sampson_error(E, x1, x2):
    """First-order (Sampson) squared epipolar error [..., N] in
    normalized-coordinate units."""
    x1h = jnp.concatenate([x1, jnp.ones_like(x1[..., :1])], -1)
    x2h = jnp.concatenate([x2, jnp.ones_like(x2[..., :1])], -1)
    Ex1 = jnp.einsum("...ij,...nj->...ni", E, x1h, precision=_PREC)
    Etx2 = jnp.einsum("...ji,...nj->...ni", E, x2h, precision=_PREC)
    num = jnp.einsum("...ni,...ni->...n", x2h, Ex1, precision=_PREC) ** 2
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
           + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    return num / (den + 1e-30)


@functools.partial(jax.jit, static_argnames=("refit_rounds",))
def _ransac_core(x1, x2, valid, idx, thresh_sq, refit_rounds: int = 2):
    """One program: solve all S hypotheses, score all S x N, pick the
    best, IRLS-refit on its inliers. Returns (E, inliers, best_count)."""
    rows = _epipolar_rows(x1, x2)                       # [N, 9]
    hyp_rows = rows[idx]                                # [S, 8, 9]
    AtA = jnp.einsum("shi,shj->sij", hyp_rows, hyp_rows, precision=_PREC)
    Es = smallest_eigvec(AtA).reshape(-1, 3, 3)         # [S, 3, 3]
    err = sampson_error(Es, x1[None], x2[None])         # [S, N]
    inl = (err < thresh_sq) & valid[None]
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)
    E, inliers = Es[best], inl[best]
    for _ in range(refit_rounds):
        E = essential_from_matches(x1, x2, inliers.astype(x1.dtype))
        inliers = (sampson_error(E, x1, x2) < thresh_sq) & valid
    return E, inliers, counts[best]


def ransac_essential(x1, x2, valid=None, n_hypotheses: int = 512,
                     thresh: float = 3e-3, seed: int = 0,
                     refit_rounds: int = 2):
    """Robust essential matrix from normalized matches [N, 2].

    ``thresh`` is the Sampson distance gate in normalized units (a
    pixel threshold p at focal length f is p / f). Hypothesis subsets
    are sampled host-side (static data); everything else is one device
    program. Returns (E [3,3], inlier mask [N], best hypothesis count).
    """
    n = x1.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)
    vnp = np.asarray(valid)
    cand = np.nonzero(vnp)[0]
    if cand.size < 8:
        raise ValueError(
            f"(ransac_essential) need >= 8 valid matches, got {cand.size}")
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(cand, size=8, replace=False)
                    for _ in range(n_hypotheses)])
    return _ransac_core(jnp.asarray(x1), jnp.asarray(x2),
                        jnp.asarray(valid), jnp.asarray(idx),
                        float(thresh) ** 2, refit_rounds)


def decompose_essential(E: np.ndarray):
    """E -> the four (R, t) candidates (host: one 3x3 SVD).

    Convention matches geometry.project: world = camera-1 frame and
    (R, t) map world -> camera 2, x2 ~ K (R X + t). t has unit norm
    (monocular scale is unobservable)."""
    E = np.asarray(E, np.float64)
    if E.shape != (3, 3):
        raise ValueError(f"(decompose_essential) expected one [3, 3] "
                         f"essential matrix, got {E.shape}")
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1, R2 = U @ W @ Vt, U @ W.T @ Vt
    t = U[:, 2]
    return (np.stack([R1, R1, R2, R2]),
            np.stack([t, -t, t, -t]).astype(np.float64))


@jax.jit
def _cheirality_scores(Rs4, ts4, x1, x2, w):
    """Triangulate all matches under each of the 4 candidates and count
    points in front of BOTH cameras."""
    eye = jnp.eye(3, dtype=x1.dtype)

    def one(R, t):
        Rs = jnp.stack([eye, R])
        ts = jnp.stack([jnp.zeros(3, x1.dtype), t])
        uvs = jnp.stack([x1, x2], axis=1)               # [N, 2, 2]
        mask = jnp.broadcast_to(w[:, None], uvs.shape[:2])
        X = triangulate_dlt(eye, Rs, ts, uvs, mask)
        d1 = X[:, 2]
        d2 = jnp.einsum("ij,nj->ni", R, X, precision=_PREC)[:, 2] + t[2]
        good = w & (d1 > 1e-6) & (d2 > 1e-6)
        return jnp.sum(good), X, good

    return jax.vmap(one)(Rs4, ts4)


def recover_pose(E, x1, x2, inliers):
    """Pick the (R, t) candidate with the best cheirality over the
    inlier matches. Returns (R [3,3], unit t [3], X [N,3] triangulated
    at ||t|| = 1, good [N] cheirality-consistent inlier mask) as numpy.
    One device->host pull (bootstrap is once per stream)."""
    Rs4, ts4 = decompose_essential(np.asarray(E))
    scores, Xs, goods = _cheirality_scores(
        jnp.asarray(Rs4, jnp.float32), jnp.asarray(ts4, jnp.float32),
        jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32),
        jnp.asarray(inliers, bool))
    k = int(np.argmax(np.asarray(scores)))
    return (Rs4[k].astype(np.float64), ts4[k].astype(np.float64),
            np.asarray(Xs[k], np.float64), np.asarray(goods[k]))


def two_view_bootstrap(K, uv1, uv2, valid=None, thresh_px: float = 2.0,
                       n_hypotheses: int = 512, seed: int = 0):
    """Full metric-up-to-scale bootstrap from pixel matches.

    Returns dict with R, t (unit baseline), X [N, 3] landmarks in the
    camera-1 = world frame, inliers (epipolar), good (epipolar AND
    cheirality) — everything downstream BA needs, no external poses.
    """
    K = np.asarray(K, np.float64)
    x1 = normalize_points(K, jnp.asarray(uv1, jnp.float32))
    x2 = normalize_points(K, jnp.asarray(uv2, jnp.float32))
    f = float(0.5 * (K[0, 0] + K[1, 1]))
    E, inliers, count = ransac_essential(
        x1, x2, valid=valid, n_hypotheses=n_hypotheses,
        thresh=thresh_px / f, seed=seed)
    R, t, X, good = recover_pose(np.asarray(E), x1, x2, inliers)
    return {"R": R, "t": t, "X": X, "inliers": np.asarray(inliers),
            "good": good, "n_best_hypothesis": int(count),
            "E": np.asarray(E, np.float64)}
