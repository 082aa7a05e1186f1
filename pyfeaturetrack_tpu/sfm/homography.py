"""Two-view planar homography: batched 4-point DLT, RANSAC, analytic
decomposition, and H/E model selection for the bootstrap.

Beyond the reference (which has no SfM layer): the essential-matrix
bootstrap (sfm/epipolar.py) degenerates exactly where real footage
starts — planar scenes (one dominant wall/floor/table) and pure camera
rotation both make the epipolar constraint ill-conditioned, while a
homography explains them perfectly. ``two_view_bootstrap_auto`` scores
both models on the same matches (ORB-SLAM-style truncated inlier
scores) and initializes from whichever wins; a homography that turns
out to be a pure rotation is reported degenerate instead of fabricating
parallax-free landmarks.

Batched shape, same as sfm/epipolar.py: RANSAC is ONE batched device
program — S minimal 4-point DLT systems ([S, 9, 9] normal matrices,
smallest eigenvector by inverse-power iteration on the unrolled
Gauss-Jordan solver) and all S x N symmetric transfer errors as
einsums; the only host step is the one-time 3x3 SVD decomposition of
the winning H.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.linalg import inv3x3
from .epipolar import (_cheirality_scores, normalize_points,
                       ransac_essential, recover_pose, sampson_error,
                       smallest_eigvec)

_PREC = lax.Precision.HIGHEST


def _homography_rows(x1, x2):
    """DLT rows: [..., N, 2, 9] such that rows . vec(H) = 0 for the
    row-major flattening of H with x2 ~ H x1h (homogeneous)."""
    ones = jnp.ones_like(x1[..., 0])
    zeros = jnp.zeros_like(ones)
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    r1 = jnp.stack([u1, v1, ones, zeros, zeros, zeros,
                    -u2 * u1, -u2 * v1, -u2], -1)
    r2 = jnp.stack([zeros, zeros, zeros, u1, v1, ones,
                    -v2 * u1, -v2 * v1, -v2], -1)
    return jnp.stack([r1, r2], -2)


def homography_from_matches(x1, x2, w=None):
    """Least-squares homography from >= 4 normalized matches:
    H = argmin ||diag(w) A vec(H)||, ||H||_F = 1. Batched over leading
    dims. x2 ~ H x1h."""
    rows = _homography_rows(x1, x2)
    if w is not None:
        rows = rows * w[..., None, None]
    rows = rows.reshape(rows.shape[:-3] + (-1, 9))
    AtA = jnp.einsum("...ni,...nj->...ij", rows, rows, precision=_PREC)
    h = smallest_eigvec(AtA)
    return h.reshape(h.shape[:-1] + (3, 3))


def transfer_errors(H, x1, x2):
    """Squared forward and backward transfer errors [..., N] in
    normalized-coordinate units: ||x2 - proj(H x1)||^2 and
    ||x1 - proj(H^-1 x2)||^2."""
    Hinv, _ = inv3x3(H)

    def one_way(M, a, b):
        ah = jnp.concatenate([a, jnp.ones_like(a[..., :1])], -1)
        p = jnp.einsum("...ij,...nj->...ni", M, ah, precision=_PREC)
        z = p[..., 2]
        safe = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
        d = p[..., :2] / safe[..., None] - b
        err = jnp.sum(d * d, -1)
        # a transferred point at (or behind) infinity is never an inlier
        return jnp.where(jnp.abs(z) < 1e-12, 1e12, err)

    return one_way(H, x1, x2), one_way(Hinv, x2, x1)


@functools.partial(jax.jit, static_argnames=("refit_rounds",))
def _ransac_core_h(x1, x2, valid, idx, thresh_sq, refit_rounds: int = 2):
    """One program: solve all S 4-point hypotheses, score all S x N
    symmetric transfer errors, pick the best, refit on its inliers.
    Returns (H, inliers, best_count)."""
    rows = _homography_rows(x1, x2)                     # [N, 2, 9]
    hyp_rows = rows[idx].reshape(idx.shape[0], -1, 9)   # [S, 8, 9]
    AtA = jnp.einsum("shi,shj->sij", hyp_rows, hyp_rows, precision=_PREC)
    Hs = smallest_eigvec(AtA).reshape(-1, 3, 3)         # [S, 3, 3]
    ef, eb = transfer_errors(Hs, x1[None], x2[None])    # [S, N]
    inl = (ef < thresh_sq) & (eb < thresh_sq) & valid[None]
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)
    H, inliers = Hs[best], inl[best]
    for _ in range(refit_rounds):
        H = homography_from_matches(x1, x2, inliers.astype(x1.dtype))
        ef, eb = transfer_errors(H, x1, x2)
        inliers = (ef < thresh_sq) & (eb < thresh_sq) & valid
    return H, inliers, counts[best]


def ransac_homography(x1, x2, valid=None, n_hypotheses: int = 512,
                      thresh: float = 3e-3, seed: int = 0,
                      refit_rounds: int = 2):
    """Robust homography from normalized matches [N, 2].

    ``thresh`` is the per-direction transfer-error gate in normalized
    units (a pixel threshold p at focal length f is p / f). Hypothesis
    subsets are sampled host-side (static data); everything else is one
    device program. Returns (H [3,3], inlier mask [N], best count).
    """
    n = x1.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)
    vnp = np.asarray(valid)
    cand = np.nonzero(vnp)[0]
    if cand.size < 4:
        raise ValueError(
            f"(ransac_homography) need >= 4 valid matches, got {cand.size}")
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(cand, size=4, replace=False)
                    for _ in range(n_hypotheses)])
    return _ransac_core_h(jnp.asarray(x1), jnp.asarray(x2),
                          jnp.asarray(valid), jnp.asarray(idx),
                          float(thresh) ** 2, refit_rounds)


def decompose_homography(H, x1=None, x2=None, inliers=None,
                         rot_tol: float = 1e-3):
    """Analytic decomposition H = R + t n^T / d into motion candidates
    (host: one 3x3 SVD, once per bootstrap).

    Convention matches sfm/epipolar: world = camera-1 frame, (R, t) map
    world -> camera 2, the plane is n^T X = d in camera-1 coordinates,
    and x2 ~ H x1 on normalized image points. Returns
    ``(Rs [M,3,3], ts [M,3], ns [M,3], degenerate)``; ts are NOT unit
    (scale carries d) — normalize before cheirality if comparing with
    the essential path. ``degenerate=True`` flags a pure rotation
    (middle-singular-value spread below ``rot_tol``): the single
    returned candidate is the closest rotation with t = 0, and no
    landmark can be triangulated from it.

    Method: Ma-Soatto-Kosecka-Sastry, "An Invitation to 3-D Vision",
    Algorithm 5.2 (SVD of H^T H), with the H sign fixed so inlier
    points satisfy x2h . (H x1h) > 0 (both projective scales positive).
    """
    H = np.asarray(H, np.float64)
    if H.shape != (3, 3):
        raise ValueError(f"(decompose_homography) expected one [3, 3] "
                         f"homography, got {H.shape}")
    # normalize by the middle singular value, fix the projective sign
    sv = np.linalg.svd(H, compute_uv=False)
    H = H / sv[1]
    if x1 is not None and x2 is not None:
        x1 = np.asarray(x1, np.float64)
        x2 = np.asarray(x2, np.float64)
        m = (np.ones(len(x1), bool) if inliers is None
             else np.asarray(inliers, bool))
        if m.any():
            x1h = np.concatenate([x1[m], np.ones((m.sum(), 1))], -1)
            x2h = np.concatenate([x2[m], np.ones((m.sum(), 1))], -1)
            s = np.median(np.einsum("ni,ni->n", x2h, x1h @ H.T))
            if s < 0:
                H = -H
    w, V = np.linalg.eigh(H.T @ H)          # ascending: s3^2, s2^2, s1^2
    s3s, _, s1s = np.maximum(w, 0.0)
    if np.sqrt(s1s) - np.sqrt(s3s) < rot_tol:
        # pure rotation: H is (near) orthogonal
        U, _, Vt = np.linalg.svd(H)
        R = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
        return (R[None], np.zeros((1, 3)), np.zeros((1, 3)), True)
    v1, v2, v3 = V[:, 2], V[:, 1], V[:, 0]  # descending singular order
    denom = np.sqrt(max(s1s - s3s, 1e-30))
    a = np.sqrt(max(1.0 - s3s, 0.0)) / denom
    b = np.sqrt(max(s1s - 1.0, 0.0)) / denom
    cands = []
    for u in (a * v1 + b * v3, a * v1 - b * v3):
        U1 = np.stack([v2, u, np.cross(v2, u)], -1)
        W1 = np.stack([H @ v2, H @ u, np.cross(H @ v2, H @ u)], -1)
        R = W1 @ U1.T
        n = np.cross(v2, u)
        t = (H - R) @ n
        cands.append((R, t, n))
        cands.append((R, -t, -n))
    Rs = np.stack([c[0] for c in cands])
    ts = np.stack([c[1] for c in cands])
    ns = np.stack([c[2] for c in cands])
    return Rs, ts, ns, False


def recover_pose_homography(H, x1, x2, inliers):
    """Pick the decomposition candidate with the best cheirality over
    the inlier matches (plane-normal visibility n_z > 0 breaks the
    remaining twofold ambiguity). Returns (R, unit t, n, X [N,3]
    triangulated at ||t|| = 1, good mask, degenerate) as numpy."""
    Rs, ts, ns, degen = decompose_homography(
        np.asarray(H), np.asarray(x1), np.asarray(x2), inliers)
    if degen:
        n = np.asarray(x1).shape[0]
        return (Rs[0], ts[0], ns[0], np.zeros((n, 3)),
                np.zeros(n, bool), True)
    norms = np.linalg.norm(ts, axis=-1)
    norms = np.where(norms < 1e-12, 1.0, norms)
    tsu = ts / norms[:, None]
    scores, Xs, goods = _cheirality_scores(
        jnp.asarray(Rs, jnp.float32), jnp.asarray(tsu, jnp.float32),
        jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32),
        jnp.asarray(inliers, bool))
    scores = np.asarray(scores).astype(np.float64)
    # the visible plane must face camera 1 (n^T X = d > 0 for points in
    # front); among cheirality ties prefer n_z > 0
    scores = scores + 0.25 * (ns[:, 2] > 0)
    k = int(np.argmax(scores))
    return (Rs[k].astype(np.float64), tsu[k].astype(np.float64),
            ns[k].astype(np.float64), np.asarray(Xs[k], np.float64),
            np.asarray(goods[k]), False)


@jax.jit
def _model_scores(E, H, x1, x2, valid, thresh_sq):
    """Truncated inlier scores (ORB-SLAM style): sum of (T - err) over
    matches with err < T, for the epipolar and homography models."""
    v = valid.astype(x1.dtype)
    se = sampson_error(E, x1, x2)
    s_e = jnp.sum(jnp.maximum(thresh_sq - se, 0.0) * v)
    ef, eb = transfer_errors(H, x1, x2)
    s_h = jnp.sum((jnp.maximum(thresh_sq - ef, 0.0)
                   + jnp.maximum(thresh_sq - eb, 0.0)) * 0.5 * v)
    return s_e, s_h


def two_view_bootstrap_auto(K, uv1, uv2, valid=None,
                            thresh_px: float = 2.0,
                            n_hypotheses: int = 512, seed: int = 0,
                            h_ratio: float = 0.45):
    """Metric-up-to-scale bootstrap with H/E model selection.

    Fits BOTH a homography and an essential matrix to the pixel matches
    (two device programs), scores them with truncated inlier scores,
    and initializes from the winner: the homography route survives
    planar scenes (where the 8-point essential is ill-conditioned) and
    *detects* pure rotation (degenerate — returned with ``good`` all
    False so callers reject and wait for parallax) instead of
    fabricating landmarks from it.

    Returns the dict of epipolar.two_view_bootstrap plus ``model``
    ("E" or "H"), ``score_ratio`` (s_h / (s_h + s_e); homography wins
    above ``h_ratio``), ``degenerate``, and for the H route the plane
    normal ``n``.
    """
    K = np.asarray(K, np.float64)
    x1 = normalize_points(K, jnp.asarray(uv1, jnp.float32))
    x2 = normalize_points(K, jnp.asarray(uv2, jnp.float32))
    f = float(0.5 * (K[0, 0] + K[1, 1]))
    thresh = thresh_px / f
    n = x1.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)
    E, inl_e, _ = ransac_essential(x1, x2, valid=valid,
                                   n_hypotheses=n_hypotheses,
                                   thresh=thresh, seed=seed)
    H, inl_h, _ = ransac_homography(x1, x2, valid=valid,
                                    n_hypotheses=n_hypotheses,
                                    thresh=thresh, seed=seed)
    s_e, s_h = _model_scores(E, H, x1, x2, jnp.asarray(valid),
                             float(thresh) ** 2)
    s_e, s_h = float(s_e), float(s_h)
    ratio = s_h / max(s_h + s_e, 1e-30)
    if ratio > h_ratio:
        R, t, nrm, X, good, degen = recover_pose_homography(
            np.asarray(H), x1, x2, inl_h)
        return {"R": R, "t": t, "X": X, "inliers": np.asarray(inl_h),
                "good": good, "model": "H", "n": nrm,
                "score_ratio": ratio, "degenerate": degen,
                "E": None, "H": np.asarray(H, np.float64)}
    R, t, X, good = recover_pose(np.asarray(E), x1, x2, inl_e)
    return {"R": R, "t": t, "X": X, "inliers": np.asarray(inl_e),
            "good": good, "model": "E", "n": None,
            "score_ratio": ratio, "degenerate": False,
            "E": np.asarray(E, np.float64), "H": None}
