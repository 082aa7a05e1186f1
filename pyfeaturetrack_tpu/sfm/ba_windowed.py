"""Windowed (block-sparse) bundle adjustment.

Tracks from the tracker are CONTIGUOUS camera ranges (a feature is
observed from its first tracked frame until it is lost), so each
landmark's cross blocks W_{c,l} are nonzero only for cameras in a short
window [c0_l, c0_l + K). The dense formulation in sfm/ba.py materializes
W as [L, C, 6, 3]; this module stores [L, K, 6, 3] and scatter-adds the
Schur products into the reduced camera system — O(L*K^2) block work
instead of O(L*C^2), the standard sparsity of sequential SfM, laid out
as fixed-shape batched einsum + scatter (fixed shapes, no CSR).

Also fixes a semantic subtlety of the dense table path: a feature slot
that is lost and later REFILLED by replace-lost holds two different
physical landmarks; the windowed builder splits each column into maximal
contiguous live runs, one landmark per run.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.linalg import gauss_solve_det, inv3x3
from .ba import _damp, _reduce_and_solve
from .geometry import skew, so3_exp
from .triangulate import triangulate_dlt

_PREC = lax.Precision.HIGHEST


class WindowedBAProblem(NamedTuple):
    """K-windowed observation set.

    K: [3,3]; c0: [L] first camera of each landmark's window;
    uv: [L, Kw, 2] pixels at camera c0[l]+k; w: [L, Kw] weights (0 pad).
    """
    K: jax.Array
    c0: jax.Array
    uv: jax.Array
    w: jax.Array


def column_runs(ft) -> list[tuple[int, int, int]]:
    """All maximal contiguous live runs of every feature column, split at
    re-selection frames. Returns [(column, start_frame, length), ...].

    A frame with val > 0 inside a live stretch is a FRESH selection
    (replace-lost refills store the eigenvalue at the refill frame;
    tracked frames store 0) — the slot then holds a different physical
    landmark, so the run splits there. Shared by the windowed builder and
    the dense pipeline.observations_from_feature_table.
    """
    x = np.asarray(ft.x, np.float64)
    v = np.asarray(ft.val, np.int64)
    live = (v >= 0) & (x >= 0)
    n_frames, n_cols = live.shape
    runs = []
    for j in range(n_cols):
        col = live[:, j]
        i = 0
        while i < n_frames:
            if col[i]:
                k = i + 1
                while k < n_frames and col[k] and v[k, j] <= 0:
                    k += 1
                runs.append((j, i, k - i))
                i = k  # k is end-of-table, a dead frame, or a re-selection
            else:
                i += 1
    return runs


def windowed_from_feature_table(ft, min_track_len: int = 2,
                                max_window: int | None = None):
    """FeatureTable -> (WindowedBAProblem arrays, run metadata).

    Each maximal contiguous live run of a feature column becomes one
    landmark. Returns (c0 [L], uv [L,Kw,2], w [L,Kw], runs) where runs is
    a list of (column, start_frame, length).
    """
    x = np.asarray(ft.x, np.float64)
    y = np.asarray(ft.y, np.float64)
    runs = [r for r in column_runs(ft) if r[2] >= min_track_len]
    if not runs:
        raise ValueError("no tracks of sufficient length")

    if max_window is not None:
        # split long runs into <= max_window segments (truncation would
        # silently drop observations and desync the metadata)
        split = []
        for (j, st, ln) in runs:
            off = 0
            while ln - off >= min_track_len:
                seg = min(max_window, ln - off)
                split.append((j, st + off, seg))
                off += seg
        runs = split
    kw = max(ln for (_, _, ln) in runs)
    L = len(runs)
    c0 = np.zeros((L,), np.int32)
    uv = np.zeros((L, kw, 2), np.float32)
    w = np.zeros((L, kw), np.float32)
    for li, (j, s, ln) in enumerate(runs):
        ln = min(ln, kw)
        c0[li] = s
        uv[li, :ln, 0] = x[s:s + ln, j]
        uv[li, :ln, 1] = y[s:s + ln, j]
        w[li, :ln] = 1.0
    return c0, uv, w, runs


def triangulate_windowed(K, Rs, ts, c0, uv, w):
    """DLT-triangulate each windowed landmark from its own cameras."""
    L, kw, _ = uv.shape
    C = np.asarray(Rs).shape[0]
    cidx = np.clip(np.asarray(c0)[:, None] + np.arange(kw)[None, :],
                   0, C - 1)
    uvs = np.zeros((L, C, 2), np.float32)
    mask = np.zeros((L, C), bool)
    wl = np.asarray(w) > 0
    for li in range(L):
        uvs[li, cidx[li][wl[li]]] = np.asarray(uv)[li][wl[li]]
        mask[li, cidx[li][wl[li]]] = True
    return triangulate_dlt(jnp.asarray(K, jnp.float32),
                           jnp.asarray(Rs, jnp.float32),
                           jnp.asarray(ts, jnp.float32),
                           jnp.asarray(uvs), jnp.asarray(mask))


def _banded_pcg_solve(U, b_c, S_band, b_red, damping, fix_first: bool,
                      half_band: int, n_cg: int = 200, tol: float = 1e-6,
                      precond_block: int = 1):
    """Solve the reduced camera system in BANDED form by block-Jacobi
    preconditioned CG — never materializing the [6C, 6C] matrix.

    ``S_band`` is [C, 2*half_band+1, 6, 6]: S_band[c, o] holds the
    S_red block coupling camera c with camera c + o - half_band. Memory
    is O(C * kw) and each matvec is one batched einsum, so the camera
    count scales to thousands (the dense solve caps
    at a few hundred).

    ``precond_block`` = cameras per preconditioner group: 1 is classic
    block-Jacobi on the [6, 6] diagonal; g > 1 gathers each run of g
    cameras' intra-band couplings into a dense [6g, 6g] block and
    inverts those (batched, ONCE per solve) — a group/overlap-free
    additive-Schwarz preconditioner that captures the in-window camera
    coupling the 6x6 diagonal ignores. Application stays one batched
    matmul per CG iteration.
    """
    C = U.shape[0]
    width = 2 * half_band + 1
    eye6 = jnp.eye(6, dtype=U.dtype)

    # A = damped diag(U) - S_red (+ the dense path's 1e-8 ridge)
    A = (-S_band).at[:, half_band].add(_damp(U, damping) + 1e-8 * eye6)
    b = b_c - b_red

    if fix_first:
        # gauge: pin camera 0 (zero its rows/cols, identity diagonal)
        c_of = (jnp.arange(C)[:, None] + jnp.arange(width)[None, :]
                - half_band)                                # column camera
        row_ok = (jnp.arange(C) != 0)[:, None, None, None]
        col_ok = (c_of != 0)[:, :, None, None]
        A = jnp.where(row_ok & col_ok, A, 0.0)
        A = A.at[0, half_band].set(eye6)
        b = b.at[0].set(0.0)

    pad = jnp.zeros((half_band, 6), b.dtype)

    def matvec(v):
        vpad = jnp.concatenate([pad, v, pad], axis=0)
        # windows: vg[c, o] = v[c + o - half_band] (zero outside range)
        cg_idx = jnp.arange(C)[:, None] + jnp.arange(width)[None, :]
        vg = vpad[cg_idx]                                   # [C, width, 6]
        return jnp.einsum("coij,coj->ci", A, vg, precision=_PREC)

    if precond_block <= 1:
        M = A[:, half_band]                                 # block-Jacobi

        def prec(r):
            z, _ = gauss_solve_det(M, r)
            return z
    else:
        g = int(precond_block)
        nG = -(-C // g)                                     # ceil(C / g)
        Cp = nG * g
        # gather each group's intra-band couplings into [6g, 6g] blocks:
        # entry (i, j) of group G is A[G*g + i, j - i + half_band]
        # (identity on the pad rows so the blocks stay SPD)
        A_pad = jnp.concatenate(
            [A, jnp.zeros((Cp - C, width, 6, 6), A.dtype)
                   .at[:, half_band].set(jnp.eye(6, dtype=A.dtype))],
            axis=0)
        ii = jnp.arange(g)
        off = ii[None, :] - ii[:, None] + half_band         # [g, g]
        valid = (off >= 0) & (off < width)
        cams = (jnp.arange(nG)[:, None, None] * g + ii[:, None])  # [nG,g,1]
        Mg = jnp.where(
            valid[None, :, :, None, None],
            A_pad[cams, jnp.clip(off, 0, width - 1)[None]], 0.0)
        Mg = Mg.transpose(0, 1, 3, 2, 4).reshape(nG, 6 * g, 6 * g)
        # ONE batched inversion per solve; application is one matmul
        # per CG iteration. (jnp.linalg.inv is the pivoted-LU path, but
        # amortized over the ~n_cg iterations it enables.)
        Mg_inv = jnp.linalg.inv(Mg)

        def prec(r):
            rp = jnp.pad(r, ((0, Cp - C), (0, 0))).reshape(nG, 6 * g)
            z = jnp.einsum("gij,gj->gi", Mg_inv, rp, precision=_PREC)
            return z.reshape(Cp, 6)[:C]

    # standard PCG on the 6C-dim system, batched as [C, 6]
    x0 = jnp.zeros_like(b)
    r0 = b - matvec(x0)
    z0 = prec(r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)
    bb = jnp.maximum(jnp.sum(b * b), 1e-30)

    def cond(state):
        _, r, _, _, k = state
        return (k < n_cg) & (jnp.sum(r * r) > tol * tol * bb)

    def body(state):
        x, r, p, rz, k = state
        Ap = matvec(p)
        alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        return x, r, z + beta * p, rz_new, k + 1

    x, _, _, _, k = jax.lax.while_loop(cond, body, (x0, r0, p0, rz0, 0))
    return x, k


def _windowed_camera_system(K, R, t, X, c0, uv, w, damping,
                            n_cameras: int, huber_delta=None):
    """Per-landmark assembly of the windowed reduced camera system.

    Returns (U, b_c, S_band, b_red, cost) — the camera-side system in
    banded form (psum-reducible across landmark shards) — plus the
    per-landmark factors (V_inv, W, b_p, cidx) needed for the point
    back-substitution after the camera solve.
    """
    L, kw, _ = uv.shape
    cidx = jnp.clip(c0[:, None] + jnp.arange(kw, dtype=c0.dtype)[None, :],
                    0, n_cameras - 1)                      # [L, Kw]

    Rc = R[cidx]                                           # [L, Kw, 3, 3]
    tc = t[cidx]
    RX = jnp.einsum("lkij,lj->lki", Rc, X, precision=_PREC)
    Y = RX + tc
    z = Y[..., 2]
    behind = z < 1e-4
    zs = jnp.where(behind, 1.0, z)

    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    u = fx * Y[..., 0] / zs + cx
    v = fy * Y[..., 1] / zs + cy
    r = jnp.stack([u, v], -1) - uv                         # [L, Kw, 2]

    zero = jnp.zeros_like(z)
    dpi = jnp.stack([
        jnp.stack([fx / zs, zero, -fx * Y[..., 0] / (zs * zs)], -1),
        jnp.stack([zero, fy / zs, -fy * Y[..., 1] / (zs * zs)], -1),
    ], -2)                                                 # [L, Kw, 2, 3]

    # window slots past the last camera are IGNORED regardless of the
    # caller's weights: the roll-based row assembly wraps modulo C, so a
    # nonzero out-of-range block would corrupt early cameras (old code
    # clipped onto the last camera — also wrong, just contained)
    in_range = (c0[:, None] + jnp.arange(kw, dtype=c0.dtype)[None, :]
                < n_cameras)
    weight = (w * (~behind) * in_range).astype(r.dtype)
    if huber_delta is not None:
        rn = jnp.sqrt(jnp.sum(r * r, axis=-1) + 1e-12)
        weight = weight * jnp.sqrt(
            jnp.minimum(1.0, float(huber_delta) / rn))
    r = r * weight[..., None]
    dpi = dpi * weight[..., None, None]

    Jw = -jnp.einsum("lkij,lkjm->lkim", dpi, skew(RX), precision=_PREC)
    Jc = jnp.concatenate([Jw, dpi], axis=-1)               # [L, Kw, 2, 6]
    Jp = jnp.einsum("lkij,lkjm->lkim", dpi, Rc, precision=_PREC)
    cost = jnp.sum(r * r)

    # Camera-block accumulation WITHOUT duplicate-index scatters (XLA
    # serializes those; they dominated this step at ~74 ms/iter). The
    # row camera of every block is c0[l] + k, so each per-k slice is a
    # segment-sum over c0 — one one-hot matmul — followed
    # by a STATIC roll by k. Landmarks whose window is clipped past the
    # last camera carry zero weight, so their wrapped rows add zeros.
    onehot = (c0[:, None] == jnp.arange(n_cameras, dtype=c0.dtype)[None, :]
              ).astype(r.dtype)                            # [L, C]

    def by_row(blocks, spec):
        """einsum blocks [L, Kw, ...] -> [Kw, C, ...] at c0, then shift
        slice k down by k so rows land at c0 + k."""
        per_k = jnp.einsum(spec, onehot, blocks, precision=_PREC)
        return sum(jnp.roll(per_k[k], k, axis=0) for k in range(kw))

    U = by_row(jnp.einsum("lkri,lkrj->lkij", Jc, Jc, precision=_PREC),
               "lc,lkij->kcij")
    V = jnp.sum(jnp.einsum("lkri,lkrj->lkij", Jp, Jp, precision=_PREC),
                axis=1)                                    # [L, 3, 3]
    W = jnp.einsum("lkri,lkrj->lkij", Jc, Jp, precision=_PREC)  # [L,Kw,6,3]
    b_c = by_row(-jnp.einsum("lkri,lkr->lki", Jc, r, precision=_PREC),
                 "lc,lki->kci")
    b_p = -jnp.sum(jnp.einsum("lkri,lkr->lki", Jp, r, precision=_PREC),
                   axis=1)                                 # [L, 3]

    V = _damp(V, damping)
    V_inv, _ = inv3x3(V)

    T1 = jnp.einsum("lkij,ljm->lkim", W, V_inv, precision=_PREC)
    S_blocks = jnp.einsum("lkim,lbnm->lkbin", T1, W, precision=_PREC)
    b_red = by_row(jnp.einsum("lkim,lm->lki", T1, b_p, precision=_PREC),
                   "lc,lki->kci")

    # Band form first in BOTH solver modes: block (l, k, b) couples row
    # camera c0+k with col camera c0+b at offset b - k + half_band. For
    # each k the whole b-axis lands contiguously at offsets
    # [half_band-k, half_band-k+kw), so one roll + one pad per k builds
    # the band (kw ops, keeps the compiled graph small).
    half_band = kw - 1
    width = 2 * half_band + 1
    S_by = jnp.einsum("lc,lkbin->kcbin", onehot, S_blocks,
                      precision=_PREC)                     # [Kw,C,Kw,6,6]
    S_band = jnp.zeros((n_cameras, width, 6, 6), r.dtype)
    for k in range(kw):
        rolled = jnp.roll(S_by[k], k, axis=0)              # [C, Kw, 6, 6]
        S_band = S_band + jnp.pad(
            rolled, ((0, 0), (half_band - k, k), (0, 0), (0, 0)))

    return (U, b_c, S_band, b_red, cost), (V_inv, W, b_p, cidx)


def _windowed_solve_and_update(R, t, X, sys_terms, point_terms, damping,
                               n_cameras: int, fix_first: bool,
                               solver: str, precond_block: int):
    """Camera solve on the (possibly psum-reduced) banded system, then
    the per-landmark back-substitution. Returns (R,t,X,cost,cg_iters)."""
    U, b_c, S_band, b_red, cost = sys_terms
    V_inv, W, b_p, cidx = point_terms
    half_band = S_band.shape[1] // 2
    width = 2 * half_band + 1

    if solver == "dense":
        # densify the band: row c, col c + off - half_band. Indices are
        # unique EXCEPT the clipped boundary rows (their values are
        # zeroed by ``ok``) — correct, but do NOT add unique_indices
        # hints here
        ci = jnp.arange(n_cameras)[:, None]
        di = ci + jnp.arange(width)[None, :] - half_band   # [C, width]
        ok = (di >= 0) & (di < n_cameras)
        S_red = jnp.zeros((n_cameras, 6, n_cameras, 6), S_band.dtype).at[
            ci, :, jnp.clip(di, 0, n_cameras - 1), :].add(
            jnp.where(ok[:, :, None, None], S_band, 0.0))
        dx_c = _reduce_and_solve(U, b_c, S_red, b_red, damping, fix_first)
        cg_iters = jnp.int32(0)
    else:
        dx_c, cg_iters = _banded_pcg_solve(U, b_c, S_band, b_red, damping,
                                           fix_first, half_band,
                                           precond_block=precond_block)

    dxc_g = dx_c[cidx]                                     # [L, Kw, 6]
    rhs_p = b_p - jnp.einsum("lkij,lki->lj", W, dxc_g, precision=_PREC)
    dx_p = jnp.einsum("ljk,lk->lj", V_inv, rhs_p, precision=_PREC)

    R_new = jnp.matmul(so3_exp(dx_c[:, :3]), R, precision=_PREC)
    t_new = t + dx_c[:, 3:]
    return R_new, t_new, X + dx_p, cost, cg_iters


@functools.partial(jax.jit, static_argnames=("n_cameras", "fix_first",
                                             "huber_delta", "solver",
                                             "precond_block"))
def _gn_step_windowed(K, R, t, X, c0, uv, w, damping, n_cameras: int,
                      fix_first: bool = True, huber_delta=None,
                      solver: str = "dense", precond_block: int = 1):
    """One GN/LM step with K-windowed cross blocks (single device)."""
    sys_terms, point_terms = _windowed_camera_system(
        K, R, t, X, c0, uv, w, damping, n_cameras, huber_delta)
    return _windowed_solve_and_update(R, t, X, sys_terms, point_terms,
                                      damping, n_cameras, fix_first,
                                      solver, precond_block)


def _gn_step_windowed_sharded_body(K, R, t, X_loc, c0_loc, uv_loc, w_loc,
                                   damping, n_cameras: int,
                                   fix_first: bool, huber_delta,
                                   solver: str, precond_block: int,
                                   axis: str):
    """Per-shard windowed GN step (runs under shard_map): landmarks and
    their window observations shard over ``axis``; camera state is
    replicated. The banded camera system is ONE psum over the interconnect (same
    all-reduce shape as sfm/ba._gn_step_sharded_body); every shard then
    runs the identical replicated camera solve and back-substitutes its
    local landmarks."""
    sys_terms, point_terms = _windowed_camera_system(
        K, R, t, X_loc, c0_loc, uv_loc, w_loc, damping, n_cameras,
        huber_delta)
    sys_terms = jax.tree.map(lambda a: lax.psum(a, axis), sys_terms)
    return _windowed_solve_and_update(R, t, X_loc, sys_terms, point_terms,
                                      damping, n_cameras, fix_first,
                                      solver, precond_block)


@functools.partial(jax.jit, static_argnames=("n_cameras",))
def _points_only_step(K, R, t, X, c0, uv, w, damping, n_cameras: int):
    """Refine landmarks with cameras FROZEN (each landmark is an
    independent damped 3x3 solve) — the standard warm start when initial
    triangulation is weak (short baselines + noisy poses)."""
    L, kw, _ = uv.shape
    cidx = jnp.clip(c0[:, None] + jnp.arange(kw, dtype=c0.dtype)[None, :],
                    0, n_cameras - 1)
    Rc = R[cidx]
    tc = t[cidx]
    RX = jnp.einsum("lkij,lj->lki", Rc, X, precision=_PREC)
    Y = RX + tc
    z = Y[..., 2]
    behind = z < 1e-4
    zs = jnp.where(behind, 1.0, z)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    r = jnp.stack([fx * Y[..., 0] / zs + cx, fy * Y[..., 1] / zs + cy],
                  -1) - uv
    zero = jnp.zeros_like(z)
    dpi = jnp.stack([
        jnp.stack([fx / zs, zero, -fx * Y[..., 0] / (zs * zs)], -1),
        jnp.stack([zero, fy / zs, -fy * Y[..., 1] / (zs * zs)], -1),
    ], -2)
    in_range = (c0[:, None] + jnp.arange(kw, dtype=c0.dtype)[None, :]
                < n_cameras)
    weight = (w * (~behind) * in_range).astype(r.dtype)
    r = r * weight[..., None]
    dpi = dpi * weight[..., None, None]
    Jp = jnp.einsum("lkij,lkjm->lkim", dpi, Rc, precision=_PREC)
    V = jnp.sum(jnp.einsum("lkri,lkrj->lkij", Jp, Jp, precision=_PREC), 1)
    b_p = -jnp.sum(jnp.einsum("lkri,lkr->lki", Jp, r, precision=_PREC), 1)
    V_inv, _ = inv3x3(_damp(V, damping))
    return X + jnp.einsum("ljk,lk->lj", V_inv, b_p, precision=_PREC)


def gate_windowed(problem: WindowedBAProblem, R0, t0, X0,
                  max_reproj_error: float) -> WindowedBAProblem:
    """Zero the weights of observations whose INITIAL reprojection error
    exceeds the threshold (outlier tracks / bad triangulations)."""
    n_cameras = int(np.asarray(R0).shape[0])
    c0 = jnp.asarray(problem.c0)
    kw = problem.uv.shape[1]
    cidx = jnp.clip(c0[:, None] + jnp.arange(kw, dtype=c0.dtype)[None, :],
                    0, n_cameras - 1)
    R = jnp.asarray(R0, jnp.float32)
    t = jnp.asarray(t0, jnp.float32)
    Y = jnp.einsum("lkij,lj->lki", R[cidx], jnp.asarray(X0, jnp.float32),
                   precision=_PREC) + t[cidx]
    zs = jnp.maximum(Y[..., 2], 1e-4)
    K = problem.K
    u = K[0, 0] * Y[..., 0] / zs + K[0, 2]
    v = K[1, 1] * Y[..., 1] / zs + K[1, 2]
    err = jnp.sqrt((u - problem.uv[..., 0]) ** 2 +
                   (v - problem.uv[..., 1]) ** 2)
    ok = (err <= max_reproj_error) & (Y[..., 2] > 0)
    return problem._replace(w=problem.w * ok.astype(problem.w.dtype))


def bundle_adjust_windowed(problem: WindowedBAProblem, R0, t0, X0,
                           n_iters: int = 10, damping: float = 1e-3,
                           fix_first: bool = True,
                           huber_delta: float | None = None,
                           point_only_iters: int = 2,
                           solver: str = "dense",
                           precond_block: int = 1,
                           return_info: bool = False,
                           mesh=None, axis: str = "landmark"):
    """Run GN/LM with K-windowed sparsity. Returns (R, t, X, costs) with
    costs a device array. ``point_only_iters`` camera-frozen landmark
    refinements run first (cheap, stabilizes weak triangulations).

    ``solver="dense"`` materializes + solves the [6C, 6C] reduced camera
    system (exact; fine to a few hundred cameras). ``solver="cg"`` keeps
    it in banded block form and runs block-Jacobi PCG — O(C*kw) memory,
    scaling to thousands of cameras. ``precond_block`` > 1 strengthens
    the CG preconditioner from the [6, 6] diagonal to [6g, 6g] camera
    groups (fewer CG iterations per GN step; see _banded_pcg_solve).
    ``return_info=True`` appends a diagnostics dict (per-GN-iter CG
    iteration counts; zeros for dense).

    With ``mesh``, landmarks (problem rows + X) shard over ``axis``
    and the banded camera system is ONE psum per GN step over the
    interconnect — the multi-device scale-out of the assembly, which
    dominates the step at production landmark counts. Landmark count must be a multiple of the mesh size (use
    pad_windowed_for_mesh); camera state stays replicated.
    """
    n_cameras = int(np.asarray(R0).shape[0])
    R = jnp.asarray(R0, jnp.float32)
    t = jnp.asarray(t0, jnp.float32)
    X = jnp.asarray(X0, jnp.float32)

    if mesh is None:
        step = functools.partial(
            _gn_step_windowed, n_cameras=n_cameras, fix_first=fix_first,
            huber_delta=huber_delta, solver=solver,
            precond_block=precond_block)
        K_, c0, uv, w = problem.K, problem.c0, problem.uv, problem.w
    else:
        from jax import shard_map
        from jax.sharding import NamedSharding, PartitionSpec as P
        n_dev = mesh.devices.size
        if int(problem.c0.shape[0]) % n_dev:
            raise ValueError(
                "landmark count must be a multiple of the mesh size — "
                "use pad_windowed_for_mesh")
        body = functools.partial(
            _gn_step_windowed_sharded_body, n_cameras=n_cameras,
            fix_first=fix_first, huber_delta=huber_delta, solver=solver,
            precond_block=precond_block, axis=axis)
        step = jax.jit(shard_map(
            lambda K, R, t, X, c0, uv, w, damping: body(
                K, R, t, X, c0, uv, w, damping),
            mesh=mesh,
            in_specs=(P(), P(), P(), P(axis), P(axis), P(axis), P(axis),
                      P()),
            out_specs=(P(), P(), P(axis), P(), P()),
            check_vma=False))
        sh = NamedSharding(mesh, P(axis))
        rep = NamedSharding(mesh, P())
        K_ = jax.device_put(problem.K, rep)
        c0 = jax.device_put(problem.c0, sh)
        uv = jax.device_put(problem.uv, sh)
        w = jax.device_put(problem.w, sh)
        X = jax.device_put(X, sh)
        R = jax.device_put(R, rep)
        t = jax.device_put(t, rep)

    # warm start AFTER the (optional) sharding setup: the points-only
    # step is per-landmark independent, so with sharded inputs GSPMD
    # partitions it across the mesh instead of bottlenecking one device
    for _ in range(point_only_iters):
        X = _points_only_step(K_, R, t, X, c0, uv, w,
                              jnp.float32(damping), n_cameras)

    costs, cg_iters = [], []
    for _ in range(n_iters):
        R, t, X, cost, k = step(K_, R, t, X, c0, uv, w,
                                jnp.float32(damping))
        costs.append(cost)
        cg_iters.append(k)
    out = (R, t, X, jnp.stack(costs))
    if return_info:
        out = out + ({"cg_iters": jnp.stack(cg_iters)},)
    return out


def pad_windowed_for_mesh(problem: WindowedBAProblem, X0, n_dev: int
                          ) -> tuple[WindowedBAProblem, jnp.ndarray, int]:
    """Pad landmarks (rows of the problem + X0) to a multiple of the
    mesh size with zero-weight windows. Returns (problem, X0, n_pad);
    slice the trailing n_pad rows off the returned X after BA. Zero
    weights make pad rows exact no-ops in the camera system (V gets
    only _damp's 1e-9 ridge, so T1 = W·V⁻¹ = 0, dx_p = 0)."""
    L = int(problem.c0.shape[0])
    n_pad = (-L) % n_dev
    if n_pad == 0:
        return problem, jnp.asarray(X0, jnp.float32), 0
    kw = int(problem.uv.shape[1])
    problem = problem._replace(
        c0=jnp.concatenate([problem.c0,
                            jnp.zeros((n_pad,), problem.c0.dtype)]),
        uv=jnp.concatenate([problem.uv,
                            jnp.zeros((n_pad, kw, 2), problem.uv.dtype)]),
        w=jnp.concatenate([problem.w,
                           jnp.zeros((n_pad, kw), problem.w.dtype)]))
    Xp = jnp.concatenate([jnp.asarray(X0, jnp.float32),
                          jnp.ones((n_pad, 3), jnp.float32)])
    return problem, Xp, n_pad
