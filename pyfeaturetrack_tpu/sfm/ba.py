"""Bundle adjustment with Schur-complement reduction.

Greenfield per SURVEY.md sections 5.8/7.2(8): the classic block-sparse BA
normal equations, laid out as batched device programs —

* per-observation residuals/Jacobians: one batched einsum pipeline [M, ...]
* camera blocks U [C,6,6], landmark blocks V [L,3,3], cross blocks
  W [L,C,6,3]: segment-sums / scatter-adds over the observation axis
* landmark marginalization: batched 3x3 inverses, then the reduced camera
  system S = U - W V^-1 W^T as einsums
* dense solve of the [6C, 6C] reduced system (cameras are few), batched
  back-substitution for landmarks.

Distributed mode: landmarks (and their observations) shard over a mesh
axis; every device builds its local V/W/S-contributions, the camera-block
system is combined with ONE psum over the interconnect (exactly the "all-reduce of
camera blocks" design in SURVEY.md section 5.8), the tiny reduced solve is
replicated, and landmark back-substitution stays local to each shard.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.linalg import inv3x3
from .geometry import skew, so3_exp

_PREC = lax.Precision.HIGHEST


class BAProblem(NamedTuple):
    """Observation set for bundle adjustment.

    K: [3,3] intrinsics; cam_idx/pt_idx: [M] int32; uv: [M,2] pixels;
    w: [M] per-observation weight (0 disables an observation/pad slot).
    """
    K: jax.Array
    cam_idx: jax.Array
    pt_idx: jax.Array
    uv: jax.Array
    w: jax.Array


def _obs_terms(K, R, t, X, cam_idx, pt_idx, uv, w, huber_delta=None):
    """Residuals + Jacobians for every observation.

    Returns (r [M,2], Jc [M,2,6], Jp [M,2,3], cost scalar). The rotation
    perturbation is left-multiplicative on (R X): Y = exp(dw) R X + t + dt,
    so dY/dw = -skew(R X), dY/dt = I, dY/dX = R.

    ``huber_delta`` (static float or None) enables IRLS Huber robustness:
    observations with residual norm above delta are downweighted by
    sqrt(delta/|r|), capping the influence of outlier tracks.
    """
    Rc = R[cam_idx]
    tc = t[cam_idx]
    Xp = X[pt_idx]
    RX = jnp.einsum("mij,mj->mi", Rc, Xp, precision=_PREC)
    Y = RX + tc
    z = Y[..., 2]
    behind = z < 1e-4
    zs = jnp.where(behind, 1.0, z)

    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    u = fx * Y[..., 0] / zs + cx
    v = fy * Y[..., 1] / zs + cy
    r = jnp.stack([u, v], -1) - uv

    zero = jnp.zeros_like(z)
    dpi = jnp.stack([
        jnp.stack([fx / zs, zero, -fx * Y[..., 0] / (zs * zs)], -1),
        jnp.stack([zero, fy / zs, -fy * Y[..., 1] / (zs * zs)], -1),
    ], -2)  # [M, 2, 3]

    weight = (w * (~behind)).astype(r.dtype)
    if huber_delta is not None:
        rn = jnp.sqrt(jnp.sum(r * r, axis=-1) + 1e-12)
        weight = weight * jnp.sqrt(
            jnp.minimum(1.0, float(huber_delta) / rn))
    weight = weight[:, None]
    r = r * weight
    dpi = dpi * weight[..., None]

    Jw = -jnp.einsum("mij,mjk->mik", dpi, skew(RX), precision=_PREC)
    Jc = jnp.concatenate([Jw, dpi], axis=-1)            # [M, 2, 6]
    Jp = jnp.einsum("mij,mjk->mik", dpi, Rc, precision=_PREC)  # [M, 2, 3]
    cost = jnp.sum(r * r)
    return r, Jc, Jp, cost


def _build_blocks(r, Jc, Jp, cam_idx, pt_idx, n_cameras: int, n_points: int):
    """Accumulate U/V/W blocks and gradient halves via scatter-adds."""
    U = jnp.zeros((n_cameras, 6, 6), r.dtype).at[cam_idx].add(
        jnp.einsum("mri,mrj->mij", Jc, Jc, precision=_PREC))
    V = jnp.zeros((n_points, 3, 3), r.dtype).at[pt_idx].add(
        jnp.einsum("mri,mrj->mij", Jp, Jp, precision=_PREC))
    W = jnp.zeros((n_points, n_cameras, 6, 3), r.dtype).at[
        pt_idx, cam_idx].add(
        jnp.einsum("mri,mrj->mij", Jc, Jp, precision=_PREC))
    b_c = jnp.zeros((n_cameras, 6), r.dtype).at[cam_idx].add(
        -jnp.einsum("mri,mr->mi", Jc, r, precision=_PREC))
    b_p = jnp.zeros((n_points, 3), r.dtype).at[pt_idx].add(
        -jnp.einsum("mri,mr->mi", Jp, r, precision=_PREC))
    return U, V, W, b_c, b_p


def _damp(M, damping):
    diag = jnp.diagonal(M, axis1=-2, axis2=-1)
    return M + jnp.eye(M.shape[-1], dtype=M.dtype) * (
        damping * diag[..., None] * jnp.eye(M.shape[-1], dtype=M.dtype)
        + 1e-9)


def _reduce_and_solve(U, b_c, S_red, b_red, damping, fix_first: bool):
    """Assemble the reduced camera system and solve it."""
    n_cameras = U.shape[0]
    U = _damp(U, damping)
    S = jnp.zeros((n_cameras, 6, n_cameras, 6), U.dtype)
    S = S.at[jnp.arange(n_cameras), :, jnp.arange(n_cameras), :].add(U)
    S = S - S_red
    b = b_c - b_red

    if fix_first:
        # gauge: pin camera 0 (zero its rows/cols, identity diagonal)
        mask = jnp.ones((n_cameras, 6), U.dtype).at[0].set(0.0)
        S = S * mask[:, :, None, None] * mask[None, None, :, :]
        S = S.at[0, jnp.arange(6), 0, jnp.arange(6)].set(1.0)
        b = b * mask

    n = n_cameras * 6
    dx = jnp.linalg.solve(S.reshape(n, n) +
                          1e-8 * jnp.eye(n, dtype=U.dtype),
                          b.reshape(n))
    return dx.reshape(n_cameras, 6)


@functools.partial(jax.jit, static_argnames=("n_cameras", "n_points",
                                             "fix_first", "huber_delta"))
def _gn_step_dense(K, R, t, X, cam_idx, pt_idx, uv, w, damping,
                   n_cameras: int, n_points: int, fix_first: bool = True,
                   huber_delta=None):
    """One Gauss-Newton/LM step, single device. Returns (R, t, X, cost)."""
    r, Jc, Jp, cost = _obs_terms(K, R, t, X, cam_idx, pt_idx, uv, w,
                                 huber_delta)
    U, V, W, b_c, b_p = _build_blocks(r, Jc, Jp, cam_idx, pt_idx,
                                      n_cameras, n_points)
    V = _damp(V, damping)
    V_inv, _ = inv3x3(V)  # closed form, no pivoted LU

    T1 = jnp.einsum("lcij,ljk->lcik", W, V_inv, precision=_PREC)
    S_red = jnp.einsum("lcik,ldmk->cidm", T1, W, precision=_PREC)
    b_red = jnp.einsum("lcik,lk->ci", T1, b_p, precision=_PREC)

    dx_c = _reduce_and_solve(U, b_c, S_red, b_red, damping, fix_first)

    rhs_p = b_p - jnp.einsum("lcij,ci->lj", W, dx_c, precision=_PREC)
    dx_p = jnp.einsum("ljk,lk->lj", V_inv, rhs_p, precision=_PREC)

    R_new = jnp.matmul(so3_exp(dx_c[:, :3]), R, precision=_PREC)
    t_new = t + dx_c[:, 3:]
    X_new = X + dx_p
    return R_new, t_new, X_new, cost


def _gn_step_sharded_body(K, R, t, X_loc, cam_idx, pt_idx_loc, uv, w,
                          damping, n_cameras, fix_first, axis,
                          huber_delta=None):
    """Per-shard GN step body (runs under shard_map).

    X_loc / pt_idx_loc are local to this shard; camera state is
    replicated. The camera-block system is psum-reduced over ``axis``.
    """
    n_points_loc = X_loc.shape[0]
    r, Jc, Jp, cost = _obs_terms(K, R, t, X_loc, cam_idx, pt_idx_loc, uv, w,
                                 huber_delta)
    U, V, W, b_c, b_p = _build_blocks(r, Jc, Jp, cam_idx, pt_idx_loc,
                                      n_cameras, n_points_loc)
    V = _damp(V, damping)
    V_inv, _ = inv3x3(V)  # closed form, no pivoted LU

    T1 = jnp.einsum("lcij,ljk->lcik", W, V_inv, precision=_PREC)
    S_red = jnp.einsum("lcik,ldmk->cidm", T1, W, precision=_PREC)
    b_red = jnp.einsum("lcik,lk->ci", T1, b_p, precision=_PREC)

    # ONE all-reduce of the camera-block system over the interconnect.
    U = lax.psum(U, axis)
    b_c = lax.psum(b_c, axis)
    S_red = lax.psum(S_red, axis)
    b_red = lax.psum(b_red, axis)
    cost = lax.psum(cost, axis)

    dx_c = _reduce_and_solve(U, b_c, S_red, b_red, damping, fix_first)

    rhs_p = b_p - jnp.einsum("lcij,ci->lj", W, dx_c, precision=_PREC)
    dx_p = jnp.einsum("ljk,lk->lj", V_inv, rhs_p, precision=_PREC)

    R_new = jnp.matmul(so3_exp(dx_c[:, :3]), R, precision=_PREC)
    t_new = t + dx_c[:, 3:]
    return R_new, t_new, X_loc + dx_p, cost


def bundle_adjust(problem: BAProblem, R0, t0, X0, n_iters: int = 10,
                  damping: float = 1e-3, fix_first: bool = True,
                  mesh: Mesh | None = None, axis: str = "landmark",
                  huber_delta: float | None = None):
    """Run ``n_iters`` damped Gauss-Newton steps. Returns
    (R, t, X, costs); ``costs`` is a DEVICE array of per-iteration
    observation costs (pull it with np.asarray only when needed — a
    device->host transfer waits for every queued step).

    With ``mesh``, landmarks and their observations are sharded over
    ``axis``: observations must be grouped so that shard d holds
    landmarks [d*L/D, (d+1)*L/D) and exactly the observations referencing
    them (use pad_problem_for_mesh to arrange this).
    """
    n_cameras = int(R0.shape[0])
    n_points = int(X0.shape[0])
    R, t, X = (jnp.asarray(R0, jnp.float32), jnp.asarray(t0, jnp.float32),
               jnp.asarray(X0, jnp.float32))
    costs = []

    if mesh is None:
        for _ in range(n_iters):
            R, t, X, cost = _gn_step_dense(
                problem.K, R, t, X, problem.cam_idx, problem.pt_idx,
                problem.uv, problem.w, jnp.float32(damping),
                n_cameras, n_points, fix_first, huber_delta)
            costs.append(cost)  # device array — no per-iteration sync
        return R, t, X, jnp.stack(costs)

    n_dev = mesh.devices.size
    assert n_points % n_dev == 0, "pad landmarks to a multiple of devices"
    assert problem.cam_idx.shape[0] % n_dev == 0, (
        "pad observations to a multiple of devices (pad_problem_for_mesh)")

    step = shard_map(
        functools.partial(_gn_step_sharded_body, damping=jnp.float32(damping),
                          n_cameras=n_cameras, fix_first=fix_first,
                          axis=axis, huber_delta=huber_delta),
        mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P(axis), P()),
        check_vma=False,
    )
    step = jax.jit(step)

    sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    X = jax.device_put(X, sh)
    R = jax.device_put(R, rep)
    t = jax.device_put(t, rep)
    cam_idx = jax.device_put(problem.cam_idx, sh)
    pt_idx = jax.device_put(problem.pt_idx, sh)
    uv = jax.device_put(problem.uv, sh)
    w = jax.device_put(problem.w, sh)

    for _ in range(n_iters):
        R, t, X, cost = step(problem.K, R, t, X, cam_idx, pt_idx, uv, w)
        costs.append(cost)
    return R, t, X, jnp.stack(costs)


def pad_problem_for_mesh(problem: BAProblem, n_points: int, n_dev: int
                         ) -> tuple[BAProblem, np.ndarray, int]:
    """Reorder + pad observations so each device owns a contiguous landmark
    shard and its observations, with pt_idx rebased to shard-local.

    Returns (padded problem, landmark padding count, obs per shard).
    ``n_points`` may grow to a multiple of ``n_dev`` — pad X0 accordingly.
    """
    cam_idx = np.asarray(problem.cam_idx)
    pt_idx = np.asarray(problem.pt_idx)
    uv = np.asarray(problem.uv)
    w = np.asarray(problem.w)

    l_pad = (-n_points) % n_dev
    l_per = (n_points + l_pad) // n_dev
    shard_of = pt_idx // l_per

    m_per = 0
    per_shard = []
    for d in range(n_dev):
        sel = np.nonzero(shard_of == d)[0]
        per_shard.append(sel)
        m_per = max(m_per, sel.size)

    ci = np.zeros((n_dev, m_per), np.int32)
    pi = np.zeros((n_dev, m_per), np.int32)
    uvp = np.zeros((n_dev, m_per, 2), np.float32)
    wp = np.zeros((n_dev, m_per), np.float32)
    for d, sel in enumerate(per_shard):
        k = sel.size
        ci[d, :k] = cam_idx[sel]
        pi[d, :k] = pt_idx[sel] - d * l_per  # shard-local landmark index
        uvp[d, :k] = uv[sel]
        wp[d, :k] = w[sel]

    out = BAProblem(
        K=problem.K,
        cam_idx=jnp.asarray(ci.reshape(-1)),
        pt_idx=jnp.asarray(pi.reshape(-1)),
        uv=jnp.asarray(uvp.reshape(-1, 2)),
        w=jnp.asarray(wp.reshape(-1)),
    )
    return out, l_pad, m_per
