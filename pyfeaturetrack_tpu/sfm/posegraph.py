"""Pose-graph optimization over relative SE(3) constraints.

Greenfield (SURVEY.md section 7.2(8)). Poses are world-to-camera (the
same convention as sfm/ba.py): X_cam = R X_world + t. An edge (i, j)
measures the relative transform cam_i -> cam_j:

    R_ij = R_j R_i^T,   t_ij = t_j - R_ij t_i

Residual per edge: r = [ log(R_meas^T R_ij_pred),  t_ij_pred - t_meas ].

Gauss-Newton with autodiff Jacobians: residuals are differentiated w.r.t.
a left-multiplicative tangent perturbation xi [C, 6] at zero (jacfwd), the
[E*6, C*6] system is solved densely with pose 0 pinned — appropriate for
the keyframe-scale graphs the tracker front-end produces (batched dense
linear algebra; block-sparse assembly is the scale-up path).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .geometry import so3_exp, so3_log

_PREC = lax.Precision.HIGHEST


class PoseGraph(NamedTuple):
    """Edges i->j with measured relative transforms and weights.

    edge_i/edge_j: [E] int32; R_meas: [E,3,3]; t_meas: [E,3];
    w_rot/w_trans: [E] weights.
    """
    edge_i: jax.Array
    edge_j: jax.Array
    R_meas: jax.Array
    t_meas: jax.Array
    w_rot: jax.Array
    w_trans: jax.Array


def _edge_residuals(xi, R, t, graph: PoseGraph):
    """[E, 6] residuals under tangent perturbation xi [C, 6]."""
    Rp = jnp.matmul(so3_exp(xi[:, :3]), R, precision=_PREC)
    tp = t + xi[:, 3:]
    Ri = Rp[graph.edge_i]
    Rj = Rp[graph.edge_j]
    ti = tp[graph.edge_i]
    tj = tp[graph.edge_j]
    R_rel = jnp.einsum("eij,ekj->eik", Rj, Ri, precision=_PREC)  # Rj Ri^T
    t_rel = tj - jnp.einsum("eij,ej->ei", R_rel, ti, precision=_PREC)
    r_R = so3_log(jnp.einsum("eji,ejk->eik", graph.R_meas, R_rel,
                             precision=_PREC))  # log(R_meas^T R_rel)
    r_t = t_rel - graph.t_meas
    return jnp.concatenate([r_R * graph.w_rot[:, None],
                            r_t * graph.w_trans[:, None]], axis=-1)


@functools.partial(jax.jit, static_argnames=("fix_first",))
def _pg_step(R, t, graph: PoseGraph, damping, fix_first: bool = True):
    n = R.shape[0]
    xi0 = jnp.zeros((n, 6), R.dtype)
    r = _edge_residuals(xi0, R, t, graph)             # [E, 6]
    J = jax.jacfwd(_edge_residuals)(xi0, R, t, graph)  # [E, 6, C, 6]

    e = r.reshape(-1)
    Jf = J.reshape(e.shape[0], n * 6)
    H = jnp.matmul(Jf.T, Jf, precision=_PREC)
    g = -jnp.matmul(Jf.T, e, precision=_PREC)
    H = H + damping * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(n * 6, dtype=R.dtype)

    if fix_first:
        mask = jnp.ones((n * 6,), R.dtype).at[:6].set(0.0)
        H = H * mask[:, None] * mask[None, :]
        H = H.at[jnp.arange(6), jnp.arange(6)].set(1.0)
        g = g * mask

    dx = jnp.linalg.solve(H, g).reshape(n, 6)
    R_new = jnp.matmul(so3_exp(dx[:, :3]), R, precision=_PREC)
    t_new = t + dx[:, 3:]
    return R_new, t_new, jnp.sum(r * r)


def optimize_pose_graph(graph: PoseGraph, R0, t0, n_iters: int = 10,
                        damping: float = 1e-4, fix_first: bool = True):
    """Run Gauss-Newton on the pose graph. Returns (R, t, costs)."""
    R = jnp.asarray(R0, jnp.float32)
    t = jnp.asarray(t0, jnp.float32)
    costs = []
    for _ in range(n_iters):
        R, t, cost = _pg_step(R, t, graph, jnp.float32(damping), fix_first)
        costs.append(cost)  # device array; pulled only when the caller asks
    return R, t, jnp.stack(costs)


def odometry_graph(R_rel, t_rel, w_rot=1.0, w_trans=1.0,
                   loop_edges=None) -> PoseGraph:
    """Chain graph from per-step relative transforms [C-1, ...], plus
    optional loop-closure edges [(i, j, R_ij, t_ij), ...]."""
    n = R_rel.shape[0]
    ei = list(range(n))
    ej = list(range(1, n + 1))
    Rm = [R_rel[i] for i in range(n)]
    tm = [t_rel[i] for i in range(n)]
    if loop_edges:
        for (i, j, Rij, tij) in loop_edges:
            ei.append(i)
            ej.append(j)
            Rm.append(Rij)
            tm.append(tij)
    e = len(ei)
    return PoseGraph(
        edge_i=jnp.asarray(ei, jnp.int32),
        edge_j=jnp.asarray(ej, jnp.int32),
        R_meas=jnp.stack([jnp.asarray(r, jnp.float32) for r in Rm]),
        t_meas=jnp.stack([jnp.asarray(x, jnp.float32) for x in tm]),
        w_rot=jnp.full((e,), w_rot, jnp.float32),
        w_trans=jnp.full((e,), w_trans, jnp.float32),
    )
