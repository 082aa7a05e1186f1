"""Worker for the 2-process multi-host simulation test (run via
subprocess from test_multiprocess.py — NOT collected by pytest).

Each process brings up jax.distributed over CPU with 4 virtual local
devices (8 global), then exercises the real multi-host paths:
chunk assignment, boundary all-gather stitching, and one landmark-sharded
BA step over the GLOBAL mesh, comparing against the locally-computed
dense reference.
"""

import json
import os
import sys

# must happen before jax import
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main(port: str, pid: int, out_path: str) -> int:
    from pyfeaturetrack_tpu.parallel.multihost import (
        allgather_boundary_states, host_chunk_assignment,
        initialize_cluster)

    info = initialize_cluster(coordinator_address=f"localhost:{port}",
                              num_processes=2, process_id=pid)
    assert info["process_count"] == 2, info
    assert info["global_devices"] == 8, info
    assert info["local_devices"] == 4, info

    # --- chunk assignment: 5 chunks over 2 hosts (uneven -> pad path)
    mine = host_chunk_assignment(5)
    assert mine == ([0, 1, 2] if pid == 0 else [3, 4]), mine

    # --- boundary all-gather stitching
    n_feat = 7
    local = np.stack([np.full((n_feat, 3), c, np.float32) for c in mine])
    gathered = allgather_boundary_states(local, n_chunks=5)
    want = np.stack([np.full((n_feat, 3), c, np.float32) for c in range(5)])
    np.testing.assert_array_equal(gathered, want)

    # --- one sharded BA step over the global 8-device mesh
    from jax.sharding import Mesh
    from pyfeaturetrack_tpu.sfm import BAProblem, bundle_adjust
    from pyfeaturetrack_tpu.sfm.geometry import project, so3_exp

    rng = np.random.default_rng(0)  # identical data on both processes
    C, L = 4, 64
    K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], np.float32)
    w_axis = 0.01 * rng.standard_normal((C, 3)).astype(np.float32)
    Rs = so3_exp(jnp.asarray(w_axis))
    ts = np.stack([[-0.1 * i, 0.0, 0.0] for i in range(C)]).astype(
        np.float32)
    X = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L),
                  rng.uniform(4, 8, L)], -1).astype(np.float32)
    uv_dev, _ = jax.vmap(lambda R, t: project(jnp.asarray(K), R, t,
                                              jnp.asarray(X)))(
        jnp.asarray(Rs), jnp.asarray(ts))
    uv = np.asarray(uv_dev).reshape(-1, 2)
    cam = np.repeat(np.arange(C), L).astype(np.int32)
    pt = np.tile(np.arange(L), C).astype(np.int32)
    problem = BAProblem(jnp.asarray(K), jnp.asarray(cam), jnp.asarray(pt),
                        jnp.asarray(uv), jnp.ones((C * L,), jnp.float32))
    X0 = (X + 0.03 * rng.standard_normal(X.shape)).astype(np.float32)

    from pyfeaturetrack_tpu.sfm.ba import pad_problem_for_mesh
    mesh = Mesh(np.asarray(jax.devices()), ("landmark",))
    sharded, l_pad, _ = pad_problem_for_mesh(problem, L, 8)
    assert l_pad == 0
    R1, t1, X1, costs_sh = bundle_adjust(sharded, Rs, ts, X0, n_iters=3,
                                         mesh=mesh)
    R2, t2, X2, costs_dn = bundle_adjust(problem, Rs, ts, X0, n_iters=3)

    from jax.sharding import NamedSharding, PartitionSpec as P
    # psum shard-order vs dense reduction order: float32 noise only
    np.testing.assert_allclose(np.asarray(costs_sh), np.asarray(costs_dn),
                               rtol=1e-3)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), atol=1e-4)
    # X1 is landmark-sharded across processes: replicate to compare
    X1_full = jax.jit(lambda a: a,
                      out_shardings=NamedSharding(mesh, P()))(X1)
    np.testing.assert_allclose(np.asarray(X1_full), np.asarray(X2),
                               atol=1e-4)

    # --- landmark-sharded WINDOWED BA over the same global mesh
    from pyfeaturetrack_tpu.sfm import (WindowedBAProblem,
                                        bundle_adjust_windowed,
                                        pad_windowed_for_mesh)
    kw = 3
    c0 = rng.integers(0, C - kw + 1, L).astype(np.int32)
    cidx = c0[:, None] + np.arange(kw)[None, :]
    uv_w = np.asarray(uv_dev)[cidx, np.arange(L)[:, None]]  # [L, kw, 2]
    wproblem = WindowedBAProblem(
        K=jnp.asarray(K), c0=jnp.asarray(c0), uv=jnp.asarray(uv_w),
        w=jnp.ones((L, kw), jnp.float32))
    wp, X0p, _ = pad_windowed_for_mesh(wproblem, X0, 8)
    Rw, tw, Xw, costs_w = bundle_adjust_windowed(
        wp, Rs, ts, X0p, n_iters=3, point_only_iters=0, solver="cg",
        mesh=mesh)
    Rw2, tw2, Xw2, costs_w2 = bundle_adjust_windowed(
        wproblem, Rs, ts, X0, n_iters=3, point_only_iters=0)
    np.testing.assert_allclose(np.asarray(costs_w), np.asarray(costs_w2),
                               rtol=1e-3)
    np.testing.assert_allclose(np.asarray(tw), np.asarray(tw2), atol=2e-4)

    with open(out_path, "w") as f:
        json.dump({"ok": True, "pid": pid,
                   "final_cost": float(np.asarray(costs_sh)[-1]),
                   "final_cost_windowed": float(np.asarray(costs_w)[-1])},
                  f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), sys.argv[3]))
