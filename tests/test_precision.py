"""Products whose CPU result is the reference do not depend on
``jax.default_matmul_precision``: on the GPU a float32 product with no
precision may run in TF32, so the ATE helper, the trajectory metrics,
the scene renderer and the solve paths either stay in float64 NumPy or
pass ``precision=HIGHEST``. Each helper is run under the lowest and
the highest default precision and must give the same result bit for
bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyfeaturetrack_tpu.sfm.geometry import project, so3_exp
from pyfeaturetrack_tpu.sfm.pipeline import ate_rmse_aligned
from pyfeaturetrack_tpu.sfm.triangulate import triangulate_dlt
from pyfeaturetrack_tpu.utils.synthscene import corridor_scene, render_blobs
from pyfeaturetrack_tpu.utils.trajectory import rpe


def _poses(n=12, seed=0):
    rng = np.random.default_rng(seed)
    R = np.asarray(so3_exp(jnp.asarray(0.05 * rng.standard_normal((n, 3)),
                                       jnp.float32)), np.float64)
    t = np.cumsum(0.1 * rng.standard_normal((n, 3)), 0)
    return R, t


def _ate():
    _, t = _poses()
    rng = np.random.default_rng(1)
    est = 1.7 * t + 0.01 * rng.standard_normal(t.shape) + 0.3
    return np.float64(ate_rmse_aligned(est, t))


def _rpe():
    R, t = _poses()
    R2, t2 = _poses(seed=2)
    return np.asarray(rpe(R, t, 0.5 * (R + R2), t + 0.01 * t2),
                      np.float64)


def _triangulate():
    rng = np.random.default_rng(3)
    C, L = 5, 40
    K = jnp.asarray([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    Rs = so3_exp(jnp.asarray(0.02 * rng.standard_normal((C, 3)),
                             jnp.float32))
    ts = jnp.asarray([[-0.2 * i, 0.0, 0.0] for i in range(C)], jnp.float32)
    X = jnp.asarray(np.stack([rng.uniform(-2, 2, L), rng.uniform(-1, 1, L),
                              rng.uniform(5, 9, L)], -1), jnp.float32)
    uv = jnp.stack([project(K, Rs[c], ts[c], X)[0] for c in range(C)], 1)
    return np.asarray(triangulate_dlt(K, Rs, ts, uv,
                                      jnp.ones((L, C), bool)))


def _render():
    K, Rs, ts, _, pts = corridor_scene(n_frames=3, h=48, w=64)
    return np.asarray(render_blobs(K, Rs, ts, pts, 48, 64))


@pytest.mark.parametrize("helper", [_ate, _rpe, _triangulate, _render],
                         ids=["ate_rmse_aligned", "rpe", "triangulate_dlt",
                              "render_blobs"])
def test_result_does_not_depend_on_default_matmul_precision(helper):
    with jax.default_matmul_precision("bfloat16"):
        low = helper()
    with jax.default_matmul_precision("float32"):
        high = helper()
    np.testing.assert_array_equal(low, high)
    assert np.all(np.isfinite(high))
