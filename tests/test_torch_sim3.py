"""The port's Sim(3) geometry and Sim3 solver against the JAX package's,
on the CPU.

- `geometry/sim3.py`: exp, log, compose, inverse, apply and the SE3
  lift and projection on numpy-seeded tangents (small, moderate and
  near-pi rotations, zero and non-zero log-scale): atol 1e-5 (float32,
  another operation order; log through a 3x3 LU solve in both).
- `_horn_batch` on non-degenerate 3- and 5-point samples, free and
  fixed scale: atol 1e-4 (the SVD's signs differ, the reflection fix is
  sign-free).
- `sim3_ransac` with the JAX package's `jax.random.choice` draws fed
  in, free and fixed scale, with outliers: success and inliers equal,
  S12 atol 1e-4.
- `optimize_sim3`'s Jacobian (`tangent_jacobian` against jax.jacfwd)
  within 1e-3 relative to its largest entry (float32 pixels of
  magnitude ~1e3), and the refined S12 from a perturbed start: atol
  1e-4, inliers equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.geometry import sim3 as jsim3
from orb_slam2_test_tpu.solvers import sim3_solver as jsolver
from orb_slam2_test_tpu.utils.synthetic import default_camera as jdefault_camera
from orb_slam2_test_tpu_torch.geometry import se3 as tse3
from orb_slam2_test_tpu_torch.geometry import sim3 as tsim3
from orb_slam2_test_tpu_torch.solvers import sim3_solver as tsolver
from orb_slam2_test_tpu_torch.utils.synthetic import default_camera, make_landmarks

torch.set_num_threads(2)

ATOL = 1e-5
POSE_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _tangents(seed: int, n: int = 24) -> np.ndarray:
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 0.4, (n, 7)).astype(np.float32)
    xi[:4, 3:6] *= 1e-5  # near-zero rotations (series branches)
    xi[4:8, 6] = 0.0  # zero log-scale
    xi[8:10, 6] *= 1e-5
    axis = rng.normal(size=(4, 3))
    xi[10:14, 3:6] = (axis / np.linalg.norm(axis, axis=1, keepdims=True)
                      * np.array([[3.0], [3.1], [2.5], [1.0]]))  # up to near pi
    return xi


def test_sim3_ops_match_jax():
    xi = _tangents(0)
    S_j = jsim3.sim3_exp(jnp.asarray(xi))
    S_t = tsim3.sim3_exp(_t(xi))
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), atol=ATOL)
    np.testing.assert_allclose(tsim3.sim3_log(S_t).numpy(),
                               np.asarray(jsim3.sim3_log(S_j)), atol=1e-4)
    # log inverts exp away from the pi boundary
    np.testing.assert_allclose(tsim3.sim3_log(S_t).numpy()[:12], xi[:12], atol=1e-4)
    B_j, B_t = S_j[::-1], S_t.flip(0)
    np.testing.assert_allclose(tsim3.sim3_compose(S_t, B_t).numpy(),
                               np.asarray(jsim3.sim3_compose(S_j, B_j)), atol=ATOL)
    np.testing.assert_allclose(tsim3.sim3_inverse(S_t).numpy(),
                               np.asarray(jsim3.sim3_inverse(S_j)), atol=ATOL)
    x = np.random.default_rng(1).normal(0, 3.0, (len(xi), 3)).astype(np.float32)
    np.testing.assert_allclose(tsim3.sim3_apply(S_t, _t(x)).numpy(),
                               np.asarray(jsim3.sim3_apply(S_j, jnp.asarray(x))), atol=1e-4)
    np.testing.assert_allclose(tsim3.sim3_scale(S_t).numpy(),
                               np.asarray(jsim3.sim3_scale(S_j)), rtol=1e-6)
    T_j = jsim3.se3_from_sim3(S_j)
    np.testing.assert_allclose(tsim3.se3_from_sim3(S_t).numpy(), np.asarray(T_j), atol=ATOL)
    np.testing.assert_allclose(tsim3.sim3_from_se3(_t(np.asarray(T_j))).numpy(),
                               np.asarray(jsim3.sim3_from_se3(T_j)), atol=ATOL)
    # so3_log through the quaternion, at pi included
    from orb_slam2_test_tpu.geometry.se3 import so3_log as jso3_log

    R = np.asarray(T_j)[:, :3, :3]
    np.testing.assert_allclose(tse3.so3_log(_t(R)).numpy(), np.asarray(jso3_log(jnp.asarray(R))),
                               atol=1e-5)


def _pair(seed, n=100, scale=1.4, noise=0.0, outlier=0):
    """tests/test_loop_solvers.py's TestSim3 pair."""
    rng = np.random.default_rng(seed)
    pc2 = make_landmarks(rng, n, spread=1.5)
    R = tse3.so3_exp(torch.tensor([0.1, -0.2, 0.05])).numpy()
    t = np.array([0.4, -0.2, 0.6], np.float32)
    pc1 = (scale * pc2 @ R.T + t).astype(np.float32)
    if noise:
        pc1 = pc1 + rng.normal(0, noise, pc1.shape).astype(np.float32)
    if outlier:
        pc1[:outlier] += rng.uniform(0.5, 2.0, (outlier, 3)).astype(np.float32)
    return pc1, pc2


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_batch_matches_jax(k, fix_scale):
    pc1, pc2 = _pair(2, noise=0.003)
    rng = np.random.default_rng(3)
    idx = np.stack([rng.choice(100, k, replace=False) for _ in range(64)])
    js, jR, jt = jsolver._horn_batch(jnp.asarray(pc1[idx]), jnp.asarray(pc2[idx]), fix_scale)
    ts, tR, tt = tsolver._horn_batch(_t(pc1[idx]), _t(pc2[idx]), fix_scale)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=POSE_ATOL)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=POSE_ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=POSE_ATOL)
    np.testing.assert_allclose(np.linalg.det(tR.numpy()), 1.0, atol=1e-5)


@jax.jit
def _jax_choice(key, valid):
    """The draw inside the JAX sim3_ransac (:78-80)."""
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    return jax.random.choice(key, valid.shape[0], shape=(128, 3), replace=True, p=p)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_with_jax_draws(fix_scale):
    pc1, pc2 = _pair(4, scale=1.0 if fix_scale else 1.4, noise=0.003, outlier=20)
    valid = np.ones(100, bool)
    valid[90:] = False
    key = jax.random.PRNGKey(5)
    cam = jdefault_camera(640, 480)
    jres = jsolver.sim3_ransac(cam, jnp.asarray(pc1), jnp.asarray(pc2), jnp.asarray(valid), key,
                               fix_scale=fix_scale)
    idx = torch.from_numpy(np.asarray(_jax_choice(key, jnp.asarray(valid))))
    tres = tsolver.sim3_ransac(default_camera(640, 480), _t(pc1), _t(pc2),
                               torch.from_numpy(valid), idx, fix_scale=fix_scale)
    assert bool(tres.success) == bool(jres.success) and bool(tres.success)
    assert int(tres.n_inliers) == int(jres.n_inliers)
    np.testing.assert_array_equal(tres.inliers.numpy(), np.asarray(jres.inliers))
    np.testing.assert_allclose(tres.S12.numpy(), np.asarray(jres.S12), atol=POSE_ATOL)


def test_optimize_sim3_matches_jax():
    pc1, pc2 = _pair(6, noise=0.002)
    cam_j, cam_t = jdefault_camera(640, 480), default_camera(640, 480)
    S_true = jsim3.sim3_make(jnp.asarray(1.4), jnp.asarray(tse3.so3_exp(
        torch.tensor([0.1, -0.2, 0.05])).numpy()), jnp.array([0.4, -0.2, 0.6]))
    S0 = jsim3.sim3_exp(jnp.array([0.05, -0.03, 0.02, 0.01, 0.02, -0.01, 0.03])) @ S_true
    valid = np.ones(100, bool)
    valid[::17] = False

    # the Gauss-Newton Jacobian: batched jvp against jax.jacfwd
    uv1 = tsolver._proj(cam_t, _t(pc1))
    uv2 = tsolver._proj(cam_t, _t(pc2))
    Jt = tsim3.tangent_jacobian(lambda xi: tsolver.sim3_residuals(
        cam_t, xi, _t(np.asarray(S0)), _t(pc1), _t(pc2), uv1, uv2), torch.zeros(7))

    def jres(xi):
        Sc = jsim3.sim3_exp(xi) @ S0
        Sinv = jsim3.sim3_inverse(Sc)

        def proj(p3):
            z = jnp.where(jnp.abs(p3[..., 2]) > 1e-6, p3[..., 2], 1e-6)
            return jnp.stack([cam_j.fx * p3[..., 0] / z + cam_j.cx,
                              cam_j.fy * p3[..., 1] / z + cam_j.cy], axis=-1)

        a = proj(jnp.asarray(pc2) @ Sc[:3, :3].T + Sc[:3, 3]) - proj(jnp.asarray(pc1))
        b = proj(jnp.asarray(pc1) @ Sinv[:3, :3].T + Sinv[:3, 3]) - proj(jnp.asarray(pc2))
        return jnp.concatenate([a, b], axis=0)

    Jj = np.asarray(jax.jacfwd(jres)(jnp.zeros(7)))
    assert Jt.shape == Jj.shape == (200, 2, 7)
    np.testing.assert_allclose(Jt.numpy(), Jj, atol=1e-3 * np.abs(Jj).max())

    for fix_scale in (False, True):
        jS, jinl, jn = jsolver.optimize_sim3(cam_j, S0, jnp.asarray(pc1), jnp.asarray(pc2),
                                             jnp.asarray(valid), fix_scale=fix_scale)
        tS, tinl, tn = tsolver.optimize_sim3(cam_t, _t(np.asarray(S0)), _t(pc1), _t(pc2),
                                             torch.from_numpy(valid), fix_scale=fix_scale)
        np.testing.assert_allclose(tS.numpy(), np.asarray(jS), atol=POSE_ATOL)
        np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
        assert int(tn) == int(jn)
