"""Parity of the PyTorch port's pose optimization with the JAX package.

- project_residual: rtol 1e-4 (float32, other operation order);
- the plain version against `_pose_optimization_xla` and against the
  Pallas kernel in interpret mode, on the problem of
  tests/test_pallas_kernels.py (O = 300, half stereo, 10% outliers):
  pose atol 1e-4, inlier agreement > 0.99, chi2 rtol/atol 1e-3. The 40
  dependent iterations accumulate float32 rounding of sums taken in
  another order (and, against the kernel, a Cholesky solve in place of
  an LU solve).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.solvers import reprojection as jrep
from orb_slam2_test_tpu.solvers.pose_opt import _pose_optimization_xla
from orb_slam2_test_tpu.solvers.pose_opt_pallas import pose_optimization_tpu
from orb_slam2_test_tpu_torch.entry import pose_problem
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera as TCam
from orb_slam2_test_tpu_torch.solvers import pose_opt as tpo
from orb_slam2_test_tpu_torch.solvers import pose_opt_cuda
from orb_slam2_test_tpu_torch.solvers import reprojection as trep
from test_pallas_kernels import _pose_problem

torch.set_num_threads(2)


def _tcam(cam):
    return TCam(*cam)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


@pytest.mark.parametrize("stereo_frac", [0.0, 0.5])
def test_project_residual(rng, stereo_frac):
    cam, T_true, T0, X, obs = _pose_problem(rng, O=100, stereo_frac=stereo_frac)
    isig = rng.uniform(0.3, 1.0, 100).astype(np.float32)
    j = jrep.project_residual(
        cam, jnp.asarray(T0, jnp.float32), jnp.asarray(X), jnp.asarray(obs),
        jnp.asarray(isig),
    )
    t = trep.project_residual(_tcam(cam), _t(T0), _t(X), _t(obs), _t(isig))
    for field in ("r", "chi2", "Jc", "Jp"):
        np.testing.assert_allclose(
            getattr(t, field).numpy(), np.asarray(getattr(j, field)),
            rtol=1e-4, atol=1e-6, err_msg=field,
        )
    np.testing.assert_array_equal(t.depth_ok.numpy(), np.asarray(j.depth_ok))


def _plain(cam, T0, X, obs, isig, valid):
    return tpo._pose_optimization_plain(
        _tcam(cam), _t(T0), _t(X), _t(obs), _t(isig), _t(valid, torch.bool)
    )


def _agree(a, b):
    return np.mean(np.asarray(a) == np.asarray(b))


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
def test_pose_plain_matches_jax(rng, reference):
    cam, T_true, T0, X, obs = _pose_problem(rng)
    isig = np.ones(X.shape[0], np.float32)
    valid = np.ones(X.shape[0], bool)
    args = (cam, jnp.asarray(T0), jnp.asarray(X), jnp.asarray(obs),
            jnp.asarray(isig), jnp.asarray(valid))
    if reference == "xla":
        ref = _pose_optimization_xla(*args)
        T_ref, inl_ref, chi2_ref = ref.Tcw, ref.inliers, ref.chi2
    else:
        T_ref, inl_ref, chi2_ref = pose_optimization_tpu(*args)
        inl_ref = np.asarray(inl_ref) & valid
    got = _plain(cam, T0, X, obs, isig, valid)
    np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(T_ref), atol=1e-4)
    assert _agree(got.inliers.numpy(), inl_ref) > 0.99
    np.testing.assert_allclose(
        got.chi2.numpy(), np.asarray(chi2_ref), rtol=1e-3, atol=1e-3
    )
    assert int(got.n_inliers) == int(got.inliers.sum())
    assert np.abs(got.Tcw.numpy() - T_true)[:3].max() < 5e-3


def test_pose_plain_respects_valid_mask(rng):
    cam, T_true, T0, X, obs = _pose_problem(rng, O=200, outlier_frac=0.0)
    obs2 = obs.copy()
    obs2[100:, :2] = -1e4  # poisoned, but marked invalid
    valid = np.arange(200) < 100
    got = _plain(cam, T0, X, obs2, np.ones(200, np.float32), valid)
    assert np.abs(got.Tcw.numpy() - T_true).max() < 5e-3
    assert not got.inliers.numpy()[100:].any()


def test_pose_optimization_dispatches_cpu_to_plain(rng):
    cam, _, T0, X, obs = _pose_problem(rng, O=64)
    args = (_tcam(cam), _t(T0), _t(X), _t(obs), torch.ones(64),
            torch.ones(64, dtype=torch.bool))
    a = tpo.pose_optimization(*args)
    b = tpo._pose_optimization_plain(*args)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    with pytest.raises(ValueError, match="CUDA"):
        pose_opt_cuda.pose_optimization_cuda(*args)
    assert pose_opt_cuda.POSE_OPT.launches == 0


def test_entry_pose_problem_is_the_jax_tests_problem():
    jcam, jT_true, jT0, jX, jobs = _pose_problem(np.random.default_rng(4))
    tcam, tT_true, tT0, tX, tobs = pose_problem(np.random.default_rng(4), 300)
    assert tuple(tcam) == tuple(jcam)
    np.testing.assert_array_equal(tX, jX)
    for a, b in ((tT_true, jT_true), (tT0, jT0), (tobs, jobs)):
        # se3_exp of torch and of JAX differ by float32 rounding only
        np.testing.assert_allclose(a, b, atol=1e-4)
