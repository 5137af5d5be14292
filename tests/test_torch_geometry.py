"""Parity of the PyTorch port's geometry with the JAX package.

The same seeded numpy inputs go through geometry/se3.py, camera.py and
robust.py of both packages. Tolerance atol 1e-5: float32 throughout,
the two differ only in the order of float operations.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.geometry import camera as jcam
from orb_slam2_test_tpu.geometry import robust as jrob
from orb_slam2_test_tpu.geometry import se3 as jse3
from orb_slam2_test_tpu_torch.geometry import camera as tcam
from orb_slam2_test_tpu_torch.geometry import robust as trob
from orb_slam2_test_tpu_torch.geometry import se3 as tse3

torch.set_num_threads(2)

ATOL = 1e-5


def _both(fn_name, *arrays):
    """Run `fn_name` of both se3 modules on the same float32 arrays."""
    j = getattr(jse3, fn_name)(*[jnp.asarray(a) for a in arrays])
    t = getattr(tse3, fn_name)(*[torch.from_numpy(np.array(a)) for a in arrays])
    return np.asarray(j), t.numpy()


def _omegas(rng, n=64):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w[:4] *= 1e-5  # the series branch near zero
    w[4] = 0.0
    return w


@pytest.mark.parametrize("fn_name", ["hat", "so3_exp", "_left_jacobian"])
def test_so3_functions(rng, fn_name):
    j, t = _both(fn_name, _omegas(rng))
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_se3_exp(rng):
    xi = rng.normal(size=(64, 6)).astype(np.float32)
    xi[:4] *= 1e-5
    j, t = _both("se3_exp", xi)
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_rt_to_mat_and_apply(rng):
    R = np.asarray(jse3.so3_exp(jnp.asarray(_omegas(rng, 8))))
    tv = rng.normal(size=(8, 3)).astype(np.float32)
    j, t = _both("rt_to_mat", R, tv)
    np.testing.assert_array_equal(t, j)
    X = rng.normal(size=(8, 3)).astype(np.float32)
    j, t = _both("se3_apply", j, X)
    np.testing.assert_allclose(t, j, atol=ATOL)


@pytest.mark.parametrize("fn_name", ["so3_project", "se3_project"])
def test_manifold_projection(rng, fn_name):
    T = np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(size=(16, 6)), jnp.float32)))
    T = T + rng.normal(0, 1e-3, T.shape).astype(np.float32)  # skewed rotation
    arg = T[:, :3, :3] if fn_name == "so3_project" else T
    j, t = _both(fn_name, np.ascontiguousarray(arg))
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_project(rng):
    kw = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480)
    pc = np.concatenate(
        [rng.uniform(-3, 3, (50, 2)), rng.uniform(0.5, 10, (50, 1))], 1
    ).astype(np.float32)
    juv, jz = jcam.project(jcam.PinholeCamera(**kw), jnp.asarray(pc))
    tuv, tz = tcam.project(tcam.PinholeCamera(**kw), torch.from_numpy(pc))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), atol=ATOL)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


def test_undistort_points(rng):
    # configs/TUM1.yaml's distortion, the strongest the repo ships
    kw = dict(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
              k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628,
              k3=1.163314, width=640, height=480)
    uv = np.stack(
        [rng.uniform(20, 620, 100), rng.uniform(20, 460, 100)], 1
    ).astype(np.float32)
    j = jcam.undistort_points(jcam.PinholeCamera(**kw), jnp.asarray(uv))
    t = tcam.undistort_points(tcam.PinholeCamera(**kw), torch.from_numpy(uv))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    assert tcam.PinholeCamera(**kw).has_distortion


def test_robust_constants_and_huber(rng):
    for name in ("CHI2_MONO", "CHI2_STEREO", "HUBER_MONO", "HUBER_STEREO"):
        assert getattr(trob, name) == getattr(jrob, name)
    chi2 = np.concatenate([[0.0, 1e-14], rng.uniform(0, 40, 200)]).astype(np.float32)
    for delta in (jrob.HUBER_MONO, jrob.HUBER_STEREO):
        j = jrob.huber_weight(jnp.asarray(chi2), delta)
        t = trob.huber_weight(torch.from_numpy(chi2), delta)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
