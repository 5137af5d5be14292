"""Parity of the PyTorch port's geometry with the JAX package.

The same seeded numpy inputs go through geometry/se3.py, camera.py and
robust.py of both packages. Tolerance atol 1e-5: float32 throughout,
the two differ only in the order of float operations. The undistortion
round trip is held to the JAX package's own bound
(tests/test_geometry.py: 0.1 px after 10 iterations), and the package
re-exports name for name to the JAX `__init__` files.
"""

import ast
import importlib
import os

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


@pytest.mark.parametrize("fn_name", ["hat", "so3_exp", "_left_jacobian",
                                     "_left_jacobian_inv"])
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


def test_se3_inverse_and_compose(rng):
    A = np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(size=(16, 6)), jnp.float32)))
    B = np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(size=(16, 6)), jnp.float32)))
    j, t = _both("se3_inverse", A)
    np.testing.assert_allclose(t, j, atol=ATOL)
    np.testing.assert_allclose(t @ A, np.broadcast_to(np.eye(4), A.shape), atol=ATOL)
    j, t = _both("se3_compose", A, B)
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_project_stereo_and_backproject(rng):
    kw = dict(fx=718.856, fy=718.856, cx=607.19, cy=185.22, width=1241,
              height=376, bf=718.856 * 0.53716)
    jc, tc = jcam.PinholeCamera(**kw), tcam.PinholeCamera(**kw)
    assert tc.baseline == jc.baseline and tcam.PinholeCamera(1, 1, 0, 0).baseline == 0.0
    pc = np.concatenate(
        [rng.uniform(-3, 3, (50, 2)), rng.uniform(0.5, 40, (50, 1))], 1
    ).astype(np.float32)
    juvr, jz = jcam.project_stereo(jc, jnp.asarray(pc))
    tuvr, tz = tcam.project_stereo(tc, torch.from_numpy(pc))
    np.testing.assert_allclose(tuvr.numpy(), np.asarray(juvr), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    j = jcam.backproject(jc, juvr[:, :2], jz)
    t = tcam.backproject(tc, tuvr[:, :2], tz)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    np.testing.assert_allclose(t.numpy(), pc, rtol=1e-5, atol=1e-4)


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


def test_se3_log(rng):
    """se3_log after se3_exp, the small-angle series of the inverse left
    Jacobian included (theta^2 <= 1e-8 on the first rows)."""
    xi = rng.normal(size=(64, 6)).astype(np.float32)
    xi[:4, 3:] *= 1e-5
    xi[4, 3:] = 0.0
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    assert (np.sum(xi[:5, 3:].astype(np.float64) ** 2, -1) <= 1e-8).all()
    j, t = _both("se3_log", T)
    np.testing.assert_allclose(t, j, atol=ATOL)
    # the principal branch: rotations below pi come back
    small = np.linalg.norm(xi[:, 3:], axis=-1) < 3.0
    np.testing.assert_allclose(t[small], xi[small], atol=1e-3)


def test_rotmat_from_quat(rng):
    """rotmat_from_quat after quat_from_rotmat, (x, y, z, w); the
    quaternion is normalized first."""
    R = np.asarray(jse3.so3_exp(jnp.asarray(_omegas(rng))))
    q = np.asarray(jse3.quat_from_rotmat(jnp.asarray(R)))
    q = q * rng.uniform(0.5, 3.0, (q.shape[0], 1)).astype(np.float32)
    j, t = _both("rotmat_from_quat", q)
    np.testing.assert_allclose(t, j, atol=ATOL)
    np.testing.assert_allclose(t, R, atol=ATOL)


# the distortion of configs/EuRoC.yaml (cam0) and configs/TUM1.yaml
DISTORTED = {
    "euroc": dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, k1=-0.28340811,
                  k2=0.07395907, p1=0.00019359, p2=1.76187114e-05, width=752, height=480),
    "tum1": dict(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
                 k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
                 width=640, height=480),
}


@pytest.mark.parametrize("name", sorted(DISTORTED))
def test_distort_points(rng, name):
    """distort_points and distort_normalized against the JAX package,
    and undistort_points(distort_points(uv)) back to uv within the JAX
    package's bound on the image's middle (where the model inverts)."""
    kw = DISTORTED[name]
    jc, tc = jcam.PinholeCamera(**kw), tcam.PinholeCamera(**kw)
    w, h = kw["width"], kw["height"]
    uv = (rng.uniform(size=(200, 2)) * [w - 40, h - 40] + 20).astype(np.float32)
    j = jcam.distort_points(jc, jnp.asarray(uv))
    t = tcam.distort_points(tc, torch.from_numpy(uv))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    xy = ((uv - [kw["cx"], kw["cy"]]) / [kw["fx"], kw["fy"]]).astype(np.float32)
    j = jcam.distort_normalized(jc, jnp.asarray(xy))
    t = tcam.distort_normalized(tc, torch.from_numpy(xy))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    mid = (rng.uniform(size=(64, 2)) * [w / 2, h / 2] + [w / 4, h / 4]).astype(np.float32)
    back = tcam.undistort_points(tc, tcam.distort_points(tc, torch.from_numpy(mid)),
                                 num_iters=10)
    np.testing.assert_allclose(back.numpy(), mid, atol=0.1)


def test_camera_matrix():
    """PinholeCamera.K equals the JAX package's; camera_matrix is K on
    the device it names, built once."""
    kw = DISTORTED["euroc"]
    K = tcam.PinholeCamera(**kw).K
    assert K.dtype == torch.float32 and K.device.type == "cpu"
    np.testing.assert_array_equal(K.numpy(), np.asarray(jcam.PinholeCamera(**kw).K))
    cpu = torch.device("cpu")
    M = tcam.camera_matrix(tcam.PinholeCamera(**kw), cpu)
    assert torch.equal(M, K) and tcam.camera_matrix(tcam.PinholeCamera(**kw), cpu) is M


def _init_imports(path: str) -> dict:
    """{name: module} of the `from M import name` lines of an __init__."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return {a.name: node.module for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names}


@pytest.mark.parametrize("pkg", ["geometry", "bow", "slam_map"])
def test_package_reexports(pkg):
    """Each subpackage re-exports the names of the JAX one's __init__,
    from the module of the same name, as the same objects."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    j = _init_imports(os.path.join(root, "orb_slam2_test_tpu", pkg, "__init__.py"))
    t = _init_imports(os.path.join(root, "orb_slam2_test_tpu_torch", pkg, "__init__.py"))
    assert {n: m.replace("orb_slam2_test_tpu_torch.", "orb_slam2_test_tpu.")
            for n, m in t.items()} == j
    package = importlib.import_module(f"orb_slam2_test_tpu_torch.{pkg}")
    for name, module in t.items():
        assert getattr(package, name) is getattr(importlib.import_module(module), name)
