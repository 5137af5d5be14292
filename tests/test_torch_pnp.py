"""The port's PnP RANSAC against the JAX package's, on the CPU.

- `_extract_rt`: on a P whose det P[:, :3] is positive the port's equals
  the JAX package's (atol 1e-5); on -P the port's equals its own on P
  (atol 1e-5): it is sign-free. The JAX package's on -P returns a
  rotation 180 degrees off: a fault of the reference, recorded here.
- `_solve_p6p_dlt`: the same null vector up to its sign (atol 1e-4).
- `pnp_ransac_adaptive` with the JAX package's key chain replayed
  through the draw hook, at the scenes of tests/test_pnp_adaptive.py
  (25% inliers with batch 512 and up to 32768 hypotheses, 4 keys; 83%
  inliers with batch 256): equal success, pose atol 1e-4 after the
  polish, inlier sets >= 99% equal, both within 5 cm of the truth; the
  fixed-budget `pnp_ransac` likewise, and both fail alike below 6 valid
  matches.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu.solvers import pnp as jpnp
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera as TCam
from orb_slam2_test_tpu_torch.geometry.se3 import se3_exp
from orb_slam2_test_tpu_torch.solvers import pnp as tpnp

from test_pnp_adaptive import CAM, _reloc_problem

torch.set_num_threads(2)

TCAM = TCam(**CAM._asdict())
POSE_ATOL = 1e-4


def jax_draw(key):
    """A draw hook that replays `pnp_ransac_adaptive`'s key chain: one
    split per round, then `_pnp_round`'s `jax.random.choice`."""
    state = {"key": key}

    def draw(valid, n):
        state["key"], sub = jax.random.split(state["key"])
        p = jnp.asarray(valid.numpy()).astype(jnp.float32)
        p = p / jnp.maximum(jnp.sum(p), 1.0)
        idx = jax.random.choice(sub, valid.shape[0], shape=(n, 6), replace=True, p=p)
        return torch.from_numpy(np.array(idx))

    return draw


def _random_P(rng, n):
    """n projection matrices lambda [R | t] with lambda > 0."""
    xi = rng.normal(0, 1.0, (n, 6)).astype(np.float32)
    T = se3_exp(torch.from_numpy(xi)).numpy()
    lam = rng.uniform(0.2, 3.0, (n, 1, 1)).astype(np.float32)
    return T, lam * T[:, :3, :]


def test_extract_rt_is_sign_free():
    T, P = _random_P(np.random.default_rng(0), 256)
    assert (np.linalg.det(P[:, :, :3]) > 0).all()
    tR, tt = tpnp._extract_rt(torch.from_numpy(P))
    jR, jt = jpnp._extract_rt(jnp.asarray(P))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(tR.numpy(), T[:, :3, :3], atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), T[:, :3, 3], atol=1e-4)
    # the port on -P: the same [R | t]
    nR, nt = tpnp._extract_rt(torch.from_numpy(-P))
    np.testing.assert_allclose(nR.numpy(), tR.numpy(), atol=1e-5)
    np.testing.assert_allclose(nt.numpy(), tt.numpy(), atol=1e-5)


def test_reference_extract_rt_fails_on_negative_scale():
    """The JAX package's `_extract_rt` on -P (det < 0) returns R turned
    180 degrees about V's third axis: every rotation is off by more than
    1 (max abs entry), while the translation comes out right."""
    T, P = _random_P(np.random.default_rng(1), 64)
    jR, jt = jpnp._extract_rt(jnp.asarray(-P))
    gap = np.abs(np.asarray(jR) - T[:, :3, :3]).reshape(64, -1).max(1)
    assert (gap > 1.0).all(), gap.min()
    np.testing.assert_allclose(np.asarray(jt), T[:, :3, 3], atol=1e-4)


def test_dlt_matches_jax_up_to_sign():
    rng = np.random.default_rng(2)
    X = rng.uniform([-2, -2, 4], [2, 2, 10], (128, 6, 3)).astype(np.float32)
    uvn = rng.uniform(-0.5, 0.5, (128, 6, 2)).astype(np.float32)
    tP = tpnp._solve_p6p_dlt(torch.from_numpy(X), torch.from_numpy(uvn)).numpy()
    jP = np.asarray(jpnp._solve_p6p_dlt(jnp.asarray(X), jnp.asarray(uvn)))
    sign = np.sign((tP * jP).sum((1, 2)))[:, None, None]
    np.testing.assert_allclose(tP * sign, jP, atol=1e-4)


def _both(X, uv, key, **kw):
    valid = np.ones(X.shape[0], bool)
    jres, _ = jpnp.pnp_ransac_adaptive(JCam(**CAM._asdict()), X, uv, jnp.asarray(valid),
                                       key, **kw)
    tres, stats = tpnp.pnp_ransac_adaptive(
        TCAM, torch.from_numpy(np.array(X)), torch.from_numpy(np.array(uv)),
        torch.from_numpy(valid), jax_draw(key), **kw)
    return jres, tres, stats


def _assert_match(jres, tres, T_gt):
    assert bool(tres.success) == bool(jres.success)
    np.testing.assert_allclose(tres.Tcw.numpy(), np.asarray(jres.Tcw), atol=POSE_ATOL)
    assert (tres.inliers.numpy() == np.asarray(jres.inliers)).mean() >= 0.99
    assert np.linalg.norm(tres.Tcw.numpy()[:3, 3] - T_gt[:3, 3]) < 0.05


@pytest.fixture(scope="module")
def hard():
    return _reloc_problem(np.random.default_rng(0))


@pytest.mark.parametrize("seed", range(4))
def test_adaptive_matches_jax_at_25pct_inliers(hard, seed):
    X, uv, T_gt = hard
    jres, tres, stats = _both(X, uv, jax.random.PRNGKey(seed), batch=512,
                              max_hypotheses=32768)
    assert bool(tres.success)
    _assert_match(jres, tres, T_gt)
    assert stats.hypotheses == 512 * stats.rounds and stats.rounds >= 2
    print(f"seed {seed}: {stats}")


def test_adaptive_matches_jax_at_high_inliers():
    X, uv, T_gt = _reloc_problem(np.random.default_rng(0), n_inlier=100, n_outlier=20)
    jres, tres, stats = _both(X, uv, jax.random.PRNGKey(0), batch=256)
    assert bool(tres.success) and stats.rounds == 1
    _assert_match(jres, tres, T_gt)


def test_fixed_budget_matches_jax():
    """`pnp_ransac`: one round of 200 hypotheses from the JAX package's
    own draw on its key, then the polish."""
    X, uv, T_gt = _reloc_problem(np.random.default_rng(1), n_inlier=100, n_outlier=20)
    key = jax.random.PRNGKey(5)
    valid = np.ones(X.shape[0], bool)
    jres = jpnp.pnp_ransac(JCam(**CAM._asdict()), X, uv, jnp.asarray(valid), key)
    p = jnp.ones(X.shape[0], jnp.float32) / X.shape[0]
    idx = jax.random.choice(key, X.shape[0], shape=(200, 6), replace=True, p=p)
    tres = tpnp.pnp_ransac(TCAM, torch.from_numpy(np.array(X)), torch.from_numpy(np.array(uv)),
                           torch.from_numpy(valid), torch.from_numpy(np.array(idx)))
    assert bool(tres.success)
    _assert_match(jres, tres, T_gt)


def test_adaptive_fails_without_enough_points():
    """Fewer than 6 valid matches: no hypothesis reaches the score of a
    sample, both packages fail."""
    X, uv, _ = _reloc_problem(np.random.default_rng(3), n_inlier=40, n_outlier=10)
    valid = np.zeros(X.shape[0], bool)
    valid[:5] = True
    key = jax.random.PRNGKey(0)
    jres, _ = jpnp.pnp_ransac_adaptive(JCam(**CAM._asdict()), X, uv, jnp.asarray(valid), key)
    tres, _ = tpnp.pnp_ransac_adaptive(TCAM, torch.from_numpy(np.array(X)),
                                       torch.from_numpy(np.array(uv)),
                                       torch.from_numpy(valid), jax_draw(key))
    assert not bool(jres.success) and not bool(tres.success)
    assert int(tres.n_inliers) == 0 and not tres.inliers.any()
