"""The port's bundle adjustment over flat observations (solvers/ba_core.py)
against the JAX package's, on the CPU.

The problems are tests/test_ba.py's (`make_ba_problem`: 6 cameras, 120
points, every point seen by every camera) and the KITTI-shaped
`synthetic_ba_problem`, carried across as numpy arrays.

- `bundle_adjust`, dense Schur: mono (2 fixed cameras), stereo, and
  mono with 10% outliers: poses atol 1e-4, points 1e-4 on >= 98% and
  1e-2 on all (a point's depth along its rays is ill-conditioned in
  float32; with outliers 6 of 120 points moved 3.7e-3), inlier masks
  equal, cost rtol 1e-4.
- `bundle_adjust`, CG: poses atol 1e-3 (40 CG iterations in float32,
  sums in another order), inliers equal.
- `chi2_active_gate` and `_robust_cost`: masks equal, cost rtol 1e-5.
- `bundle_adjust_partial` in the global BA's chunks (4 robust
  iterations as 2 + 2, the gate, 8 inlier iterations as 4 + 4) equal
  to one unchunked run of the port exactly, and to the same chunks of
  the JAX package within 1e-3.
- `utils.synthetic.synthetic_ba_problem`: the JAX package's arrays
  (same seed), exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.solvers import ba_core as jba
from orb_slam2_test_tpu.utils.synthetic import synthetic_ba_problem as j_synthetic_ba_problem
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.solvers import ba_core as tba
from orb_slam2_test_tpu_torch.utils.synthetic import synthetic_ba_problem

from test_ba import make_ba_problem

torch.set_num_threads(2)

POSE_ATOL = 1e-4
CG_ATOL = 1e-3


def _tprob(prob) -> tba.BAProblem:
    out = []
    for f in tba.BAProblem._fields:
        a = np.asarray(getattr(prob, f))
        t = torch.from_numpy(a.copy())
        out.append(t.to(torch.int64) if f in ("obs_cam", "obs_pt") else t)
    return tba.BAProblem(*out)


def _tcam(cam) -> PinholeCamera:
    return PinholeCamera(**cam._asdict())


def _problem(seed, **kw):
    cam, prob, T_true, X_true = make_ba_problem(np.random.default_rng(seed), **kw)
    return cam, prob


CASES = {
    "mono": dict(n_fixed=2),
    "stereo": dict(stereo=True),
    "outliers": dict(outlier_frac=0.1, n_fixed=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bundle_adjust_dense_matches_jax(case):
    cam, prob = _problem(1, **CASES[case])
    jr = jba.bundle_adjust(prob, cam)
    tr = tba.bundle_adjust(_tprob(prob), _tcam(cam))
    np.testing.assert_allclose(tr.cam_Tcw.numpy(), np.asarray(jr.cam_Tcw), atol=POSE_ATOL)
    gap = np.abs(tr.pt_xyz.numpy() - np.asarray(jr.pt_xyz)).max(-1)
    assert (gap <= POSE_ATOL).mean() >= 0.98 and gap.max() <= 1e-2, gap.max()
    np.testing.assert_array_equal(tr.obs_inlier.numpy(), np.asarray(jr.obs_inlier))
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-4)
    # the fixed cameras stay where they were
    fixed = np.asarray(prob.cam_fixed)
    np.testing.assert_array_equal(tr.cam_Tcw.numpy()[fixed], np.asarray(prob.cam_Tcw)[fixed])


def test_bundle_adjust_cg_matches_jax():
    cam, prob = _problem(2, n_fixed=2)
    jr = jba.bundle_adjust(prob, cam, solver="cg", cg_iters=40)
    tr = tba.bundle_adjust(_tprob(prob), _tcam(cam), solver="cg", cg_iters=40)
    np.testing.assert_allclose(tr.cam_Tcw.numpy(), np.asarray(jr.cam_Tcw), atol=CG_ATOL)
    np.testing.assert_array_equal(tr.obs_inlier.numpy(), np.asarray(jr.obs_inlier))
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-3)


def test_gate_and_cost_match_jax():
    cam, prob = _problem(3, outlier_frac=0.1, n_fixed=2)
    ja, jc = jba.chi2_active_gate(prob, cam)
    ta, tc = tba.chi2_active_gate(_tprob(prob), _tcam(cam))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-5)
    np.testing.assert_allclose(float(tba._robust_cost(_tprob(prob), _tcam(cam))),
                               float(jba._robust_cost(prob, cam)), rtol=1e-5)


def _chunks(mod, prob, cam, lam, cost, active, splits, robust):
    for n in splits:
        prob, lam, cost = mod.bundle_adjust_partial(prob, cam, lam, cost, active,
                                                    iters=n, robust=robust)
    return prob, lam, cost


def test_partial_chunks_match_whole_and_jax():
    """The loop closer's schedule: 4 robust iterations, the gate, 8 on
    the inliers, on the KITTI-shaped problem (10 cameras, 400 points,
    4 observations each)."""
    jprob, jcam = j_synthetic_ba_problem(10, 400, 4, seed=1)
    jprob = jba.BAProblem(*[jnp.asarray(x) for x in jprob])
    tprob, tcam = _tprob(jprob), _tcam(jcam)
    results = {}
    for name, splits1, splits2 in (("whole", [4], [8]), ("chunked", [2, 2], [4, 4])):
        cost0 = tba._robust_cost(tprob, tcam)
        active = torch.ones_like(tprob.obs_valid)
        p, lam, _ = _chunks(tba, tprob, tcam, torch.tensor(1e-4), cost0, active, splits1, True)
        active, cost = tba.chi2_active_gate(p, tcam)
        results[name] = _chunks(tba, p, tcam, lam, cost, active, splits2, False)
    for a, b in zip(results["whole"][0], results["chunked"][0]):
        assert torch.equal(a, b)
    assert torch.equal(results["whole"][2], results["chunked"][2])

    cost0 = jba._robust_cost(jprob, jcam)
    p, lam, _ = _chunks(jba, jprob, jcam, jnp.asarray(1e-4), cost0,
                        jnp.ones_like(jprob.obs_valid), [2, 2], True)
    active, cost = jba.chi2_active_gate(p, jcam)
    jp, _, jcost = _chunks(jba, p, jcam, lam, cost, active, [4, 4], False)
    tp, _, tcost = results["chunked"]
    np.testing.assert_allclose(tp.cam_Tcw.numpy(), np.asarray(jp.cam_Tcw), atol=CG_ATOL)
    np.testing.assert_allclose(tp.pt_xyz.numpy(), np.asarray(jp.pt_xyz), atol=1e-2)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-3)
    assert float(tcost) < float(tba._robust_cost(tprob, tcam))


def test_synthetic_ba_problem_matches_jax():
    jprob, jcam = j_synthetic_ba_problem(12, 300, 3, seed=4)
    tprob, tcam = synthetic_ba_problem(12, 300, 3, seed=4, device="cpu")
    assert tuple(tcam) == tuple(_tcam(jcam))
    for f in tba.BAProblem._fields:
        np.testing.assert_array_equal(getattr(tprob, f).numpy(), np.asarray(getattr(jprob, f)),
                                      err_msg=f)
