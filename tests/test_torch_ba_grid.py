"""Parity of the port's dense-grid local BA (solvers/ba_grid.py) and
`run_local_ba` with the JAX package.

Tolerances: poses atol 1e-4; 99% of the points within 1e-4 of their
norm and all within 1e-2; chi2 inlier flags, detached links and every
integer field exact; the final cost rtol 1e-3. Float32 sums run in
another order in the two packages through 4 + 6 LM iterations
(measured: poses within 1e-5). A point whose observations are mostly
gross outliers moves by metres within a few iterations, and where it
ends depends on that order: up to 3.1e-3 of its norm, one or two points
in 400; the others within 1e-4.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.engine import local_mapping as jlm
from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu.slam_map import covisibility as jcov
from orb_slam2_test_tpu.solvers import ba_grid as jba
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.engine import local_mapping as tlm
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.geometry.se3 import se3_exp
from orb_slam2_test_tpu_torch.slam_map import covisibility as tcov
from orb_slam2_test_tpu_torch.slam_map import mapstate as tms
from orb_slam2_test_tpu_torch.solvers import ba_grid as tba

from test_torch_insert_parts import jmap, t

torch.set_num_threads(2)

CAM = PinholeCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480, bf=40.0)
JCAM = JCam(**CAM._asdict())


def assert_points_close(a, b, rtol=1e-4, frac=0.99, rtol_all=1e-2):
    """At least `frac` of the points within rtol of their norm, all
    within rtol_all."""
    rel = np.linalg.norm(a - b, axis=-1) / (np.linalg.norm(a, axis=-1) + 1e-6)
    assert (rel <= rtol).mean() >= frac, (rel > rtol).sum()
    assert rel.max() <= rtol_all, rel.max()


def _grid_problem(rng, C=6, Q=64, noise=0.02, stereo=0.5, outliers=0.05, holes=0.3):
    """tests/test_ba_grid.py's problem, with stereo cells, empty cells,
    gross outliers and per-cell levels: C cameras 0.1 m apart, two of
    them fixed."""
    Tcw = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    Tcw[:, 0, 3] = np.linspace(0, 0.5, C)
    X = rng.uniform([-2, -2, 4], [2, 2, 8], (Q, 3)).astype(np.float32)
    obs = np.zeros((Q, C, 3), np.float32)
    for c in range(C):
        pc = X @ Tcw[c, :3, :3].T + Tcw[c, :3, 3]
        obs[:, c, 0] = CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx
        obs[:, c, 1] = CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy
        obs[:, c, 2] = np.where(rng.uniform(size=Q) < stereo,
                                obs[:, c, 0] - CAM.bf / pc[:, 2], -1.0)
    obs[..., :2] += rng.normal(0, 0.3, (Q, C, 2))
    bad = rng.uniform(size=(Q, C)) < outliers
    obs[bad, :2] += rng.uniform(15, 40, (bad.sum(), 2))
    valid = rng.uniform(size=(Q, C)) >= holes
    valid[:, 0] = True
    obs[~valid] = rng.uniform(-1e3, 1e3, ((~valid).sum(), 3))  # garbage
    Tcw0 = Tcw.copy()
    Tcw0[2:, :3, 3] += rng.normal(0, noise, (C - 2, 3)).astype(np.float32)
    X0 = X + rng.normal(0, noise, X.shape).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[:2] = True
    pt_valid = np.ones(Q, bool)
    pt_valid[-3:] = False
    isig2 = (1.0 / 1.44 ** rng.integers(0, 4, (Q, C))).astype(np.float32)
    return (Tcw0, fixed, X0, pt_valid, obs, isig2, valid)


def _both_problems(arrays):
    return (jba.GridBAProblem(*[jnp.asarray(a) for a in arrays]),
            tba.GridBAProblem(*[t(a) for a in arrays]))


@pytest.mark.parametrize("case", ["mono", "stereo_outliers"])
def test_grid_bundle_adjust(rng, case):
    kw = dict(stereo=0.0, outliers=0.0, holes=0.0) if case == "mono" else {}
    jp, tp = _both_problems(_grid_problem(rng, **kw))
    j = jba.grid_bundle_adjust(jp, JCAM, iters1=4, iters2=6)
    got = tba.grid_bundle_adjust(tp, CAM, iters1=4, iters2=6)
    np.testing.assert_allclose(got.cam_Tcw.numpy(), np.asarray(j.cam_Tcw), atol=1e-4)
    assert_points_close(np.asarray(j.pt_xyz), got.pt_xyz.numpy())
    np.testing.assert_array_equal(got.obs_inlier.numpy(), np.asarray(j.obs_inlier))
    np.testing.assert_allclose(float(got.cost), float(j.cost), rtol=1e-3, atol=1e-3)
    # the solve moved the free cameras, and the gate found the outliers
    assert np.abs(got.cam_Tcw.numpy() - tp.cam_Tcw.numpy()).max() > 1e-3
    if case != "mono":
        assert 0 < (~got.obs_inlier.numpy() & tp.obs_valid.numpy()).sum()


def test_grid_step_singular_system(rng):
    """lam = 0 and a free camera with no observation: its Schur block is
    exactly 0, the [6C, 6C] solve is singular, and both packages return
    a zero step instead of non-finite values."""
    arrays = list(_grid_problem(rng, stereo=0.0, outliers=0.0))
    arrays[6] = arrays[6].copy()
    arrays[6][:, 3] = False  # camera 3 is free and observes nothing
    jp, tp = _both_problems(arrays)
    jdxc, jdxp = jba._grid_step(jp, JCAM, jp.cam_Tcw, jp.pt_xyz, jnp.float32(0.0), True,
                                jnp.ones_like(jp.obs_valid))
    dxc, dxp = tba._grid_step(tp, CAM, tp.cam_Tcw, tp.pt_xyz, torch.tensor(0.0), True,
                              torch.ones_like(tp.obs_valid))
    np.testing.assert_array_equal(dxc.numpy(), np.asarray(jdxc))
    np.testing.assert_array_equal(dxc.numpy(), 0.0)
    np.testing.assert_allclose(dxp.numpy(), np.asarray(jdxp), atol=1e-4)


# ---------------------------------------------------------------------------
# run_local_ba on a map
# ---------------------------------------------------------------------------

BA_CFG = dict(max_keyframes=16, max_features=256, max_points=1024)


def _ba_map(seed, n_kf=9, n_pts=400):
    """Keyframes 0.15 m apart along x observing a cloud of points at
    4-12 m (each seen by 90% of the keyframes that frame it; 0.5 px
    noise, stereo where depth < 10 m, 3% gross outliers),
    poses and points perturbed except keyframe 0; links in random
    feature order, no duplicate within a row."""
    rng = np.random.default_rng(seed)
    cap = tms.MapCapacity(**BA_CFG)
    K, N, P = cap.max_keyframes, cap.max_features, cap.max_points
    m = entry.map_to_numpy(tms.make_empty_map(cap))
    X = rng.uniform([-3, -2, 4], [3, 2, 12], (n_pts, 3)).astype(np.float32)
    for k in range(n_kf):
        T = se3_exp(torch.tensor([0.15 * k, 0.0, 0.0, 0.0, 0.02 * k, 0.0])).numpy()
        pc = X @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                       CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], 1)
        inside = (uv[:, 0] > 0) & (uv[:, 0] < 640) & (uv[:, 1] > 0) & (uv[:, 1] < 480)
        pts = rng.permutation(np.flatnonzero(inside & (rng.uniform(size=n_pts) < 0.9)))[:N]
        n = pts.size
        lvl = rng.integers(0, 4, n)
        m["kf_uv"][k, :n] = uv[pts] + rng.normal(0, 0.5, (n, 2)) * 1.2 ** lvl[:, None]
        m["kf_uv"][k, :n][rng.uniform(size=n) < 0.03] += 30.0
        m["kf_ur"][k, :n] = np.where(pc[pts, 2] < 10, m["kf_uv"][k, :n, 0] - CAM.bf / pc[pts, 2], -1)
        m["kf_level"][k, :n] = lvl
        m["kf_kp_valid"][k, :n] = True
        m["kf_pt_idx"][k, :n] = pts
        noise = np.zeros(6) if k == 0 else rng.normal(0, [0.02, 0.02, 0.02, 0.003, 0.003, 0.003])
        m["kf_Tcw"][k] = (se3_exp(torch.tensor(noise, dtype=torch.float32)).numpy() @ T)
        m["kf_valid"][k] = True
        m["kf_frame_id"][k] = k
    m["pt_xyz"][:n_pts] = X + rng.normal(0, 0.05, X.shape)
    m["pt_valid"][:n_pts] = True
    m["n_kf"], m["n_pt"] = np.int32(n_kf), np.int32(n_pts)
    return m, cap


@pytest.mark.parametrize("seed, kf, bitmap, covis", [
    (0, 8, True, True), (1, 8, False, True), (2, 5, True, False), (3, 4, False, False)])
def test_run_local_ba(seed, kf, bitmap, covis):
    """Both JAX branches (observer bitmap or the [K, N] link scan), with
    and without a precomputed covisibility row; the point budget (256)
    is below the window's points, so the relevance selection cuts."""
    arrays, cap = _ba_map(seed)
    jm, tm = jmap(arrays), entry.map_from_numpy(arrays, "cpu")
    caps = tlm.LocalBACaps(n_local=4, n_fixed=3, n_points=256)
    jcaps = jlm.LocalBACaps(**dataclasses.asdict(caps))
    jkw, tkw = {}, {}
    if bitmap:
        jkw["obs_bm"] = jcov.build_observer_bitmap(jm)
        tkw["obs_bm"] = tcov.build_observer_bitmap(tm)
    if covis:
        jkw["covis_row"] = jcov.covis_row_from_bitmap(jm, jcov.build_observer_bitmap(jm), jnp.asarray(kf))
        tkw["covis_row"] = tcov.covis_row_from_bitmap(tm, tcov.build_observer_bitmap(tm), torch.tensor(kf))
    jcap = jlm.MapCapacity(**dataclasses.asdict(cap))
    j = jlm.run_local_ba(jm, JCAM, jnp.asarray(kf, jnp.int32), jcap, jcaps, **jkw)
    got = tlm.run_local_ba(tm, CAM, torch.tensor(kf, dtype=torch.int32), cap, caps, **tkw)
    b = entry.map_to_numpy(got)
    np.testing.assert_allclose(b["kf_Tcw"], np.asarray(j.kf_Tcw), atol=1e-4)
    assert_points_close(np.asarray(j.pt_xyz), b["pt_xyz"])
    np.testing.assert_array_equal(b["kf_pt_idx"], np.asarray(j.kf_pt_idx))
    for name in tms.MapState._fields:
        if name not in ("kf_Tcw", "pt_xyz", "kf_pt_idx"):
            np.testing.assert_array_equal(b[name], arrays[name], err_msg=name)
    moved = np.abs(b["kf_Tcw"] - arrays["kf_Tcw"]).max((1, 2)) > 1e-4
    assert moved.sum() >= 3 and not moved[0]  # slot 0 is the gauge
    detached = (arrays["kf_pt_idx"] >= 0) & (b["kf_pt_idx"] < 0)
    assert detached.sum() > 0
