"""The port's joint multi-sequence BA (parallel/multi_map.py) against the
JAX package's, on the CPU: the cases of tests/test_multi_map.py.

The maps are built by the JAX test's helper (`_make_seq_map`: 4
monocular keyframes observing 48 private points, poses and points
perturbed) and carried across with `entry.map_from_numpy`.

- `compact_problem` (with and without max_cams; the monocular gauge
  fixes two keyframes) and `merge_problems` (two calibrations, per-camera
  [C] intrinsics): every field equal to the JAX package's.
- `joint_bundle_adjust` on a 4-shard mesh against JAX's on a 4-device
  mesh: poses atol 1e-4 (measured 1.3e-6 and 3.7e-5), points within
  1e-2 (measured 7.5e-5 and 1.3e-3: a monocular point's depth along its
  rays is ill-conditioned in float32, as in tests/test_torch_ba_core.py),
  cost rtol 1e-4 (measured 4.9e-7); info's keys equal.
- Block-diagonal exactness: the joint solve of two maps against each
  map's own `dist_bundle_adjust` of its `compact_problem`, poses atol
  5e-4, the 8-vs-1-shard bound of tests/test_dist_ba.py (measured
  1.7e-6 and 4.7e-5): the reduced camera system is block-diagonal, so
  only the joint LM's shared damping and accept decisions and the cost's
  float32 sum couple them.
- The joint BA on two gloo ranks (`multihost.initialize_from_env`, the
  points gathered by one all-gather) equal to the 2-shard one-process
  run.
- Tiny maps pass through by identity; `measure_scaling`'s keys.
- Two port Systems track their sequences round-robin and a joint BA
  runs mid-stream: both still OK afterwards.
- A joint BA while a loop's global BA is pending: the JAX package's
  apply after the last chunk writes the snapshot's optimized poses and
  points over every covered keyframe and point, so the joint BA's moves
  are lost: the map comes out equal to the global BA alone. The port's
  `cli.run_multi_seq` runs the pending global BA to its end first.
"""

import argparse
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from orb_slam2_test_tpu.engine.loop_closing import LoopCloser as JLoopCloser
from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu.parallel import multi_map as jmm
from orb_slam2_test_tpu.parallel.dist_ba import make_ba_mesh as j_mesh
from orb_slam2_test_tpu_torch import cli, entry
from orb_slam2_test_tpu_torch.engine.loop_closing import LoopCloser
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.io.settings import SlamSettings
from orb_slam2_test_tpu_torch.parallel import dist_ba as td
from orb_slam2_test_tpu_torch.parallel import multi_map as tmm
from orb_slam2_test_tpu_torch.solvers.ba_core import BAProblem
from orb_slam2_test_tpu_torch.system import MONOCULAR, System

from test_multi_map import N_KF, _make_seq_map

torch.set_num_threads(2)

CAM_A = dict(fx=520.0, fy=520.0, cx=320.0, cy=240.0)
CAM_B = dict(fx=710.0, fy=705.0, cx=300.0, cy=230.0)


@pytest.fixture(scope="module")
def maps():
    """Two sequences' maps: JAX MapStates, the port's, their cameras and
    true poses."""
    rng = np.random.default_rng(0)
    out = []
    for cam, shift in ((CAM_A, 0.0), (CAM_B, 1.5)):
        jcam = JCam(**cam)
        jm, T_true, _ = _make_seq_map(rng, jcam, shift=shift)
        out.append((jm, entry.map_from_numpy(jm, "cpu"), jcam, PinholeCamera(**cam), T_true))
    return out


def _assert_problem_equal(t: BAProblem, j):
    for f, a, b in zip(BAProblem._fields, j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)


@pytest.mark.parametrize("max_cams", [None, 2])
def test_compact_problem_matches_jax(maps, max_cams):
    jm, tm = maps[0][:2]
    j = jmm.compact_problem(jm, max_cams=max_cams)
    t = tmm.compact_problem(tm, max_cams=max_cams)
    _assert_problem_equal(t.prob, j.prob)
    np.testing.assert_array_equal(t.kf_ids, j.kf_ids)
    np.testing.assert_array_equal(t.pt_ids, j.pt_ids)
    fixed = t.prob.cam_fixed.numpy()
    if max_cams is None:  # the monocular gauge: the two oldest keyframes
        assert fixed.tolist() == [True, True, False, False]
    else:
        assert fixed[: N_KF - 2].all() and not fixed[N_KF - 2 :].any()


def test_merge_problems_matches_jax(maps):
    jparts = [jmm.compact_problem(m[0]) for m in maps]
    tparts = [tmm.compact_problem(m[1]) for m in maps]
    j = jmm.merge_problems(jparts, [m[2] for m in maps])
    t = tmm.merge_problems(tparts, [m[3] for m in maps])
    _assert_problem_equal(t.prob, j.prob)
    for k in ("fx", "fy", "cx", "cy", "bf"):
        np.testing.assert_array_equal(getattr(t.cam, k).numpy(), np.asarray(getattr(j.cam, k)))
    assert (t.cam_offsets, t.pt_offsets) == (j.cam_offsets, j.pt_offsets)


@pytest.fixture(scope="module")
def joint_runs(maps):
    j_new, j_info = jmm.joint_bundle_adjust([m[0] for m in maps], [m[2] for m in maps],
                                            j_mesh(4), iters=10)
    t_new, t_info = tmm.joint_bundle_adjust([m[1] for m in maps], [m[3] for m in maps],
                                            td.make_ba_mesh(4, "cpu"), iters=10)
    return j_new, j_info, t_new, t_info


def test_joint_bundle_adjust_matches_jax(maps, joint_runs):
    j_new, j_info, t_new, t_info = joint_runs
    assert set(t_info) == set(j_info)
    assert {k: t_info[k] for k in ("n_cams", "n_pts", "n_obs", "n_devices")} == \
        {k: j_info[k] for k in ("n_cams", "n_pts", "n_obs", "n_devices")}
    np.testing.assert_allclose(t_info["cost"], j_info["cost"], rtol=1e-4)
    for jm, tm in zip(j_new, t_new):
        np.testing.assert_allclose(tm.kf_Tcw.numpy(), np.asarray(jm.kf_Tcw), atol=1e-4)
        live = np.asarray(jm.pt_valid)
        np.testing.assert_allclose(tm.pt_xyz.numpy()[live], np.asarray(jm.pt_xyz)[live],
                                   atol=1e-2)
    # the input maps are unchanged
    for (jm, tm, *_), new in zip(maps, t_new):
        assert new is not tm
        np.testing.assert_array_equal(tm.kf_Tcw.numpy(), np.asarray(jm.kf_Tcw))


def test_joint_matches_independent_solves(maps, joint_runs):
    """Block-diagonal exactness: each sequence's joint result against its
    own solve on the same mesh."""
    t_new = joint_runs[2]
    mesh = td.make_ba_mesh(4, "cpu")
    for (_, tm, _, tcam, _), joint in zip(maps, t_new):
        part = tmm.compact_problem(tm)
        Tcw, _, _ = td.dist_bundle_adjust(td.shard_problem(part.prob, 4), tcam, mesh, iters=10)
        solo = Tcw.numpy()
        got = joint.kf_Tcw.numpy()[part.kf_ids]
        np.testing.assert_allclose(got, solo, atol=5e-4)


RANK_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {root!r})
    from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_test_tpu_torch.io.checkpoint import load_map
    from orb_slam2_test_tpu_torch.parallel import multi_map, multihost

    assert multihost.initialize_from_env(device="cpu")
    mesh = multihost.global_ba_mesh("cpu")
    maps = [load_map({d!r} + f"/map{{i}}.npz", "cpu")[0] for i in range(2)]
    cams = [PinholeCamera(**{cam_a!r}), PinholeCamera(**{cam_b!r})]
    new, info = multi_map.joint_bundle_adjust(maps, cams, mesh, iters=10)
    np.savez({d!r} + f"/rank{{mesh.rank}}.npz", cost=info["cost"], size=info["n_devices"],
             **{{f"T{{i}}": m.kf_Tcw.numpy() for i, m in enumerate(new)}},
             **{{f"X{{i}}": m.pt_xyz.numpy() for i, m in enumerate(new)}})
""")


def test_joint_ba_on_two_gloo_ranks(maps, tmp_path):
    from orb_slam2_test_tpu_torch.io.checkpoint import save_map
    from orb_slam2_test_tpu_torch.slam_map.mapstate import MapCapacity

    d = str(tmp_path)
    for i, m in enumerate(maps):
        cap = MapCapacity(max_keyframes=m[1].kf_valid.shape[0], max_features=m[1].kf_uv.shape[1],
                          max_points=m[1].pt_valid.shape[0])
        save_map(os.path.join(d, f"map{i}.npz"), m[1], cap)
    script = tmp_path / "worker.py"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script.write_text(RANK_WORKER.format(root=root, d=d, cam_a=CAM_A, cam_b=CAM_B))
    with __import__("socket").socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, str(script)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE,
                              env=dict(os.environ, SLAM_COORDINATOR=f"127.0.0.1:{port}",
                                       SLAM_NUM_PROCS="2", SLAM_PROC_ID=str(r)))
             for r in range(2)]
    results = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=120)
            results.append((p.returncode, se.decode()))
    finally:
        for p in procs:
            p.kill()
    for rc, se in results:
        assert rc == 0, se[-3000:]
    one, info = tmm.joint_bundle_adjust([m[1] for m in maps], [m[3] for m in maps],
                                        td.make_ba_mesh(2, "cpu"), iters=10)
    for r in range(2):
        z = np.load(os.path.join(d, f"rank{r}.npz"))
        assert int(z["size"]) == 2 and float(z["cost"]) == info["cost"]
        for i, m in enumerate(one):
            np.testing.assert_array_equal(z[f"T{i}"], m.kf_Tcw.numpy())
            np.testing.assert_array_equal(z[f"X{i}"], m.pt_xyz.numpy())


def test_tiny_maps_pass_through():
    from orb_slam2_test_tpu_torch.slam_map.mapstate import MapCapacity, make_empty_map

    m = make_empty_map(MapCapacity(max_keyframes=8, max_features=48, max_points=96), "cpu")
    assert tmm.compact_problem(m) is None
    new, info = tmm.joint_bundle_adjust([m], [PinholeCamera(**CAM_A)],
                                        td.make_ba_mesh(2, "cpu"))
    assert info["n_cams"] == 0 and new[0] is m


def test_measure_scaling_keys(maps):
    rep = tmm.measure_scaling([maps[0][1]], [maps[0][3]], iters=2, device_counts=[1, 2],
                              repeats=1)
    assert rep["metric"] == "dist_ba_strong_scaling"
    for k in ("solve_s", "efficiency", "shard_solve_s", "partition_efficiency", "cpu_s",
              "work_efficiency"):
        assert set(rep[k]) == {"1", "2"}, k
    assert rep["efficiency"]["1"] == 1.0 and rep["host_cores"] >= 1


def test_concurrent_systems_with_joint_ba():
    """The multi_seq loop's core: two port Systems track their own
    synthetic sequences round-robin (the JAX test's scenes, seeds 0 and
    4); a joint BA runs mid-stream and both keep tracking."""
    from orb_slam2_test_tpu_torch.utils.synthetic import default_camera, make_sequence

    n_frames, split = 10, 7
    overrides = dict(ba_fixed_cap=4, n_triangulate_neighbors=2, min_init_matches=40,
                     min_init_triangulated=30, max_frames_between_kf=4, min_local_inliers=20)
    systems, seqs = [], []
    for seed in (0, 4):
        cam, _, _, images = make_sequence(
            np.random.default_rng(seed), n_frames, cam=default_camera(320, 240),
            n_landmarks=160, step=np.array([0.12, 0.01, 0.0, 0.001, 0.003, 0.001]))
        settings = SlamSettings(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width,
                                height=cam.height, n_features=400, max_keyframes=32,
                                max_points=4096, local_kf_cap=8, ba_pt_cap=1024, fps=10.0)
        systems.append(System(settings, MONOCULAR, device="cpu", **overrides))
        seqs.append(images)
    for i in range(split):
        for s, images in zip(systems, seqs):
            s.track_monocular(images[i], 0.1 * i)
    assert all(s.tracking_state == "OK" for s in systems)
    new_maps, info = tmm.joint_bundle_adjust(
        [s.tracker.map for s in systems], [s.tracker.cam for s in systems],
        td.make_ba_mesh(8, "cpu"), iters=6, scale_factor=systems[0].tracker.cfg.scale_factor)
    assert info["n_devices"] == 8 and info["n_cams"] >= 4 and np.isfinite(info["cost"])
    for s, m in zip(systems, new_maps):
        s.tracker.map = m
        s.tracker.velocity = None
        s.tracker._ref_Tcw_host = None
    for i in range(split, n_frames):
        for s, images in zip(systems, seqs):
            s.track_monocular(images[i], 0.1 * i)
    assert all(s.tracking_state == "OK" for s in systems)
    assert all(s.tracker.stats["lost_frames"] == 0 for s in systems)


class _StubVocabulary:
    """Enough of a vocabulary for a LoopCloser that only runs its global BA."""

    word_weight = np.ones(4, np.float32)

    def on(self, device):
        return self


def _run_gba(closer, m):
    done = False
    while not done:
        m, done = closer.advance_global_ba(m)
    return m


def test_pending_global_ba_undoes_a_jax_joint_ba(maps):
    """The JAX package: a loop's global BA is pending (its snapshot
    taken) when the multi-sequence example replaces the tracker's map by
    the joint BA's; the apply after the last chunk writes the snapshot's
    optimized values over every covered keyframe and point."""
    jm, _, jcam = maps[0][:3]
    alone = JLoopCloser(jcam, _StubVocabulary())
    alone._start_global_ba(jm)
    m_alone = _run_gba(alone, jm)

    closer = JLoopCloser(jcam, _StubVocabulary())
    closer._start_global_ba(jm)
    (m_joint,), info = jmm.joint_bundle_adjust([jm], [jcam], j_mesh(1), iters=6)
    moved = np.abs(np.asarray(m_joint.kf_Tcw) - np.asarray(jm.kf_Tcw)).max()
    assert info["n_cams"] == N_KF and moved > 1e-4
    m_after = _run_gba(closer, m_joint)
    # the joint BA's moves are gone: the result is the global BA alone
    np.testing.assert_array_equal(np.asarray(m_after.kf_Tcw), np.asarray(m_alone.kf_Tcw))
    np.testing.assert_array_equal(np.asarray(m_after.pt_xyz), np.asarray(m_alone.pt_xyz))


def test_multi_seq_drains_a_pending_global_ba(maps, tmp_path):
    """The port's `cli.run_multi_seq` runs a pending global BA to its end
    before the joint BA, so the joint BA refines the global BA's result."""
    _, tm, _, tcam, _ = maps[0]
    settings = SlamSettings(fx=tcam.fx, fy=tcam.fy, cx=tcam.cx, cy=tcam.cy, n_features=48,
                            max_keyframes=8, max_points=96)
    system = System(settings, MONOCULAR, device="cpu")
    system.tracker.map = tm
    system.tracker.loop_closer = LoopCloser(tcam, _StubVocabulary(), device="cpu")
    system.tracker.loop_closer._start_global_ba(tm)

    ref = LoopCloser(tcam, _StubVocabulary(), device="cpu")
    ref._start_global_ba(tm)
    (expected,), _ = tmm.joint_bundle_adjust([_run_gba(ref, tm)], [tcam],
                                             td.make_ba_mesh(1, "cpu"), iters=6)
    args = argparse.Namespace(devices=None, device="cpu", max_frames=None, joint_ba_every=200,
                              joint_ba_iters=6, max_cams=256,
                              traj_prefix=str(tmp_path / "traj"), kitti_traj=False)
    summary = cli.run_multi_seq([system], [[]], args, log=lambda *a: None)
    assert not system.tracker.loop_closer.gba_running()
    assert summary["joint_ba"][0]["n_cams"] == N_KF
    np.testing.assert_array_equal(system.tracker.map.kf_Tcw.numpy(), expected.kf_Tcw.numpy())
    np.testing.assert_array_equal(system.tracker.map.pt_xyz.numpy(), expected.pt_xyz.numpy())
