"""The port against the JAX package at the capacities the card runs, on
the CPU: `entry.KITTI_CFG` unchanged (K = 384 keyframes, P = 131,072
points, 2000 features, local_pt_cap = ba_pt_cap = 8192), filled as
chip_smoke.py's phases fill it. The other parity files hold the same
programs at cut capacities (tests/test_torch_tracking.py at K = 48,
tests/test_torch_grow_map.py at K = 64); the loop correction and the
global BA at full capacity are tests/test_torch_full_capacity_loop.py.

- The KITTI frame ([6]'s scene: 200 keyframes and 110,000 points live)
  through `entry.track_frame_step` against the JAX package's
  `build_frame_stereo` then `_track_frame_device`: keypoints equal, the
  17 outputs within tests/test_torch_tracking.py's tolerances (poses
  1e-4; measured 1.03e-6), the pose within 1 cm of the truth. The
  local-map compaction cuts: 45,182 usable points compete for the 8192
  slots of local_pt_cap.
- The inserts ([10]'s sequence: track view 1, full insert, track view
  2, light insert) against the JAX package's `_grow_map_device` on each
  insert's inputs, with tests/test_torch_grow_map.py's tolerances
  (poses 1e-4 full, 2e-3 light; measured 1.73e-6 / 9.64e-4). At this
  fill ba_pt_cap does not bind: the two local BAs have 1,441 and 1,459
  candidate points for its 8192 slots.
- The host Tracker: the first 5 frames of
  `entry.kitti_sequence` through `entry.kitti_system("cpu")` and the JAX
  System from an empty map, async backend off: states and keyframe ids
  equal, poses within [12]'s 1e-3 (measured 5.05e-5).
"""

import dataclasses

import numpy as np
import pytest
import torch

from orb_slam2_test_tpu.engine import frame as jframe_mod
from orb_slam2_test_tpu.engine import tracking as jtracking
from orb_slam2_test_tpu.io import settings as jsettings
from orb_slam2_test_tpu.system import System as JSystem
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.engine import local_mapping as tlocal_mapping
from orb_slam2_test_tpu_torch.engine import matchers as tmatchers
from orb_slam2_test_tpu_torch.slam_map.covisibility import build_observer_bitmap

from test_torch_grow_map import _jax_grow, assert_insert_close, assert_map_invariants, jax_inputs
from test_torch_tracker import keyframe_ids
from test_torch_tracking import _assert_outputs_close, _assert_tracks, _jax, _jax_inputs

torch.set_num_threads(2)

CFG = entry.KITTI_CFG


def _candidates(module, cap: int, seen: list):
    """`module.top_k_stable` recording, for each call that keeps `cap`
    entries, how many entries compete (score > 0): the usable points
    before a compaction to `cap`."""
    top_k = module.top_k_stable

    def recorded(x, k):
        if k == cap:
            seen.append(int((x > 0).sum()))
        return top_k(x, k)
    return recorded


# ---------------------------------------------------------------------------
# A KITTI frame
# ---------------------------------------------------------------------------


def test_track_frame_step_full_capacity(monkeypatch):
    """One stereo frame at K = 384, P = 131,072 against the body of the
    JAX package's _build_and_track_device(sensor="stereo")."""
    scene = entry.kitti_scene(np.random.default_rng(1), "cpu", CFG, 200, 110_000)
    args = entry.scene_inputs(scene, "cpu")
    usable = []
    monkeypatch.setattr(tmatchers, "top_k_stable",
                        _candidates(tmatchers, CFG.local_pt_cap, usable))
    tframe, touts = entry.track_frame_step(*args, cfg=CFG)
    jcam, jcfg = _jax(entry.KITTI_CAM, CFG)
    jargs = _jax_inputs(scene, entry.KITTI_CAM, CFG)
    jframe = jframe_mod.build_frame_stereo(jargs[2], jargs[3], 0.0, jcam,
                                           n_features=CFG.n_features)
    jouts = jtracking._track_frame_device(jcam, jcfg, jargs[0], jargs[1], jframe, *jargs[5:])
    np.testing.assert_array_equal(tframe.uv.numpy(), np.asarray(jframe.uv))
    _assert_outputs_close(jouts, touts)
    _assert_tracks(touts, scene, 0.8)
    gap = max(float(np.abs(np.asarray(jouts[i]) - touts[i].numpy()).max()) for i in (2, 5))
    print(f"full-capacity KITTI frame: poses within {gap:.3e} of the JAX package's; "
          f"usable local-map points {usable} for local_pt_cap {CFG.local_pt_cap}")
    # the local-map search compacted its candidates: more usable points
    # than local_pt_cap
    assert usable and max(usable) > CFG.local_pt_cap


# ---------------------------------------------------------------------------
# A full and a light insert
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kitti_inserts():
    """tests/test_torch_grow_map.py's kitti_run at KITTI_CFG and [10]'s
    fill, with the local BAs' candidate point counts."""
    sc = entry.kitti_insert_scene(np.random.default_rng(1), "cpu", CFG, 200, 110_000)
    m0 = entry.map_from_numpy(sc.map, "cpu")
    bm0 = build_observer_bitmap(m0)
    f1, o1 = entry.track_insert_view(
        sc, 1, m0, bm0, entry.frame_from_numpy(sc.last_frame, "cpu"),
        torch.from_numpy(sc.last_feat_pt), torch.tensor(0, dtype=torch.int32), cfg=CFG)
    ba_points = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlocal_mapping, "top_k_stable",
                   _candidates(tlocal_mapping, CFG.ba_pt_cap, ba_points))
        g1 = entry.grow_map_step(m0, bm0, f1, o1[5], o1[7], 1.0, 1, sc.close_depth, True,
                                 cfg=CFG)
        f2, o2 = entry.track_insert_view(sc, 2, g1[0], g1[4], f1, o1[7], g1[1], cfg=CFG)
        g2 = entry.grow_map_step(g1[0], g1[4], f2, o2[5], o2[7], 2.0, 2, sc.close_depth,
                                 False, cfg=CFG)
    return dict(sc=sc, m0=m0, bm0=bm0, f1=f1, o1=o1, g1=g1, f2=f2, o2=o2, g2=g2,
                ba_points=ba_points)


def test_grow_map_full_insert_full_capacity(kitti_inserts):
    r = kitti_inserts
    jout = _jax_grow(jax_inputs(r["m0"], r["bm0"], r["f1"], r["o1"][5], r["o1"][7], 1.0, 1),
                     r["sc"].close_depth, True, cfg=CFG)
    assert_insert_close(jout, r["g1"])
    assert_map_invariants(r["g1"])
    assert int(r["g1"][1]) == 200 and int(r["g1"][3]) - int(r["m0"].n_pt) > 150
    print("full insert: poses within %.3e of the JAX package's" % float(np.abs(
        np.asarray(jout[0].kf_Tcw) - r["g1"][0].kf_Tcw.numpy()).max()))


def test_grow_map_light_insert_full_capacity(kitti_inserts):
    r = kitti_inserts
    g1 = r["g1"]
    jout = _jax_grow(jax_inputs(g1[0], g1[4], r["f2"], r["o2"][5], r["o2"][7], 2.0, 2),
                     r["sc"].close_depth, False, cfg=CFG)
    assert_insert_close(jout, r["g2"], pose_atol=2e-3)
    assert_map_invariants(r["g2"])
    assert int(r["g2"][1]) == 201
    print("light insert: poses within %.3e of the JAX package's" % float(np.abs(
        np.asarray(jout[0].kf_Tcw) - r["g2"][0].kf_Tcw.numpy()).max()))


def test_insert_views_and_local_ba_points(kitti_inserts):
    """Both tracked views within 1 cm of the truth. The local BAs'
    candidate points at this fill: fewer than ba_pt_cap, so the cap
    does not bind here (the frame's local-map search is where a cap of
    8192 cuts)."""
    r = kitti_inserts
    print(f"local BA candidate points {r['ba_points']} for ba_pt_cap {CFG.ba_pt_cap}")
    assert len(r["ba_points"]) == 2 and 0 < max(r["ba_points"]) <= CFG.ba_pt_cap
    for o, T in ((r["o1"], r["sc"].T_true[1]), (r["o2"], r["sc"].T_true[2])):
        assert np.abs(o[5].numpy() - T)[:3, 3].max() < 1e-2


# ---------------------------------------------------------------------------
# The host Tracker from an empty map
# ---------------------------------------------------------------------------

N_FRAMES = 5
SEQ_POSE_ATOL = 1e-3  # [12]'s bound between the card and the CPU port
SEQ_TRUTH_M = 5e-2  # [12]'s ATE ceiling


def test_kitti_system_full_capacity_matches_jax():
    """[12]'s first frames through both packages' System at KITTI_CFG,
    the port on the CPU."""
    seq = entry.kitti_sequence(np.random.default_rng(0), N_FRAMES, "cpu")
    tsys = entry.kitti_system("cpu", async_backend=False)
    jsys = JSystem(jsettings.SlamSettings(**dataclasses.asdict(tsys.settings)), "stereo",
                   vocabulary=None, async_backend=False)
    assert (tsys.tracker.cfg.max_keyframes, tsys.tracker.cfg.max_points) == (384, 131072)
    assert dataclasses.asdict(jsys.tracker.cfg) == dataclasses.asdict(tsys.tracker.cfg)
    gap = 0.0
    for t, left, right in seq.frames:
        jT = jsys.track_stereo(left.numpy(), right.numpy(), t)
        tT = entry.sequence_step(tsys, (t, left, right))
        assert tsys.tracking_state == jsys.tracking_state == "OK"
        gap = max(gap, float(np.abs(np.asarray(tT) - np.asarray(jT)).max()))
    err = {name: max(float(np.abs(T - seq.T_true[i])[:3, 3].max())
                     for i, (_, T) in enumerate(s.tracker.export_trajectory()))
           for name, s in (("port", tsys), ("jax", jsys))}
    print(f"KITTI System, {N_FRAMES} frames at K = 384, P = 131,072: poses within {gap:.3e} "
          f"of the JAX System's; keyframes {keyframe_ids(tsys.tracker.map)}; largest "
          f"distance from the truth {err}")
    assert gap <= SEQ_POSE_ATOL
    assert tsys.tracker.stats == jsys.tracker.stats
    assert keyframe_ids(tsys.tracker.map) == keyframe_ids(jsys.tracker.map)
    assert len(tsys.tracker.export_trajectory()) == N_FRAMES and err["port"] < SEQ_TRUTH_M
