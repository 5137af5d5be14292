"""Parity of `_grow_map_device` with the JAX package for the other
sensors and the map-full backstop, at 640x480 / 1000 features and a map
of K = 32, P = 4096 (20 and 3000 live):

- mono: no depth points (use_depth False), a full insert;
- RGB-D: depth points through the close gate at TUM1's bf 40 (close
  depth 2.7 m: the scene's nearest bands lie inside it), a light insert;
- the backstop: with every keyframe slot live the insert changes
  nothing, returns kf = -1, and gives back the map it was given; the
  bitmap is the input one (light) or rebuilt from the unchanged map
  (full).

Tolerances as in tests/test_torch_grow_map.py.
"""

import numpy as np
import pytest
import torch

from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.engine import tracking as ttracking
from orb_slam2_test_tpu_torch.slam_map.covisibility import build_observer_bitmap

from test_torch_grow_map import _jax_grow, assert_insert_close, assert_map_invariants, jax_inputs

torch.set_num_threads(2)

CFG = ttracking.TrackerConfig(n_features=1000, max_keyframes=32, max_points=4096)


def _tracked(sensor, cam, seed):
    """(scene, map, bitmap, view 1's frame and tracking outputs)."""
    sc = entry.insert_scene(np.random.default_rng(seed), sensor, cam, CFG, 20, 3000, "cpu")
    m0 = entry.map_from_numpy(sc.map, "cpu")
    bm0 = build_observer_bitmap(m0)
    f1, o1 = entry.track_insert_view(
        sc, 1, m0, bm0, entry.frame_from_numpy(sc.last_frame, "cpu"),
        torch.from_numpy(sc.last_feat_pt), torch.tensor(0, dtype=torch.int32),
        cam=cam, cfg=CFG, sensor=sensor)
    assert np.abs(o1[5].numpy() - sc.T_true[1])[:3, 3].max() < 1e-2
    return sc, m0, bm0, f1, o1


@pytest.mark.parametrize("sensor, rebuild", [("mono", True), ("rgbd", False)])
def test_grow_map_sensor(sensor, rebuild):
    cam = entry.CAM if sensor == "mono" else entry.RGBD_CAM
    sc, m0, bm0, f1, o1 = _tracked(sensor, cam, 5)
    use_depth = sensor != "mono"
    copies = [x.clone() for x in m0]
    got = ttracking._grow_map_device(
        cam, CFG, m0, bm0, f1, o1[5], o1[7], 1.0, 1, sc.close_depth, use_depth, use_depth,
        rebuild=rebuild)
    jout = _jax_grow(jax_inputs(m0, bm0, f1, o1[5], o1[7], 1.0, 1), sc.close_depth,
                     rebuild, cam=cam, cfg=CFG, use_depth=use_depth)
    assert_insert_close(jout, got)
    assert_map_invariants(got)
    # new points: triangulated, and (RGB-D) from depth
    assert int(got[1]) == 20 and int(got[3]) - int(m0.n_pt) > 50
    for a, b in zip(m0, copies):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rebuild", [True, False])
def test_grow_map_full_map_backstop(rebuild):
    sc, m0, bm0, f1, o1 = _tracked("mono", entry.CAM, 6)
    full = m0._replace(kf_valid=torch.ones_like(m0.kf_valid),
                       n_kf=torch.tensor(CFG.max_keyframes, dtype=torch.int32))
    got = ttracking._grow_map_device(
        entry.CAM, CFG, full, bm0, f1, o1[5], o1[7], 1.0, 1, sc.close_depth, False, False,
        rebuild=rebuild)
    jout = _jax_grow(jax_inputs(full, bm0, f1, o1[5], o1[7], 1.0, 1), sc.close_depth,
                     rebuild, cam=entry.CAM, cfg=CFG, use_depth=False)
    assert_insert_close(jout, got)
    assert int(got[1]) == -1 and int(got[2]) == -1
    for a, b in zip(got[0], full):
        assert torch.equal(a, b)
    bm = build_observer_bitmap(full) if rebuild else bm0
    assert torch.equal(got[4], bm)
