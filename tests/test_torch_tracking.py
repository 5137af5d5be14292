"""Parity of the port's per-frame tracking program with the JAX package.

A seeded `entry.tracking_scene` (a texture seen from T_true, a bench map
whose first point slots and keyframe 0 observe it, a last frame that
links every second scene point) goes through the JAX package's
`_track_frame_device` / `_build_and_track_device` and the port's.

Tolerances, for all 17 outputs:
- poses (Tcw_m, Tcw, ref_Tcw, pred): atol 1e-4 (float32 sums in another
  order through 2 x 40 Gauss-Newton iterations; measured <= 1.7e-6 on
  the same frame);
- counts (matches, inliers, votes, close counts): within 1% of the JAX
  count (measured: equal);
- per-feature links and per-point visibility: equal on >= 99% of the
  entries (measured: equal);
- vote_kf: equal.
On the same frame (`_track_frame_device`) the inputs are identical; in
`_build_and_track_device` each package builds its own frame, and the
frames differ by the float-order gaps of tests/test_torch_frontend.py
and tests/test_torch_stereo.py.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.engine import frame as jframe_mod
from orb_slam2_test_tpu.engine import tracking as jtracking
from orb_slam2_test_tpu.engine.frame import FrameData as JFrame
from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu.slam_map import mapstate as jms
from orb_slam2_test_tpu.slam_map.covisibility import build_observer_bitmap as jbitmap
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.engine import tracking as ttracking

from test_torch_stereo import check_build_frame_stereo

torch.set_num_threads(2)

NAMES = (
    "n_matches_m", "n_inliers_m", "Tcw_m", "vote_w", "vote_kf", "Tcw",
    "n_inliers", "feat_pt", "vis", "ref_Tcw", "n_close_tracked",
    "n_close_untracked", "pred", "feat_m", "n_map_m", "n_close_tracked_m",
    "n_close_untracked_m",
)
POSES = {"Tcw_m", "Tcw", "ref_Tcw", "pred"}
ARRAYS = {"feat_pt", "vis", "feat_m"}


def _jax_inputs(scene, cam, cfg):
    """The scene as the JAX package's arguments of _build_and_track_device
    after (cam, cfg, sensor)."""
    m = jms.MapState(**{k: jnp.asarray(v) for k, v in scene.map.items()})
    img_b = None if scene.img_b is None else jnp.asarray(scene.img_b)
    return (
        m, jbitmap(m), jnp.asarray(scene.img_a), img_b, 0.0,
        jnp.asarray(scene.vel), jnp.asarray(scene.T_cr),
        jnp.asarray(scene.last_feat_pt),
        JFrame(*[jnp.asarray(x) for x in scene.last_frame]),
        jnp.asarray(scene.ref_kf, jnp.int32), jnp.float32(scene.close_depth),
    )


def _jax(cam, cfg):
    return JCam(**cam._asdict()), jtracking.TrackerConfig(**dataclasses.asdict(cfg))


def _assert_outputs_close(jouts, touts):
    assert len(touts) == len(jouts) == len(NAMES)
    for name, a, b in zip(NAMES, jouts, touts):
        a, b = np.asarray(a), b.cpu().numpy()
        assert a.shape == b.shape, name
        if name in POSES:
            np.testing.assert_allclose(b, a, atol=1e-4, err_msg=name)
        elif name in ARRAYS:
            assert (a == b).mean() >= 0.99, name
        elif name == "vote_kf":
            assert int(a) == int(b)
        else:
            assert abs(float(a) - float(b)) <= 0.01 * abs(float(a)), (name, a, b)


def _assert_tracks(outs, scene, min_inlier_frac):
    """Local-map tracking recovers T_true from the scene's points."""
    T = outs[5].cpu().numpy()
    assert np.abs(T - scene.T_true)[:3, 3].max() < 1e-2
    assert int(outs[6]) >= min_inlier_frac * scene.n_scene
    assert int(outs[4]) == 0  # keyframe 0 wins the vote


def test_build_frame_stereo_kitti_geometry():
    """build_frame_stereo at 1241x376 / 2000 features, with the
    tolerances of tests/test_torch_stereo.py."""
    check_build_frame_stereo(entry.KITTI_CAM, 2000, entry.STEREO_DISPARITY, 3)


def test_track_frame_device_small_kitti_scene():
    """All 17 outputs on one frame, K = 16, P = 4096, local_pt_cap = 1024
    (the usable points exceed it, so the compaction cuts)."""
    cfg = ttracking.TrackerConfig(
        n_features=2000, max_keyframes=16, max_points=4096, local_pt_cap=1024
    )
    # disparity 24 puts the plane at 16.1 m, inside close_depth (18.8 m)
    scene = entry.kitti_scene(np.random.default_rng(0), "cpu", cfg, 12, 3500,
                              disparity=24)
    args = entry.scene_inputs(scene, "cpu")
    jargs = _jax_inputs(scene, entry.KITTI_CAM, cfg)
    frame, jframe = args[8], jargs[8]  # the last frame is the frame itself
    touts = ttracking._track_frame_device(
        entry.KITTI_CAM, cfg, args[0], args[1], frame, *args[5:]
    )
    jouts = jtracking._track_frame_device(
        *_jax(entry.KITTI_CAM, cfg), jargs[0], jargs[1], jframe, *jargs[5:]
    )
    _assert_outputs_close(jouts, touts)
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(jargs[1]))
    # the local map finds the points the motion model had not linked,
    # among the first 1024 usable points only: the compaction cut
    feat, feat_m = touts[7].numpy(), touts[13].numpy()
    found = feat[(feat_m < 0) & (feat >= 0)]
    assert found.size > 300 and found.max() < 1024
    assert int(touts[10]) > 0 and int(touts[11]) > 0  # close points exist
    _assert_tracks(touts, scene, 0.7)


def test_track_frame_step_kitti_geometry():
    """One stereo frame through track_frame_step at 1241x376 / 2000
    features with a reduced map (K = 48, P = 16384), against the body of
    the JAX package's _build_and_track_device(sensor="stereo"):
    build_frame_stereo, then _track_frame_device. The two jitted parts
    (the first compiled by the test above) stand for the fused program,
    whose compile alone would take about 20 s here."""
    cfg = dataclasses.replace(
        entry.KITTI_CFG, max_keyframes=48, max_points=16384
    )
    scene = entry.kitti_scene(np.random.default_rng(1), "cpu", cfg, 40, 12000)
    args = entry.scene_inputs(scene, "cpu")
    tframe, touts = entry.track_frame_step(*args, cfg=cfg)
    jcam, jcfg = _jax(entry.KITTI_CAM, cfg)
    jargs = _jax_inputs(scene, entry.KITTI_CAM, cfg)
    jframe = jframe_mod.build_frame_stereo(
        jargs[2], jargs[3], 0.0, jcam, n_features=cfg.n_features
    )
    jouts = jtracking._track_frame_device(
        jcam, jcfg, jargs[0], jargs[1], jframe, *jargs[5:]
    )
    np.testing.assert_array_equal(tframe.uv.numpy(), np.asarray(jframe.uv))
    _assert_outputs_close(jouts, touts)
    _assert_tracks(touts, scene, 0.8)
    # stereo rows: at least half of the features have a depth
    assert (tframe.ur.numpy() >= 0).sum() >= 0.5 * tframe.valid.numpy().sum()
