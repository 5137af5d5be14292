"""The port's `_build_and_track_device` against the JAX package's, for
each sensor (mono, stereo, RGB-D), at 320x240 / 300 features on a
seeded `entry.tracking_scene` with K = 16 and P = 1024.

Each package builds its own frame from the same images, then tracks
it. Tolerances are those of tests/test_torch_tracking.py: poses atol
1e-4, counts within 1%, links and visibility equal on >= 99% of the
entries, the same best-voted keyframe.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.engine import tracking as jtracking
from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.engine import tracking as ttracking
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera as TCam

from test_torch_tracking import _assert_outputs_close, _assert_tracks, _jax_inputs

torch.set_num_threads(2)

CAM = TCam(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240,
           bf=260.0 * 0.1)
CFG = ttracking.TrackerConfig(n_features=300, max_keyframes=16, max_points=1024,
                              local_pt_cap=512)


@pytest.mark.parametrize("sensor", ["mono", "stereo", "rgbd"])
def test_build_and_track_device(sensor):
    scene = entry.tracking_scene(
        np.random.default_rng(7), sensor, CAM, CFG, 12, 800, "cpu", disparity=3,
    )
    args = entry.scene_inputs(scene, "cpu")
    tframe, touts = ttracking._build_and_track_device(CAM, CFG, sensor, *args)
    jframe, jouts = jtracking._build_and_track_device(
        JCam(**CAM._asdict()), jtracking.TrackerConfig(**dataclasses.asdict(CFG)),
        sensor, *_jax_inputs(scene, CAM, CFG),
    )
    for field in ("uv", "level", "valid"):
        np.testing.assert_array_equal(
            getattr(tframe, field).numpy(), np.asarray(getattr(jframe, field))
        )
    has_depth = tframe.depth.numpy() > 0
    if sensor == "mono":
        assert not has_depth.any()
    else:
        assert has_depth.sum() > 0.3 * tframe.valid.numpy().sum()
    _assert_outputs_close(jouts, touts)
    _assert_tracks(touts, scene, 0.8)
