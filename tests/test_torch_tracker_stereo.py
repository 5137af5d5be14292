"""Parity of the port's host `Tracker` with the JAX package's on a stereo
sequence, on the CPU: `entry.band_sequence` (the four bands of the
insert scene carried over 6 views, 0.155 m apart) at 640x480 with 1000
features and a map of K = 64 keyframes and P = 16,384 points, from an
empty map. Both run with async_backend=False. Stereo initialization
has no RANSAC, so nothing is replayed.

- per-frame states, stats, keyframe count and keyframe frame ids: equal;
- per-frame and exported poses: atol 1e-3;
- the port's poses lie within 1 cm of the sequence's exact poses.
"""

import numpy as np
import pytest
import torch

from orb_slam2_test_tpu.engine import tracking as jtracking
from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.engine import tracking as ttracking

from test_torch_tracker import assert_runs_match, run_tracker

torch.set_num_threads(2)

CAM = entry.RGBD_CAM  # TUM freiburg1 intrinsics, bf 40
CFG = dict(n_features=1000, max_keyframes=64, max_points=16384, kf_ref_ratio=0.75,
           max_frames_between_kf=10, async_backend=False)


@pytest.fixture(scope="module")
def stereo():
    seq = entry.band_sequence(np.random.default_rng(0), CAM, 6, "cpu")
    views = [(left.numpy(), right.numpy()) for _, left, right in seq.frames]
    jtr = jtracking.Tracker(JCam(**CAM._asdict()), jtracking.TrackerConfig(**CFG))
    j = run_tracker(jtr, views, mono=False)
    ttr = ttracking.Tracker(CAM, ttracking.TrackerConfig(**CFG), device="cpu")
    t = run_tracker(ttr, views, mono=False)
    return dict(seq=seq, jtr=jtr, j=j, ttr=ttr, t=t)


def test_stereo_sequence_matches_jax(stereo):
    gap = assert_runs_match(stereo["j"], stereo["t"], stereo["jtr"], stereo["ttr"])
    print(f"stereo sequence: exported poses within {gap:.3e} of the JAX package's")
    ttr = stereo["ttr"]
    assert [s for s, _ in stereo["t"]] == ["OK"] * 6
    assert ttr.stats["n_kf"] >= 2 and ttr.stats["lost_frames"] == 0


def test_stereo_sequence_lands_on_the_truth(stereo):
    seq, ttr = stereo["seq"], stereo["ttr"]
    for i, (_, T) in enumerate(ttr.export_trajectory()):
        assert np.abs(T - seq.T_true[i])[:3, 3].max() < 1e-2, i
    # the band sequence's frames are exact integer shifts of one texture
    assert len(seq.frames) == 6 and seq.frames[0][1].dtype == torch.uint8
    np.testing.assert_allclose(seq.T_true[0], np.eye(4))
    np.testing.assert_allclose(seq.T_true[2][0, 3], -4 * CAM.bf / CAM.fx)
