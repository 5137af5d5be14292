"""`entry.tracker_to`: a Tracker's whole state copied to a device, which
chip_smoke.py [19b] uses to hold the card to the CPU port frame by frame
from the card's own state. On the CPU: a copy made after frame k and the
original track frame k + 1 to bit-equal states, every attribute of the
Tracker, its loop closer and keyframe database compared (the map, the
observer bitmap, the last frame and links, velocity, reference keyframe,
counters, deferred inserts, trajectory, generators' states), and the
copy shares no tensor with the original.

The sequence: tests/test_torch_tracker_stereo.py's stereo band sequence
(640x480, 1000 features, K = 64, P = 16,384), with the async backend on
(inserts stay deferred across frames) and the packaged vocabulary
attached (place recognition fills the keyframe database).
"""

import dataclasses

import numpy as np
import pytest
import torch

from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.bow.vocabulary import Vocabulary, default_vocabulary
from orb_slam2_test_tpu_torch.engine import tracking as ttracking

torch.set_num_threads(2)

CAM = entry.RGBD_CAM
CFG = dict(n_features=1000, max_keyframes=64, max_points=16384, kf_ref_ratio=0.75,
           max_frames_between_kf=2)
N_FRAMES = 6


def assert_same_state(a, b, path="tracker"):
    """a and b hold equal values everywhere, no tensor in common."""
    assert type(a) is type(b), path
    if torch.is_tensor(a):
        assert a.dtype == b.dtype and a.device == b.device, path
        assert torch.equal(a, b), path
        assert a.data_ptr() != b.data_ptr() or a.numel() == 0, path
    elif isinstance(a, torch.Generator):
        assert torch.equal(a.get_state(), b.get_state()), path
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_state(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same_state(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, Vocabulary):
        assert a is b, path  # shared, read only
    elif dataclasses.is_dataclass(a):
        assert a == b, path  # frozen configurations
    elif hasattr(a, "__dict__") and type(a).__module__.startswith("orb_slam2_test_tpu_torch"):
        assert a is not b, path
        assert_same_state(vars(a), vars(b), path)
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def views():
    seq = entry.band_sequence(np.random.default_rng(0), CAM, N_FRAMES, "cpu")
    return [(t, left.numpy(), right.numpy()) for t, left, right in seq.frames]


def test_copy_tracks_the_next_frame_bit_equal(views):
    tracker = ttracking.Tracker(CAM, ttracking.TrackerConfig(**CFG), device="cpu")
    tracker.enable_place_recognition(default_vocabulary(), fix_scale=True)
    t, left, right = views[0]
    tracker.process_image_stereo(left, right, t)
    pending = 0
    for t, left, right in views[1:]:
        copy = entry.tracker_to(tracker, "cpu")
        assert_same_state(tracker, copy)
        # the copy first: were any state shared, the original's frame
        # would then start from the copy's result
        copy.process_image_stereo(left, right, t)
        tracker.process_image_stereo(left, right, t)
        assert_same_state(tracker, copy)
        pending += bool(tracker._pending_kf)
        assert tracker.state == "OK"
    # the run covered deferred inserts and keyframes in the database
    assert pending > 0 and tracker.stats["n_kf"] >= 3
    assert len(tracker.loop_closer.db.words) >= 1
