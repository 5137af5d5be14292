"""Parity of the port's host `Tracker` with the JAX package's on the CPU:
the mono sequence and configuration of tests/test_quick_e2e.py (8
frames, 320x240, 400 features), monocular initialization included.

Both trackers run with async_backend=False (whether a deferred insert
has finished depends on timing) and the port replays the JAX package's
RANSAC draws (`Replay`), so both take the same decisions:
- per-frame states, stats, keyframe count and keyframe frame ids: equal;
- per-frame and exported poses: atol 1e-3 (float32 sums in another
  order through initialization, tracking and local BA; measured in
  PERF.md);
- the async backend gives the same trajectory as the sync one, and so
  does a map that has to grow its capacities on the way.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.engine import tracking as jtracking
from orb_slam2_test_tpu.solvers import initializer as jinit
from orb_slam2_test_tpu.utils.synthetic import default_camera, make_sequence
from orb_slam2_test_tpu_torch.engine import tracking as ttracking
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera as TCam

from test_quick_e2e import CFG

torch.set_num_threads(2)

POSE_ATOL = 1e-3


class Replay(ttracking.Tracker):
    """The port's Tracker fed the JAX Tracker's RANSAC draws: one key
    split per initialization attempt, then (homography, fundamental)
    keys as jax initialize_mono splits them."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.key = jax.random.PRNGKey(self.cfg.seed)

    def _ransac_samples(self, valid):
        self.key, sub = jax.random.split(self.key)
        v = jnp.asarray(valid.cpu().numpy())
        return tuple(
            torch.from_numpy(np.array(jinit._sample_indices(k, v, jinit.RANSAC_ITERS,
                                                            jinit.SAMPLE)))
            for k in jax.random.split(sub)
        )


def run_tracker(tracker, images, mono=True):
    """Feed the frames; returns per-frame (state, pose or None)."""
    out = []
    for i, img in enumerate(images):
        if mono:
            pose = tracker.process_image_mono(img, i / 30.0)
        else:
            pose = tracker.process_image_stereo(img[0], img[1], i / 30.0)
        out.append((tracker.state, None if pose is None else np.array(pose, np.float64)))
    return out


def keyframe_ids(m):
    valid = np.asarray(m.kf_valid.cpu() if torch.is_tensor(m.kf_valid) else m.kf_valid)
    fid = np.asarray(m.kf_frame_id.cpu() if torch.is_tensor(m.kf_frame_id) else m.kf_frame_id)
    return sorted(fid[valid].tolist())


def assert_runs_match(j, t, jtr, ttr, atol=POSE_ATOL):
    assert [s for s, _ in t] == [s for s, _ in j]
    for (_, pj), (_, pt) in zip(j, t):
        np.testing.assert_allclose(pt, pj, atol=atol)
    assert ttr.stats == jtr.stats
    assert keyframe_ids(ttr.map) == keyframe_ids(jtr.map)
    assert int(ttr.map.n_kf) == int(jtr.map.n_kf) == ttr.n_live_kf
    je, te = jtr.export_trajectory(), ttr.export_trajectory()
    assert [ts for ts, _ in te] == [ts for ts, _ in je]
    for (_, a), (_, b) in zip(je, te):
        np.testing.assert_allclose(b, np.asarray(a), atol=atol)
    return max(np.abs(b - np.asarray(a)).max() for (_, a), (_, b) in zip(je, te))


@pytest.fixture(scope="module")
def mono():
    cam = default_camera(320, 240)
    cam, poses, _, images = make_sequence(
        np.random.default_rng(0), 8, cam=cam, n_landmarks=160,
        step=np.array([0.12, 0.01, 0.0, 0.001, 0.003, 0.001]),
    )
    jtr = jtracking.Tracker(cam, jtracking.TrackerConfig(**CFG, async_backend=False))
    j = run_tracker(jtr, images)
    ttr = Replay(TCam(**cam._asdict()), ttracking.TrackerConfig(**CFG, async_backend=False),
                 device="cpu")
    t = run_tracker(ttr, images)
    return dict(cam=cam, images=images, poses=poses, jtr=jtr, j=j, ttr=ttr, t=t)


def test_mono_sequence_matches_jax(mono):
    gap = assert_runs_match(mono["j"], mono["t"], mono["jtr"], mono["ttr"])
    print(f"mono sequence: exported poses within {gap:.3e} of the JAX package's")
    ttr = mono["ttr"]
    assert ttr.state == "OK" and ttr.stats["n_kf"] >= 3
    # the last frame's diagnostics agree too
    for k in ("n_motion_matches", "n_motion_inliers", "n_local_inliers"):
        assert abs(ttr.last_diag[k] - mono["jtr"].last_diag[k]) <= 1, k


def test_mono_map_matches_jax(mono):
    jm, tm = mono["jtr"].map, mono["ttr"].map
    np.testing.assert_array_equal(tm.kf_valid.numpy(), np.asarray(jm.kf_valid))
    np.testing.assert_array_equal(tm.kf_parent.numpy(), np.asarray(jm.kf_parent))
    assert abs(int(tm.n_pt) - int(jm.n_pt)) <= 0.01 * int(jm.n_pt)
    a, b = np.asarray(jm.kf_pt_idx), tm.kf_pt_idx.numpy()
    linked = (a >= 0) | (b >= 0)
    assert (a == b)[linked].mean() >= 0.99


def test_async_backend_matches_sync(mono):
    """async_backend=True defers each insert's readback to the next
    keyframe decision; on the CPU the mapper is idle when its call
    returns, so the decisions and the trajectory are the sync ones."""
    cam = TCam(**mono["cam"]._asdict())
    ttr = Replay(cam, ttracking.TrackerConfig(**CFG, async_backend=True), device="cpu")
    t = run_tracker(ttr, mono["images"])
    assert ttr._pending_kf  # an insert was still deferred before export
    assert_runs_match(mono["t"], t, mono["ttr"], ttr, atol=0.0)
    assert not ttr._pending_kf


def test_reset_clears_the_map(mono):
    cam = TCam(**mono["cam"]._asdict())
    ttr = ttracking.Tracker(cam, ttracking.TrackerConfig(**CFG), device="cpu")
    run_tracker(ttr, mono["images"][:5])
    assert ttr.state == "OK" and int(ttr.map.n_kf) >= 2
    ttr.reset()
    assert ttr.state == "NOT_INITIALIZED" and int(ttr.map.n_kf) == 0
    assert ttr.trajectory == [] and ttr.stats["n_kf"] == 0


def test_capacity_growth_keeps_the_sequence(mono):
    """A map too small for the sequence grows on the way (keyframes 4 ->
    8 after a standalone cull finds no victim; points 1024 -> 2048 after
    the host bound asks for a recount) and the run keeps the decisions
    and poses of the roomy one."""
    cam = TCam(**mono["cam"]._asdict())
    cfg = ttracking.TrackerConfig(**{**CFG, "max_keyframes": 4, "max_points": 1024},
                                  async_backend=False)
    ttr = Replay(cam, cfg, device="cpu")
    t = run_tracker(ttr, mono["images"])
    assert ttr.cfg.max_keyframes == 8 and ttr.cfg.max_points == 2048
    assert ttr.map.kf_valid.shape[0] == 8 and ttr.map.pt_valid.shape[0] == 2048
    assert_runs_match(mono["t"], t, mono["ttr"], ttr)
