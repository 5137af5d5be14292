"""The port's relocalization and loop-candidate detection against the
JAX package's, on the CPU, and the port's Tracker recovering from a
blackout.

- `relocalize` on a map and frame carried across with
  `entry.map_from_numpy` / `frame_from_numpy` (an RGB-D band scene,
  the frame one view away from keyframe 0), with the JAX key chain
  replayed through the PnP draw hook: equal success, pose atol 1e-4,
  feature -> point links >= 99% equal; min_inliers 150 takes the
  projection-widening branch.
- `LoopCloser`: over 14 keyframes (8 places, then the first 6 again)
  the words, the covisible sets and `_detect_loop`'s candidate (and the
  consistency chain under it) equal the JAX package's at every
  keyframe, and the checkpoint's `rebuild_from_map` gives the same
  database.
- The blackout of tests/test_loop_closing_e2e.py (320x240 RGB-D, a
  k=10 depth=4 vocabulary trained from the sequence, a keyframe per
  frame, two flat frames, then the view of frame 2 again): the port's
  Tracker relocalizes by itself (reloc >= 1, translation error < 5 cm).
  The same run against the JAX Tracker with its draws fed in is marked
  slow, as the JAX test is.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.bow import vocabulary as jvoc
from orb_slam2_test_tpu.engine import loop_closing as jlc
from orb_slam2_test_tpu.engine import relocalization as jrel
from orb_slam2_test_tpu.engine import tracking as jtracking
from orb_slam2_test_tpu.engine.frame import FrameData as JFrame
from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu.slam_map.mapstate import MapState as JMap
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.bow import vocabulary as tvoc
from orb_slam2_test_tpu_torch.engine import loop_closing as tlc
from orb_slam2_test_tpu_torch.engine import relocalization as trel
from orb_slam2_test_tpu_torch.engine import tracking as ttracking
from orb_slam2_test_tpu_torch.engine.frame import build_frame_mono
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera as TCam
from orb_slam2_test_tpu_torch.geometry.se3 import se3_exp
from orb_slam2_test_tpu_torch.slam_map.mapstate import level_tables, make_empty_map
from orb_slam2_test_tpu_torch.utils.synthetic import (
    _landmark_patches,
    default_camera,
    make_landmarks,
    render_frame,
)

from test_loop_closing_e2e import CFG, _rgbd_depth
from test_torch_pnp import jax_draw

torch.set_num_threads(2)

POSE_ATOL = 1e-4


class KeyChain:
    """The PnP sampler of a JAX key chain: one split per candidate that
    reaches PnP, as `relocalize` splits its key."""

    def __init__(self, key):
        self.key = key

    def __call__(self):
        self.key, sub = jax.random.split(self.key)
        return jax_draw(sub)


def _jmap(m: dict) -> JMap:
    return JMap(**{k: jnp.asarray(v) for k, v in m.items()})


# ---------------------------------------------------------------------------
# relocalize
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reloc_scene():
    cam = entry.RGBD_CAM
    cfg = ttracking.TrackerConfig(n_features=500, max_keyframes=16, max_points=2048)
    scene = entry.insert_scene(np.random.default_rng(0), "rgbd", cam, cfg, 4, 600, "cpu")
    frame = entry._view_frame(*scene.views[1], "rgbd", cam, cfg, "cpu")
    return cam, cfg, scene, frame


@pytest.mark.parametrize("min_inliers", (50, 150))
def test_relocalize_matches_jax(reloc_scene, min_inliers):
    cam, cfg, scene, frame = reloc_scene
    key = jax.random.PRNGKey(3)
    jok, jT, jfp, _ = jrel.relocalize(
        JFrame(*[jnp.asarray(x) for x in frame]), _jmap(scene.map), JCam(**cam._asdict()),
        [0], key, cfg.map_capacity.level_sigma2, min_inliers=min_inliers)
    _, sig2 = level_tables(cfg.map_capacity, "cpu")
    tok, tT, tfp, info = trel.relocalize(
        entry.frame_from_numpy(frame, "cpu"), entry.map_from_numpy(scene.map, "cpu"), cam,
        [0], KeyChain(key), sig2, min_inliers=min_inliers)
    assert tok and jok
    assert info["tried"] == 1 and info["pnp_rounds"] == 1 and info["hypotheses"] == 256
    np.testing.assert_allclose(tT, np.asarray(jT), atol=POSE_ATOL)
    assert (tfp.numpy() == np.asarray(jfp)).mean() >= 0.99
    n_linked = int((tfp >= 0).sum())
    assert n_linked >= min_inliers
    assert np.abs(tT[:3, 3] - scene.T_true[1][:3, 3]).max() < 5e-3


def test_relocalize_gives_up_like_jax(reloc_scene):
    """A bar above what the widened matches reach: both fail, and a
    candidate with too few matches is skipped before PnP."""
    cam, cfg, scene, frame = reloc_scene
    key = jax.random.PRNGKey(3)
    jok, jT, _, _ = jrel.relocalize(
        JFrame(*[jnp.asarray(x) for x in frame]), _jmap(scene.map), JCam(**cam._asdict()),
        [0, 1], key, cfg.map_capacity.level_sigma2, min_inliers=400)
    _, sig2 = level_tables(cfg.map_capacity, "cpu")
    tok, tT, tfp, info = trel.relocalize(
        entry.frame_from_numpy(frame, "cpu"), entry.map_from_numpy(scene.map, "cpu"), cam,
        [0, 1], KeyChain(key), sig2, min_inliers=400)
    assert not tok and not jok and tT is None and tfp is None
    assert info["tried"] == 1  # keyframe 1 is a random bench keyframe


# ---------------------------------------------------------------------------
# LoopCloser: detection and the database
# ---------------------------------------------------------------------------

N_FEAT = 150
PLACES = (0, 1, 2, 3, 4, 5, 6, 7, 0, 1, 2, 3, 4, 5)


def _flip_bits(rng, desc, n_flips):
    bits = jvoc._unpack(desc).copy()
    for i in range(len(bits)):
        bits[i, rng.choice(256, n_flips, replace=False)] ^= 1
    return jvoc._pack(bits)


@pytest.fixture(scope="module")
def loop_map():
    """A map of 14 keyframes along a path that comes back to its start:
    keyframe i sees place PLACES[i] (noisy copies of that place's
    descriptors) and shares 75 points with each neighbour on the path,
    none across the revisit (the loop is not closed). Returns the numpy
    map, the vocabulary trained on the places and the keyframe count."""
    rng = np.random.default_rng(4)
    places = [rng.integers(0, 2**32, (N_FEAT, 8), dtype=np.uint32) for _ in range(8)]
    voc = jvoc.build_vocabulary(np.concatenate(places), k=10, depth=3, seed=0)
    K = len(PLACES)
    cap = ttracking.TrackerConfig(n_features=N_FEAT, max_keyframes=16,
                                  max_points=4096).map_capacity
    m = {k: v.numpy() for k, v in make_empty_map(cap, "cpu")._asdict().items()}
    for k in ("kf_desc", "pt_desc"):
        m[k] = m[k].view(np.uint32)
    half = N_FEAT // 2
    for i, p in enumerate(PLACES):
        m["kf_desc"][i] = _flip_bits(rng, places[p], 10)
        m["kf_kp_valid"][i] = True
        # features 0..74 see segment i's points, 75..149 segment i + 1's
        m["kf_pt_idx"][i, :half] = i * half + np.arange(half)
        m["kf_pt_idx"][i, half:] = (i + 1) * half + np.arange(half)
        m["kf_Tcw"][i] = np.eye(4)
    m["pt_valid"][: (K + 1) * half] = True
    return m, voc, K


def _closers(voc):
    jc = jlc.LoopCloser(JCam(**default_camera()._asdict()), voc, min_kf_gap=2)
    tc = tlc.LoopCloser(default_camera(), entry.vocabulary_from_numpy(voc, "cpu"),
                        min_kf_gap=2, device="cpu")
    return jc, tc


def _with_live(m: dict, n: int) -> dict:
    out = dict(m)
    out["kf_valid"] = np.arange(len(m["kf_valid"])) < n
    out["n_kf"] = np.int32(n)
    return out


def test_detect_loop_matches_jax(loop_map):
    m, voc, K = loop_map
    jc, tc = _closers(voc)
    # both closers' Sim3 stage is held out (tests/test_torch_loop_closing.py
    # holds it to the JAX package), so both run detection alone
    jc._compute_and_correct = lambda mm, kf, cand: (False, mm)
    tc._compute_and_correct = lambda mm, kf, cand: (False, mm)
    jfound = []
    detect = jc._detect_loop

    def record(*a):
        jfound.append(detect(*a))
        return jfound[-1]

    jc._detect_loop = record
    tfound = []
    for kf in range(K):
        mk = _with_live(m, kf + 1)
        np.testing.assert_array_equal(tc.kf_words(entry.map_from_numpy(mk, "cpu"), kf),
                                      jc.kf_words(_jmap(mk), kf))
        n_before = len(jfound)
        _, jclosed = jc.on_new_keyframe(_jmap(mk), kf)
        _, tclosed = tc.on_new_keyframe(entry.map_from_numpy(mk, "cpu"), kf)
        assert not jclosed and not tclosed
        tfound.append(tc.last_candidate)
        if len(jfound) == n_before:
            jfound.append(None)  # the JAX closer did not try to detect
        assert tc.last_candidate == jfound[-1], kf
        assert tc.consistent_groups == jc.consistent_groups, kf
        assert tc.db.words.keys() == jc.db.words.keys()
    print("loop candidates per keyframe:", tfound)
    # the revisits chain up: from the third consecutive detection on,
    # each revisiting keyframe finds the first visit of its place
    assert tfound[10:] == [PLACES[kf] for kf in range(10, K)]

    # the checkpoint path: a database rebuilt from the map
    tc2 = tlc.LoopCloser(default_camera(), tc.voc, device="cpu")
    tc2.rebuild_from_map(entry.map_from_numpy(_with_live(m, K), "cpu"))
    assert tc2.db.words.keys() == tc.db.words.keys()
    for kf, w in tc.db.words.items():
        np.testing.assert_array_equal(tc2.db.words[kf], w)


# ---------------------------------------------------------------------------
# the Tracker after a blackout
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def blackout():
    """The scene of test_relocalization_after_blackout, rendered by the
    port's synthetic helpers (the JAX package's draws, the same rng)."""
    rng = np.random.default_rng(0)
    cam = default_camera(320, 240)
    cam = cam._replace(bf=0.08 * cam.fx)
    landmarks = make_landmarks(rng, 160)
    inten = rng.uniform(140, 255, 160).astype(np.float32)
    patches = _landmark_patches(160)
    step = np.array([0.10, 0.01, 0.0, 0.001, 0.003, 0.001], np.float32)
    poses = [se3_exp(torch.from_numpy(step * i)).numpy() for i in range(8)]
    images = [render_frame(cam, T, landmarks, inten, patches=patches) for T in poses]
    depths = [_rgbd_depth(cam, T, landmarks) for T in poses]
    descs = []
    for img in images[:6]:
        f = build_frame_mono(torch.from_numpy(np.asarray(img, np.float32)), 0.0, cam,
                             n_features=400)
        descs.append(f.desc[f.valid].numpy())
    voc = tvoc.build_vocabulary(np.concatenate(descs), k=10, depth=4, seed=0, device="cpu")
    return cam, poses, images, depths, voc


def _blackout_run(tracker, images, depths):
    """Frames 0-5, two flat frames, then frame 2's view again; returns
    (state, stats copy, pose or None) after each frame."""
    out = []

    def step(img, depth, t):
        pose = tracker.process_image_rgbd(img, depth, t)
        out.append((tracker.state, dict(tracker.stats),
                    None if pose is None else np.array(pose, np.float64)))

    for i in range(6):
        step(images[i], depths[i], i / 30.0)
    black = np.full_like(images[0], 16.0)
    for i in range(2):
        step(black, np.zeros_like(depths[0]), (6 + i) / 30.0)
    step(images[2], depths[2], 9 / 30.0)
    return out


def test_tracker_relocalizes_after_blackout(blackout):
    cam, poses, images, depths, voc = blackout
    tracker = ttracking.Tracker(cam, ttracking.TrackerConfig(**{**CFG, "max_frames_between_kf": 1}),
                                device="cpu")
    tracker.enable_place_recognition(voc, fix_scale=True)
    out = _blackout_run(tracker, images, depths)
    assert out[5][0] == "OK" and out[5][1]["n_kf"] > 5
    assert [s for s, _, _ in out[6:8]] == ["LOST", "LOST"]
    assert out[7][1]["lost_frames"] == 2 and out[7][1]["reloc"] == 0
    state, stats, pose = out[8]
    assert state == "OK", "relocalization failed"
    assert stats["reloc"] >= 1
    err = np.linalg.norm(pose[:3, 3] - poses[2][:3, 3])
    print(f"relocalized: translation error {err:.3e} m, diag {tracker.last_diag}")
    assert err < 0.05, err
    assert tracker.last_diag["reloc_ok"] and tracker.last_diag["reloc_candidates"] >= 1
    # no velocity after a relocalization (the lost last frame has none):
    # the next view tracks the reference keyframe, then the motion model
    assert tracker.velocity is None
    for i in (3, 4):
        pose = tracker.process_image_rgbd(images[i], depths[i], (7 + i) / 30.0)
        assert tracker.state == "OK" and tracker.velocity is not None
        assert np.linalg.norm(pose[:3, 3] - poses[i][:3, 3]) < 0.05
    # every resolved insert is in the database (as in the JAX package,
    # the initialization's keyframe is not), and a reset keeps place
    # recognition on with an empty database
    tracker.flush_backend()  # the last inserts' culls reach the database
    live = set(np.flatnonzero(tracker.map.kf_valid.numpy()).tolist())
    assert len(tracker.loop_closer.db.words) >= 4 and set(tracker.loop_closer.db.words) <= live
    tracker.reset()
    assert tracker.loop_closer is not None and not tracker.loop_closer.db.words


class ReplayTracker(ttracking.Tracker):
    """The port's Tracker fed the JAX Tracker's PnP draws."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.key = jax.random.PRNGKey(self.cfg.seed)

    def _pnp_sampler(self):
        self.key, sub = jax.random.split(self.key)
        return jax_draw(sub)


@pytest.mark.slow
def test_tracker_blackout_matches_jax(blackout):
    cam, poses, images, depths, voc = blackout
    cfg = {**CFG, "max_frames_between_kf": 1, "async_backend": False}
    jtr = jtracking.Tracker(JCam(**cam._asdict()), jtracking.TrackerConfig(**cfg))
    jvocab = jvoc.Vocabulary(**{f: getattr(voc, f) for f in (
        "node_desc", "node_children", "node_is_leaf", "leaf_word", "word_weight")},
        k=voc.k, depth=voc.depth)
    jtr.enable_place_recognition(jvocab, fix_scale=True)
    ttr = ReplayTracker(TCam(**cam._asdict()), ttracking.TrackerConfig(**cfg), device="cpu")
    ttr.enable_place_recognition(voc, fix_scale=True)
    j = _blackout_run(jtr, images, depths)
    t = _blackout_run(ttr, images, depths)
    assert [(s, st) for s, st, _ in t] == [(s, st) for s, st, _ in j]
    for (_, _, a), (_, _, b) in zip(j, t):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b, a, atol=1e-3)
    assert t[-1][1]["reloc"] >= 1
