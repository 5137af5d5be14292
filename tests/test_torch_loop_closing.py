"""Loop correction in the port against the JAX package, on the CPU, on a
small synthetic map that closes a loop.

The map (`loop_map`, `entry.synthetic_loop_map`): 22 RGB-D keyframes
on the out-and-back ring of
tests/test_loop_closing_e2e.py (radius 2 m, 18 degrees apart, looking
out at a wall of 1600 textured points 6-7 m away), their poses drifted
along the path (1 cm and 0.17 degrees more per keyframe). Keyframes 20
and 21 revisit the views of 0 and 1, but hold duplicates of the points
the start saw (no association across the loop), so the loop has work
to do: Sim3, fuse, essential graph, global BA. Features are the
points' descriptors with 0-3 flipped bits at their projections (0.3 px
noise), depth measured; a k=8, depth=2 vocabulary is built from them.

- `search_by_bow` (keyframe 21 against keyframe 1's points) and
  `search_by_sim3` (through the true relative Sim3): exact.
- The full covisibility matrix and `add_loop_edge`: exact.
- `_correct_loop_device` from JAX's S12: keyframe poses atol 1e-4,
  point positions 1e-4 on >= 99%, links >= 99% equal, loop edges equal.
- `_compute_and_correct` with the JAX key chain's draws fed in through
  `LoopCloser.sim3_sampler`: both close, the same corrected map within
  the bounds above, with the scale fixed (stereo, RGB-D); with it free
  (the monocular commands) the closers part by 1.547e-4, an expected
  failure (FREE_SCALE_GAP); the port lands within twice the JAX closer's
  own spread of an outcome the JAX closer reaches when its optimize_sim3
  inputs move 1e-6.
  `_correct_loop_device` is held both ways.
- The chunked global BA after the correction (3 chunks: 4 robust
  iterations, the gate, 4 + 4 on the inliers) with, between the first
  and second chunk, a keyframe erased and its slot recycled by a new
  keyframe (a new frame id) and a keyframe created in a free slot with
  points of its own: `_apply_gba_device`'s result, poses atol 2e-3 (40
  CG iterations per LM step in float32), points 2e-3 on >= 99%; the
  recycled slot and the new keyframe move through their parent, the
  new points through their reference keyframe.
- A global BA pending across a capacity growth (K 8 -> 16, P 1024 ->
  2048): the JAX package's apply mixes [8] and [16] arrays and raises
  (ROADMAP queue 3); the port pads the pending problem and its stamps,
  and ends equal to the same BA run without the growth.
- The Tracker: `drain_backend` runs a pending global BA to its end,
  and a checkpoint written after a loop reloads with its loop edges; the
  flush that closes a loop re-anchors the last pose as the JAX Tracker
  does and keeps the velocity, which the JAX Tracker drops.
- `utils.synthetic`'s loop trajectory, scene and renders equal the JAX
  package's exactly; the process-pool stereo renderer
  (`render_loop_stereo`, 2 spawned workers) equals the in-process one.
- The port's Tracker on the out-and-back scene of
  tests/test_loop_closing_e2e.py closes the loop by itself (slow on
  this CPU, like the JAX test: ~70-100 s; `chip_smoke.py` [15a] runs it
  on the card).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.bow.vocabulary import build_vocabulary as jbuild_vocabulary
from orb_slam2_test_tpu.engine import loop_closing as jlc
from orb_slam2_test_tpu.engine import matchers as jmatchers
from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu.slam_map import covisibility as jcov
from orb_slam2_test_tpu.slam_map.mapstate import MapCapacity as JCap
from orb_slam2_test_tpu.slam_map.mapstate import MapState as JMap
from orb_slam2_test_tpu.slam_map.mapstate import grow_map as jgrow_map
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.engine import loop_closing as tlc
from orb_slam2_test_tpu_torch.engine import matchers as tmatchers
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.geometry.se3 import se3_exp
from orb_slam2_test_tpu_torch.slam_map import covisibility as tcov
from orb_slam2_test_tpu_torch.slam_map.mapstate import MapCapacity, grow_map

from test_torch_sim3 import _jax_choice

torch.set_num_threads(2)

POSE_ATOL = 1e-4
# the global BA: 12 LM iterations of 40 float32 CG iterations each over
# the whole map, sums in another order (measured 1.06e-3 on 2 of 368
# pose entries)
GBA_ATOL = 2e-3
N_KF = 22


def _cam() -> PinholeCamera:
    return entry.LOOP_MAP_CAM


def make_loop_map(n_kf=N_KF, K=32, N=200, P=4096, seed=0, n_world=1600):
    """entry.synthetic_loop_map, with a vocabulary the JAX package built
    from its keyframes' descriptors."""
    m, T_true = entry.synthetic_loop_map(n_kf=n_kf, K=K, N=N, P=P, n_world=n_world, seed=seed)
    descs = m["kf_desc"][:n_kf][m["kf_kp_valid"][:n_kf]]
    return m, jbuild_vocabulary(descs, k=8, depth=2, seed=0), T_true


def _jmap(m: dict) -> JMap:
    return JMap(**{k: jnp.asarray(v) for k, v in m.items()})


def _tmap(m: dict):
    return entry.map_from_numpy(m, "cpu")


def _np(m) -> dict:
    if isinstance(m, JMap):
        return {k: np.asarray(v) for k, v in m._asdict().items()}
    return entry.map_to_numpy(m)


def _jcam(cam) -> JCam:
    return JCam(**cam._asdict())


@pytest.fixture(scope="module")
def loop_map():
    return make_loop_map()


class KeyChainSampler:
    """The JAX LoopCloser's Sim3 draws: one key split per RANSAC call."""

    def __init__(self, seed=7):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, valid, n_iters):
        assert n_iters == 128
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.asarray(_jax_choice(sub, jnp.asarray(valid.numpy()))))


def _closers(jvoc, fix_scale=True):
    cam = _cam()
    jc = jlc.LoopCloser(_jcam(cam), jvoc, fix_scale=fix_scale)
    tc = tlc.LoopCloser(cam, entry.vocabulary_from_numpy(jvoc, "cpu"), fix_scale=fix_scale,
                        device="cpu")
    tc.sim3_sampler = KeyChainSampler()
    return jc, tc


def _assert_maps_close(tm: dict, jm: dict, pose_atol=POSE_ATOL, pt_atol=POSE_ATOL):
    live = jm["kf_valid"]
    np.testing.assert_array_equal(tm["kf_valid"], live)
    np.testing.assert_allclose(tm["kf_Tcw"][live], jm["kf_Tcw"][live], atol=pose_atol)
    links = tm["kf_pt_idx"][live] == jm["kf_pt_idx"][live]
    assert links.mean() >= 0.99, links.mean()
    np.testing.assert_array_equal(tm["kf_loop_edge"], jm["kf_loop_edge"])
    pv = jm["pt_valid"]
    np.testing.assert_array_equal(tm["pt_valid"], pv)
    gap = np.abs(tm["pt_xyz"][pv] - jm["pt_xyz"][pv]).max(-1)
    assert (gap <= pt_atol).mean() >= 0.99, (gap.max(), (gap <= pt_atol).mean())


# ---------------------------------------------------------------------------
# matchers and covisibility
# ---------------------------------------------------------------------------


def test_search_by_bow_and_sim3_match_jax(loop_map):
    m, jvoc, T_true = loop_map
    tvoc = entry.vocabulary_from_numpy(jvoc, "cpu")
    jm, tm = _jmap(m), _tmap(m)
    from orb_slam2_test_tpu.bow.vocabulary import transform as jtransform
    from orb_slam2_test_tpu_torch.bow.vocabulary import transform as ttransform

    kf, cand = 21, 1
    row_c = m["kf_pt_idx"][cand]
    has_c = (row_c >= 0) & m["kf_kp_valid"][cand]
    _, jn_cur = jtransform(jvoc, jm.kf_desc[kf], jm.kf_kp_valid[kf])
    _, jn_c = jtransform(jvoc, jm.kf_desc[cand], jnp.asarray(has_c))
    _, tn_cur = ttransform(tvoc, tm.kf_desc[kf], tm.kf_kp_valid[kf])
    _, tn_c = ttransform(tvoc, tm.kf_desc[cand], torch.from_numpy(has_c))
    np.testing.assert_array_equal(tn_cur.numpy(), np.asarray(jn_cur))
    jpm = jmatchers.search_by_bow(
        jlc._kf_as_frame(jm, kf), jn_cur, jm.pt_desc[np.clip(row_c, 0, None)],
        jnp.asarray(has_c), jnp.asarray(np.where(has_c, row_c, -1)), jn_c, jm.kf_angle[cand])
    tpm = tmatchers.search_by_bow(
        tlc._kf_as_frame(tm, kf), tn_cur, tm.pt_desc[torch.from_numpy(np.clip(row_c, 0, None))],
        torch.from_numpy(has_c), torch.from_numpy(np.where(has_c, row_c, -1)), tn_c,
        tm.kf_angle[cand])
    np.testing.assert_array_equal(tpm.feat_pt.numpy(), np.asarray(jpm.feat_pt))
    np.testing.assert_array_equal(tpm.pt_feat.numpy(), np.asarray(jpm.pt_feat))
    assert int(tpm.n_matches) == int(jpm.n_matches) >= 40

    # SearchBySim3 through the true relative pose (scale 1)
    S12 = (T_true[kf] @ np.linalg.inv(T_true[cand])).astype(np.float32)
    own = m["kf_pt_idx"][kf]

    def cam_pts(ids, T):
        return (m["pt_xyz"][np.clip(ids, 0, None)] @ T[:3, :3].T + T[:3, 3]).astype(np.float32)

    pc1 = cam_pts(own, m["kf_Tcw"][kf])
    pc2 = cam_pts(row_c, m["kf_Tcw"][cand])
    j12, jn = jmatchers.search_by_sim3(
        _jcam(_cam()), jlc._kf_as_frame(jm, kf), jnp.asarray(pc1), jnp.asarray(own >= 0),
        jlc._kf_as_frame(jm, cand), jnp.asarray(pc2), jnp.asarray(has_c), jnp.asarray(S12))
    t12, tn = tmatchers.search_by_sim3(
        _cam(), tlc._kf_as_frame(tm, kf), torch.from_numpy(pc1), torch.from_numpy(own >= 0),
        tlc._kf_as_frame(tm, cand), torch.from_numpy(pc2), torch.from_numpy(has_c),
        torch.from_numpy(S12))
    np.testing.assert_array_equal(t12.numpy(), np.asarray(j12))
    assert int(tn) == int(jn) > 0


def test_full_covisibility_and_loop_edge_match_jax(loop_map):
    m, _, _ = loop_map
    jm, tm = _jmap(m), _tmap(m)
    W = tcov.covisibility_weights(tm)
    np.testing.assert_array_equal(W.numpy(), np.asarray(jcov.covisibility_weights(jm)))
    np.testing.assert_array_equal(tcov.observation_indicator(tm).numpy(),
                                  np.asarray(jcov.observation_indicator(jm), np.float32))
    # the rows agree with the query form
    q = torch.tensor([0, 5, 21])
    np.testing.assert_array_equal(tcov.covisibility_weights(tm, q).numpy(), W[q].numpy())
    assert int((W >= 100).sum()) >= 20  # strong edges exist
    t2 = tcov.add_loop_edge(tm, torch.tensor(21), torch.tensor(1))
    j2 = jcov.add_loop_edge(jm, jnp.asarray(21), jnp.asarray(1))
    np.testing.assert_array_equal(t2.kf_loop_edge.numpy(), np.asarray(j2.kf_loop_edge))
    assert int(t2.kf_loop_edge[21]) == 1 and int(t2.kf_loop_edge[1]) == 21
    assert int(tm.kf_loop_edge[21]) == -1  # functional: the input is unchanged


# ---------------------------------------------------------------------------
# ComputeSim3 and CorrectLoop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_closings(loop_map):
    """The JAX closer's _compute_and_correct on keyframe 21 against 1,
    by fix_scale (computed once each)."""
    m, jvoc, _ = loop_map
    done = {}

    def closed(fix_scale: bool):
        if fix_scale not in done:
            jc, _ = _closers(jvoc, fix_scale)
            ok, jm = jc._compute_and_correct(_jmap(m), 21, 1)
            done[fix_scale] = ok, _np(jm), jc
        return done[fix_scale]
    return closed


@pytest.fixture
def jax_closed(jax_closings, fix_scale):
    """The JAX closer's (closed, map, closer) at the test's fix_scale."""
    return jax_closings(fix_scale)


# With the scale free, the Sim3 that ComputeSim3 ends on is
# ill-conditioned in its inputs: the two closers' optimize_sim3 inputs
# differ by 2.7e-6 (the RANSAC S12) and 4.8e-7 (the points), float32
# order; run in float64 from each, it ends 2.6e-5 apart (10 to 40
# iterations alike), and the correction spreads the float32 results'
# 2.1e-5 to 1.547e-4 on 6 of 352 pose entries against POSE_ATOL 1e-4.
# Fed the JAX package's S12, the correction agrees
# (test_correct_loop_device_matches_jax[False]).
FREE_SCALE_GAP = ("free-scale ComputeSim3 spreads a 2.7e-6 input gap to 1.547e-4 in the "
                  "corrected poses (POSE_ATOL 1e-4); ROADMAP queue 3")


@pytest.mark.parametrize("fix_scale", [
    True, pytest.param(False, marks=pytest.mark.xfail(strict=True, reason=FREE_SCALE_GAP))])
def test_compute_and_correct_matches_jax(loop_map, jax_closed, fix_scale):
    """Both closers on the same map and draws, with the scale fixed
    (stereo, RGB-D) and free (monocular)."""
    m, jvoc, T_true = loop_map
    jclosed, jm, _ = jax_closed
    _, tc = _closers(jvoc, fix_scale)
    tclosed, tm = tc._compute_and_correct(_tmap(m), 21, 1)
    assert jclosed and tclosed
    _assert_maps_close(_np(tm), jm)
    assert tc.gba_running()
    # the correction pulled the drifted revisit towards the start
    before = np.linalg.norm(m["kf_Tcw"][21][:3, 3] - m["kf_Tcw"][1][:3, 3])
    after = np.linalg.norm(_np(tm)["kf_Tcw"][21][:3, 3] - _np(tm)["kf_Tcw"][1][:3, 3])
    assert after < before


# The JAX closer's own spread with the scale free: its optimize_sim3
# inputs (the RANSAC S12's translation, every camera-frame point of both
# keyframes) each moved 1e-6 along a seeded random direction, once per
# seed in range(SPREAD_MOVES). The outcomes fall on two branches 1.5e-4
# apart: most moves shift the corrected poses by 1.1e-6 to 5.5e-6, and
# seeds 0 and 8 (0, 8, 22 and 23 of range(40)) land 1.56e-4 away, within
# 2.6e-6 of each other, though their S12 moves only 1.6e-6. No
# link, point or loop edge differs: the 7-DoF pose graph's LM steps end
# on the other branch. The port's closer lands on that second branch
# (its own 1e-6 moves take it back across on 12 of 16): it must lie
# within SPREAD_FACTOR times the JAX closer's spread within a branch of
# an outcome the JAX closer itself reaches, on at least BRANCH_MOVES of
# these moves or unmoved, and its gap within SPREAD_FACTOR times the
# largest move.
SPREAD_MOVES = 16
SPREAD_STEP = 1e-6
SPREAD_FACTOR = 2.0
BRANCH_MOVES = 2


def test_free_scale_gap_within_jax_spread(loop_map, jax_closings, monkeypatch):
    """The port's free-scale _compute_and_correct (the strict expected
    failure above) against the JAX closer's outcomes under 1e-6 moves of
    its optimize_sim3 inputs."""
    m, jvoc, _ = loop_map
    jclosed, jm, _ = jax_closings(False)
    _, tc = _closers(jvoc, False)
    tclosed, tm = tc._compute_and_correct(_tmap(m), 21, 1)
    assert jclosed and tclosed
    live = jm["kf_valid"]
    port, unmoved = _np(tm)["kf_Tcw"][live], jm["kf_Tcw"][live]
    gap = float(np.abs(port - unmoved).max())
    optimize_sim3 = jlc.optimize_sim3
    outcomes = []
    for seed in range(SPREAD_MOVES):
        rng = np.random.default_rng(seed)

        def move(x):
            d = rng.normal(size=x.shape)
            return x + jnp.asarray(SPREAD_STEP * d / np.linalg.norm(d, axis=-1, keepdims=True),
                                   x.dtype)

        def moved(cam, S12, pc1, pc2, valid, **kw):
            return optimize_sim3(cam, S12.at[:3, 3].set(move(S12[:3, 3])), move(pc1),
                                 move(pc2), valid, **kw)
        monkeypatch.setattr(jlc, "optimize_sim3", moved)
        jc, _ = _closers(jvoc, False)
        ok, jm2 = jc._compute_and_correct(_jmap(m), 21, 1)
        assert ok
        outcomes.append(_np(jm2)["kf_Tcw"][live])
    spreads = np.array([np.abs(o - unmoved).max() for o in outcomes])
    # the JAX closer's spread within its own branch: the moves that stay
    # within a tenth of the port's gap of the unmoved outcome
    within = spreads[spreads < 0.1 * gap]
    bound = SPREAD_FACTOR * within.max()
    to_port = np.array([np.abs(port - o).max() for o in outcomes])
    print(f"port gap {gap:.4e}; the JAX closer's spread by move {spreads.tolist()}; within "
          f"its branch {within.max():.3e}; the port from each outcome {to_port.tolist()}")
    assert 0.0 < gap <= SPREAD_FACTOR * spreads.max(), (gap, spreads)
    assert within.size >= SPREAD_MOVES // 2
    # the port sits on a branch the JAX closer itself reaches
    assert gap <= bound or int((to_port <= bound).sum()) >= BRANCH_MOVES, (to_port, bound)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_correct_loop_device_matches_jax(loop_map, fix_scale):
    """The correction alone, from one S12, and its fuse: links to the
    start's points replace the revisit's duplicates. With the scale
    free, the essential graph optimizes 7-DoF Sim3 poses."""
    m, jvoc, T_true = loop_map
    S12 = jnp.asarray((T_true[21] @ np.linalg.inv(T_true[1])
                       @ np.asarray(m["kf_Tcw"][1]) @ np.linalg.inv(m["kf_Tcw"][1])
                       ).astype(np.float32))
    jm = jlc._correct_loop_device(_jcam(_cam()), _jmap(m), jnp.asarray(21, jnp.int32),
                                  jnp.asarray(1, jnp.int32), S12, fix_scale)
    tm = tlc._correct_loop_device(_cam(), _tmap(m), torch.tensor(21), torch.tensor(1),
                                  torch.from_numpy(np.asarray(S12)), fix_scale)
    jm, tm = _np(jm), _np(tm)
    _assert_maps_close(tm, jm)
    start_pts = set(m["kf_pt_idx"][1][m["kf_pt_idx"][1] >= 0].tolist())
    fused = np.isin(tm["kf_pt_idx"][21], list(start_pts)).sum()
    assert fused > np.isin(m["kf_pt_idx"][21], list(start_pts)).sum()


# ---------------------------------------------------------------------------
# the chunked global BA
# ---------------------------------------------------------------------------


def _mid_ba_edits(m: dict) -> dict:
    """Between two chunks: keyframe 5's slot recycled by a new keyframe
    (new frame id, parent 4), and a keyframe created in slot 22 (parent
    21) with 30 points of its own."""
    m = {k: np.array(v) for k, v in m.items()}
    m["kf_frame_id"][5] = 100
    m["kf_Tcw"][5] = m["kf_Tcw"][5] @ np.asarray(se3_exp(torch.tensor(
        [0.02, 0, 0, 0, 0, 0.01])).numpy())
    m["kf_valid"][22] = True
    m["kf_frame_id"][22] = 103
    m["kf_parent"][22] = 21
    m["kf_Tcw"][22] = m["kf_Tcw"][21]
    free = np.nonzero(~m["pt_valid"])[0][:30]
    m["pt_valid"][free] = True
    m["pt_ref_kf"][free] = 22
    m["pt_first_kf"][free] = 103
    m["pt_xyz"][free] = m["pt_xyz"][m["kf_pt_idx"][21][:30]] + 0.01
    m["n_kf"] = np.int32(m["n_kf"] + 1)
    return m


def _run_gba(closer, m, to_map, edits):
    """Advance a started global BA to its end, editing the map after the
    first chunk."""
    chunks = 0
    done = False
    while not done:
        m, done = closer.advance_global_ba(m)
        chunks += 1
        if chunks == 1:
            m = to_map(edits(_np(m)))
    return m, chunks


def test_global_ba_matches_jax(loop_map, jax_closings):
    m, jvoc, _ = loop_map
    _, jm0, jc = jax_closings(True)
    _, tc = _closers(jvoc)
    # both start from the JAX closer's corrected map
    jc._start_global_ba(_jmap(jm0))
    tc._start_global_ba(_tmap(jm0))
    jm, jchunks = _run_gba(jc, _jmap(jm0), _jmap, _mid_ba_edits)
    tm, tchunks = _run_gba(tc, _tmap(jm0), _tmap, _mid_ba_edits)
    assert jchunks == tchunks == 3 and not tc.gba_running()
    jm, tm = _np(jm), _np(tm)
    _assert_maps_close(tm, jm, pose_atol=GBA_ATOL, pt_atol=GBA_ATOL)
    cb, ca = tc.last_gba_cost
    assert float(ca) < float(cb)
    # the recycled slot and the new keyframe moved through their parents
    # (not to the stale optimized pose of the old slot 5)
    edited = _mid_ba_edits(jm0)
    for k in (5, 22):
        assert not np.allclose(tm["kf_Tcw"][k], edited["kf_Tcw"][k], atol=1e-7)
    np.testing.assert_allclose(
        tm["kf_Tcw"][22], edited["kf_Tcw"][22] @ np.linalg.inv(edited["kf_Tcw"][21])
        @ tm["kf_Tcw"][21], atol=1e-4)


def _small_map():
    """8 keyframe slots, 6 live, P = 1024: the growth test's map."""
    m, jvoc, _ = make_loop_map(n_kf=6, K=8, N=200, P=1024)
    return m, jvoc


def test_gba_across_capacity_growth():
    m, jvoc = _small_map()
    jc, tc = _closers(jvoc)
    old = dict(max_keyframes=8, max_features=200, max_points=1024)
    new = dict(max_keyframes=16, max_features=200, max_points=2048)

    # the JAX package: the pending problem stays at K 8, P 1024, and the
    # apply after the last chunk fails on the grown map
    jc._start_global_ba(_jmap(m))
    jm = jgrow_map(_jmap(m), JCap(**old), JCap(**new))
    with pytest.raises(TypeError, match="incompatible shapes"):
        done = False
        while not done:
            jm, done = jc.advance_global_ba(jm)

    # the port: grown mid-BA, padded, equal to the run without growth
    tc._start_global_ba(_tmap(m))
    ref = tlc.LoopCloser(_cam(), tc.voc, fix_scale=True, device="cpu")
    ref._start_global_ba(_tmap(m))
    tm = _tmap(m)
    tm, _ = tc.advance_global_ba(tm)
    tm = grow_map(tm, MapCapacity(**old), MapCapacity(**new))
    tc.grow_pending(16, 2048)
    done = False
    while not done:
        tm, done = tc.advance_global_ba(tm)
    rm, done = _tmap(m), False
    while not done:
        rm, done = ref.advance_global_ba(rm)
    assert tm.kf_Tcw.shape[0] == 16 and tm.pt_xyz.shape[0] == 2048
    torch.testing.assert_close(tm.kf_Tcw[:8], rm.kf_Tcw, atol=1e-6, rtol=0)
    torch.testing.assert_close(tm.pt_xyz[:1024], rm.pt_xyz, atol=1e-6, rtol=0)
    assert float(tc.last_gba_cost[1]) < float(tc.last_gba_cost[0])


# ---------------------------------------------------------------------------
# the Tracker
# ---------------------------------------------------------------------------


def test_tracker_drain_and_checkpoint_after_loop(loop_map, tmp_path):
    from orb_slam2_test_tpu_torch.engine.tracking import Tracker, TrackerConfig
    from orb_slam2_test_tpu_torch.io.checkpoint import load_tracker, save_tracker

    m, jvoc, _ = loop_map
    cfg = TrackerConfig(n_features=200, max_keyframes=32, max_points=4096)
    tracker = Tracker(_cam(), cfg, device="cpu")
    tracker.enable_place_recognition(entry.vocabulary_from_numpy(jvoc, "cpu"), fix_scale=True)
    tracker.loop_closer.sim3_sampler = KeyChainSampler()
    closed, tracker.map = tracker.loop_closer._compute_and_correct(_tmap(m), 21, 1)
    tracker.state = "OK"
    tracker.n_live_kf = N_KF
    assert closed and tracker.loop_closer.gba_running()
    path = str(tmp_path / "loop.npz")
    save_tracker(path, tracker)  # drains first: the global BA finishes
    assert not tracker.loop_closer.gba_running()
    assert tracker.loop_closer.last_gba_cost is not None
    again = Tracker(_cam(), cfg, device="cpu")
    again.enable_place_recognition(tracker.loop_closer.voc, fix_scale=True)
    load_tracker(path, again)
    np.testing.assert_array_equal(again.map.kf_loop_edge.numpy(),
                                  tracker.map.kf_loop_edge.numpy())
    assert int(again.map.kf_loop_edge[21]) == 1
    torch.testing.assert_close(again.map.kf_Tcw, tracker.map.kf_Tcw)


class _ClosingStub:
    """A loop closer that closes a loop on every keyframe it is given,
    returning `moved` as the corrected map."""

    last_candidate = None

    def __init__(self, moved):
        self.moved = moved

    def advance_global_ba(self, m):
        return m, True

    def on_new_keyframe(self, m, kf):
        return self.moved, True


def test_tracker_keeps_its_velocity_across_a_loop(loop_map):
    """The flush whose keyframe closes a loop re-anchors the last pose to
    the moved keyframe (last' = last inv(kf_old) kf_new, reference
    Tracking::UpdateLastFrame) in both packages. The port keeps the
    velocity, as the reference does (its LoopClosing leaves Tracking's
    mVelocity alone); the JAX Tracker drops it (ROADMAP queue 3)."""
    from orb_slam2_test_tpu.engine.tracking import Tracker as JTracker
    from orb_slam2_test_tpu.engine.tracking import TrackerConfig as JConfig
    from orb_slam2_test_tpu_torch.engine.tracking import Tracker, TrackerConfig

    m, _, _ = loop_map
    kf = 21
    delta = se3_exp(torch.tensor([0.03, -0.02, 0.05, 0.01, -0.02, 0.015])).numpy()
    moved = dict(m, kf_Tcw=m["kf_Tcw"].copy())
    moved["kf_Tcw"][kf] = m["kf_Tcw"][kf] @ delta
    rng = np.random.default_rng(3)
    last = se3_exp(torch.from_numpy(rng.normal(0, 0.3, 6).astype(np.float32))).numpy()
    vel = se3_exp(torch.tensor([0.5, 0.0, 0.02, 0.0, 0.04, 0.0])).numpy()
    reanchored = last.astype(np.float64) @ np.linalg.inv(m["kf_Tcw"][kf]) @ moved["kf_Tcw"][kf]
    cfg = dict(n_features=200, max_keyframes=32, max_points=4096)

    port = Tracker(_cam(), TrackerConfig(**cfg), device="cpu")
    port.map, port.loop_closer = _tmap(m), _ClosingStub(_tmap(moved))
    jax_ = JTracker(_jcam(_cam()), JConfig(**cfg))
    jax_.map, jax_.loop_closer = _jmap(m), _ClosingStub(_jmap(moved))
    for tr, pending in ((port, (torch.tensor(kf), torch.tensor(-1), torch.tensor(100), None)),
                        (jax_, (jnp.int32(kf), jnp.int32(-1), jnp.int32(100)))):
        tr.state, tr.n_live_kf, tr.ref_kf = "OK", N_KF, kf
        tr.last_Tcw, tr.velocity = last.copy(), vel.copy()
        tr._pending_kf = [pending]
        tr.flush_backend()
        assert tr.stats["loops"] == 1
        np.testing.assert_allclose(tr.last_Tcw, reanchored, atol=1e-5)
    np.testing.assert_array_equal(port.velocity, vel)
    assert jax_.velocity is None


@pytest.mark.slow
def test_port_tracker_closes_out_and_back_loop():
    """tests/test_loop_closing_e2e.py::test_loop_closing_on_out_and_back
    through the port's Tracker on the CPU."""
    from orb_slam2_test_tpu_torch.entry import out_and_back_scene, out_and_back_tracker

    scene = out_and_back_scene(np.random.default_rng(0), device="cpu")
    tracker = out_and_back_tracker(scene, device="cpu")
    for i in range(len(scene.images)):
        tracker.process_image_rgbd(scene.images[i], scene.depths[i], i / 30.0)
    tracker.drain_backend()
    assert len(tracker.trajectory) >= len(scene.images) - 15
    assert tracker.stats["loops"] >= 1


def test_loop_scene_matches_jax():
    """utils.synthetic's loop trajectory, scene and renders: the JAX
    package's at r04's 0.35 rad viewpoint offset, exactly (the same numpy
    code and draws; at radius 20 m the JAX package's own offset is 20 m of
    arc, tests/test_torch_synthetic_geometry.py); the process-pool stereo
    renderer equals the in-process one as uint8."""
    from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JC
    from orb_slam2_test_tpu.utils import synthetic as jsyn
    from orb_slam2_test_tpu_torch.utils import synthetic as tsyn
    from test_torch_synthetic_geometry import jax_r04_scenes

    np.testing.assert_array_equal(tsyn.make_loop_trajectory(30, 20.0, 1.27),
                                  jsyn.make_loop_trajectory(30, 20.0, 1.27))
    cam = entry.KITTI_CAM._replace(width=200, height=80, fx=120.0, fy=120.0, cx=100.0, cy=40.0,
                                   bf=120.0 * 0.53716)
    with jax_r04_scenes():
        for a, b in zip(tsyn.make_loop_scene(np.random.default_rng(3), 200, 20.0),
                        jsyn.make_loop_scene(np.random.default_rng(3), 200, 20.0), strict=True):
            np.testing.assert_array_equal(a, b)
        j = jsyn.render_loop_sequence(np.random.default_rng(1), 4, JC(**cam._asdict()),
                                      n_landmarks=300, radius=20.0, baseline=0.53716,
                                      blackout=(2,))
    t = tsyn.render_loop_sequence(np.random.default_rng(1), 4, cam, n_landmarks=300,
                                  radius=20.0, baseline=0.53716, blackout=(2,))
    np.testing.assert_array_equal(t["poses"], j["poses"])
    for side in ("left", "right"):
        for a, b in zip(t[side], j[side]):
            np.testing.assert_array_equal(a, b)
    poses, images = tsyn.render_loop_stereo(20, cam, 20.0, 1.27, n_landmarks=300, seed=1,
                                            workers=2)
    ref = tsyn.render_loop_sequence(np.random.default_rng(1), 20, cam, n_landmarks=300,
                                    radius=20.0, baseline=cam.bf / cam.fx, revolutions=1.27)
    np.testing.assert_array_equal(poses, ref["poses"])
    np.testing.assert_array_equal(images[:, 0], np.clip(np.stack(ref["left"]), 0, 255)
                                  .astype(np.uint8))
    np.testing.assert_array_equal(images[:, 1], np.clip(np.stack(ref["right"]), 0, 255)
                                  .astype(np.uint8))
