"""Parity of the port's keyframe-insertion program `_grow_map_device`
with the JAX package at KITTI image geometry: a full insert
(rebuild=True) and a light one, as the bench drives them (stereo, depth
points through the close gate).

`entry.kitti_insert_scene` (1241x376, 2000 features) at a map of K = 64
keyframes and P = 16,384 points, 40 and 12,000 live: the cut from the
bench's K = 384, P = 131,072 keeps the CPU run short; full capacity
runs on the card (chip_smoke.py [10]). The port tracks view 1 and
inserts it (full), then tracks view 2 against the grown map and inserts
it (light); each insert's inputs also go through the JAX function.

Tolerances:
- kf id, culled keyframe, n_pt, validity, parents, creation stamps,
  descriptors and the bitmap's incidence: exact;
- feature links: equal on >= 99% of the linked entries (the BA's chi2
  gate detaches links, and float order can move an observation across
  it);
- poses atol 1e-4 after the full insert; 2e-3 after the light one: its
  BA has two free keyframes, both packages take the same accept/reject
  steps, but 10 LM iterations still move the poses by centimetres each
  and float32 sums in another order leave them up to 9.6e-4 apart (its
  float32 conditioning, the same in both packages, is measured by
  `test_light_insert_conditioning_matches_jax`);
- points: 99% within 1e-3 of their norm, all within 1e-2 (closed-form
  triangulation in float32, and points the BA moves by metres; see
  tests/test_torch_local_mapping.py and tests/test_torch_ba_grid.py);
- normals atol 1e-4, distance ranges rtol 1e-3 (computed from those
  points).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.engine import tracking as jtracking
from orb_slam2_test_tpu.engine.frame import FrameData as JFrame
from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu.slam_map import mapstate as jms
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.slam_map.covisibility import build_observer_bitmap

from test_torch_ba_grid import assert_points_close

torch.set_num_threads(2)

CFG = dataclasses.replace(entry.KITTI_CFG, max_keyframes=64, max_points=16384)
INT_FIELDS = ("kf_valid", "kf_frame_id", "kf_level", "kf_kp_valid", "kf_parent",
              "kf_loop_edge", "pt_valid", "pt_desc", "pt_ref_kf", "pt_first_kf",
              "kf_desc", "n_kf", "n_pt", "pt_visible", "pt_found", "kf_uv", "kf_ur",
              "kf_depth", "kf_angle", "kf_timestamp")


def jax_inputs(m, bm, frame, *rest):
    """A port map, bitmap and frame (and tensors) as the JAX package's."""
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in entry.map_to_numpy(m).items()})
    f = [x.numpy() for x in frame]
    f[4] = f[4].view(np.uint32)
    return (jm, jnp.asarray(bm.numpy()), JFrame(*[jnp.asarray(x) for x in f])) + tuple(
        jnp.asarray(x.numpy()) if torch.is_tensor(x) else x for x in rest)


def assert_insert_close(jout, tout, pose_atol=1e-4):
    """(map, kf, culled, n_pt, bitmap) of both packages, with the
    tolerances of the module docstring."""
    jm, tm = jout[0], entry.map_to_numpy(tout[0])
    for i in (1, 2, 3):
        assert int(tout[i]) == int(jout[i]), i
    for name in INT_FIELDS:
        np.testing.assert_array_equal(tm[name], np.asarray(getattr(jm, name)), err_msg=name)
    a, b = np.asarray(jm.kf_pt_idx), tm["kf_pt_idx"]
    linked = (a >= 0) | (b >= 0)
    assert (a == b)[linked].mean() >= 0.99, (a != b).sum()
    np.testing.assert_allclose(tm["kf_Tcw"], np.asarray(jm.kf_Tcw), atol=pose_atol)
    np.testing.assert_allclose(tm["kf_Tcp"], np.asarray(jm.kf_Tcp), atol=pose_atol)
    live = tm["pt_valid"]
    assert_points_close(np.asarray(jm.pt_xyz)[live], tm["pt_xyz"][live],
                        rtol=1e-3, frac=0.99, rtol_all=1e-2)
    np.testing.assert_allclose(tm["pt_normal"][live], np.asarray(jm.pt_normal)[live], atol=1e-4)
    for name in ("pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(tm[name][live], np.asarray(getattr(jm, name))[live],
                                   rtol=1e-3, err_msg=name)
    jb, tb = np.asarray(jout[4]) > 0, tout[4].numpy() > 0
    # incidence differs only where a link does
    assert (jb != tb).sum() <= (a != b).sum()


def assert_map_invariants(out):
    """n_kf counts the live keyframes; no live link points at a dead slot."""
    m = out[0]
    assert int(m.n_kf) == int(m.kf_valid.sum())
    assert int(m.n_pt) == int(m.pt_valid.sum())
    idx = m.kf_pt_idx[m.kf_valid]
    assert m.pt_valid[idx[idx >= 0].long()].all()


@pytest.fixture(scope="module")
def kitti_run():
    """The port's track -> full insert -> track -> light insert on the
    KITTI insert scene, with copies of the first insert's inputs."""
    sc = entry.kitti_insert_scene(np.random.default_rng(1), "cpu", CFG, 40, 12000)
    m0 = entry.map_from_numpy(sc.map, "cpu")
    bm0 = build_observer_bitmap(m0)
    copies = ([x.clone() for x in m0], bm0.clone())
    f1, o1 = entry.track_insert_view(
        sc, 1, m0, bm0, entry.frame_from_numpy(sc.last_frame, "cpu"),
        torch.from_numpy(sc.last_feat_pt), torch.tensor(0, dtype=torch.int32), cfg=CFG)
    g1 = entry.grow_map_step(m0, bm0, f1, o1[5], o1[7], 1.0, 1, sc.close_depth, True, cfg=CFG)
    f2, o2 = entry.track_insert_view(sc, 2, g1[0], g1[4], f1, o1[7], g1[1], cfg=CFG)
    g1_copy = ([x.clone() for x in g1[0]], g1[4].clone())
    g2 = entry.grow_map_step(g1[0], g1[4], f2, o2[5], o2[7], 2.0, 2, sc.close_depth, False,
                             cfg=CFG)
    return dict(sc=sc, m0=m0, bm0=bm0, copies=copies, f1=f1, o1=o1, g1=g1, f2=f2, o2=o2,
                g1_copy=g1_copy, g2=g2)


def _jax_grow(inputs, cd, rebuild, cam=entry.KITTI_CAM, cfg=CFG, use_depth=True):
    jcam = JCam(**cam._asdict())
    jcfg = jtracking.TrackerConfig(**dataclasses.asdict(cfg))
    jm, jbm, jf, Tcw, feat, ts, fid = inputs
    return jtracking._grow_map_device(
        jcam, jcfg, jm, jbm, jf, Tcw, feat, jnp.float32(ts), jnp.int32(fid),
        jnp.float32(cd), use_depth, use_depth, rebuild=rebuild)


def test_grow_map_stereo_full(kitti_run):
    r = kitti_run
    sc, o1, g1 = r["sc"], r["o1"], r["g1"]
    jout = _jax_grow(jax_inputs(r["m0"], r["bm0"], r["f1"], o1[5], o1[7], 1.0, 1),
                     sc.close_depth, True)
    assert_insert_close(jout, g1)
    assert_map_invariants(g1)
    # the full insert's bitmap is a fresh one, minus a culled column
    np.testing.assert_array_equal(g1[4].numpy() > 0, build_observer_bitmap(g1[0]).numpy() > 0)
    # the insert did real work: 100 depth points (the tied "100 nearest"
    # of the close gate) and triangulated ones, with keyframe 0 the parent
    assert int(g1[3]) - int(r["m0"].n_pt) > 150
    kf = int(g1[1])
    assert kf == 40 and int(g1[0].kf_parent[kf]) == 0
    n_tri = int((g1[0].pt_valid & (g1[0].pt_ref_kf == kf)).sum()) - 100
    assert n_tri > 50
    # the caller's map and bitmap are unchanged
    for a, b in zip(r["m0"], r["copies"][0]):
        assert torch.equal(a, b)
    assert torch.equal(r["bm0"], r["copies"][1])


def test_grow_map_stereo_light(kitti_run):
    r = kitti_run
    sc, o2, g1, g2 = r["sc"], r["o2"], r["g1"], r["g2"]
    jout = _jax_grow(jax_inputs(g1[0], g1[4], r["f2"], o2[5], o2[7], 2.0, 2),
                     sc.close_depth, False)
    assert_insert_close(jout, g2, pose_atol=2e-3)
    assert_map_invariants(g2)
    assert int(g2[1]) == 41 and int(g2[2]) == -1
    # a light insert keeps the patched bitmap: dead slots' rows zeroed
    assert not (g2[4].numpy()[~g2[0].pt_valid.numpy()] > 0).any()
    for a, b in zip(g1[0], r["g1_copy"][0]):
        assert torch.equal(a, b)
    assert torch.equal(g1[4], r["g1_copy"][1])


def test_light_insert_conditioning_matches_jax(kitti_run):
    """The light insert's local BA is ill-conditioned in float32 in both
    packages: moving the tracked pose by 1e-6 m moves its free keyframes
    by millimetres in the JAX package and in the port alike. Held here:
    the port is no more than 10x as sensitive as the reference, and no
    outcome leaves 1 cm. Run with -s for the readings PERF.md quotes."""
    r = kitti_run
    sc, o2, g1 = r["sc"], r["o2"], r["g1"]
    live = g1[0].kf_valid.numpy().copy()
    live[int(r["g2"][1])] = True

    def light(T):
        t = entry.map_to_numpy(entry.grow_map_step(
            g1[0], g1[4], r["f2"], T, o2[7], 2.0, 2, sc.close_depth, False, cfg=CFG)[0])
        j = _jax_grow(jax_inputs(g1[0], g1[4], r["f2"], T, o2[7], 2.0, 2), sc.close_depth, False)
        return t["kf_Tcw"][live], np.asarray(j[0].kf_Tcw)[live]

    t0, j0 = light(o2[5])
    spread = {"port": [], "jax": [], "port vs jax": [float(np.abs(t0 - j0).max())]}
    for axis in range(3):
        T = o2[5].clone()
        T[axis, 3] += 1e-6
        t, j = light(T)
        spread["port"].append(float(np.abs(t - t0).max()))
        spread["jax"].append(float(np.abs(j - j0).max()))
        spread["port vs jax"].append(float(np.abs(t - j).max()))
    print("light insert, live poses moved by a 1e-6 m change of the tracked pose "
          "along x, y, z; port vs jax unmoved, then moved:",
          {k: ["%.3e" % x for x in v] for k, v in spread.items()})
    assert max(spread["jax"]) > 0.0  # the reference moves too
    assert max(spread["port"]) <= 10 * max(spread["jax"]) + 1e-4
    assert max(max(v) for v in spread.values()) < 1e-2


def test_tracked_views_land_on_the_truth(kitti_run):
    """Both tracked frames within 1 cm of their true poses, the second
    against the grown map."""
    r = kitti_run
    for o, T in ((r["o1"], r["sc"].T_true[1]), (r["o2"], r["sc"].T_true[2])):
        assert np.abs(o[5].numpy() - T)[:3, 3].max() < 1e-2
        assert int(o[6]) > 400
