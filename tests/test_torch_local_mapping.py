"""Parity of the port's local-mapping stages with the JAX package:
triangulation with the covisible neighbors, duplicate fusion, keyframe
culling and point culling (engine/local_mapping.py).

Integer and boolean state (links, validity, slots, parents, counts,
the culled keyframe) is held exactly; triangulated points to 1e-3 of
their norm: the closed-form DLT solves 3x3 normal equations in float32,
whose entries reach 1e12 at these pixel scales, and the two packages
round them in another order (measured: up to 1.8e-4 of the norm, 7% of
the points beyond 1e-4). Normals and distance ranges are computed from
those points: normals atol 1e-4 (measured 2.2e-5), distance ranges
rtol 1e-3.

`fuse_round` is held to both branches of the JAX function: its dense
kill-list sweep (at most FUSE_SWEEP_CAP = 1024 dead slots) and its
gather (more), which the port always takes.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.engine import local_mapping as jlm
from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu.slam_map import covisibility as jcov
from orb_slam2_test_tpu.slam_map import mapstate as jms
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.engine import local_mapping as tlm
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.geometry.se3 import se3_exp
from orb_slam2_test_tpu_torch.slam_map import covisibility as tcov
from orb_slam2_test_tpu_torch.slam_map import mapstate as tms

from test_torch_ba_grid import assert_points_close
from test_torch_insert_parts import assert_maps_equal, jmap

torch.set_num_threads(2)

CAM = PinholeCamera(fx=256.0, fy=256.0, cx=160.0, cy=120.0, width=320, height=240)
JCAM = JCam(**CAM._asdict())
FLOATS = ("pt_xyz", "pt_normal", "pt_min_dist", "pt_max_dist")


def assert_maps_close(jm, tm, links=1.0, points=dict(rtol=1e-3, frac=1.0, rtol_all=1e-3)):
    """Integer state exact (links on >= `links` of the entries), poses
    atol 1e-4, points by `assert_points_close(**points)`."""
    b = entry.map_to_numpy(tm)
    for name in jms.MapState._fields:
        a = np.asarray(getattr(jm, name))
        if name == "kf_pt_idx":
            assert (a == b[name]).mean() >= links, (a != b[name]).sum()
        elif name in ("kf_Tcw", "kf_Tcp"):
            np.testing.assert_allclose(b[name], a, atol=1e-4, err_msg=name)
        elif name not in FLOATS:
            np.testing.assert_array_equal(b[name], a, err_msg=name)
    live = np.asarray(jm.pt_valid) & b["pt_valid"]
    assert_points_close(np.asarray(jm.pt_xyz)[live], b["pt_xyz"][live], **points)
    np.testing.assert_allclose(b["pt_normal"][live], np.asarray(jm.pt_normal)[live], atol=1e-4)
    for name in ("pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(b[name][live], np.asarray(getattr(jm, name))[live],
                                   rtol=1e-3, err_msg=name)


def _project(T, X, cam=CAM):
    pc = X @ T[:3, :3].T + T[:3, 3]
    return np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                     cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], 1)


def _scene_map(seed, n_kf=5, n_pts=300, linked_frac=0.5, cap=None, cam=CAM, dup_frac=0.0):
    """n_kf keyframes 0.25 m apart along x, slightly rotated, observing
    a cloud at 4-9 m with 0.3 px noise and shared descriptors (a few
    flipped bits per view). A `linked_frac` share of the points exist in
    the map and are linked; the other features are free, so the new
    keyframe can triangulate them. dup_frac of the linked points get a
    duplicate point slot linked from the last keyframe only (work for
    fusion)."""
    rng = np.random.default_rng(seed)
    cap = cap or tms.MapCapacity(max_keyframes=8, max_features=256, max_points=1024)
    m = entry.map_to_numpy(tms.make_empty_map(cap))
    N = cap.max_features
    X = rng.uniform([-3, -2, 4], [3, 2, 9], (n_pts, 3))
    desc = rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32)
    exists = rng.uniform(size=n_pts) < linked_frac
    slot = np.full(n_pts, -1)
    slot[exists] = np.arange(exists.sum())
    n_live = int(exists.sum())
    n_dup = int(dup_frac * n_live)
    dup_of = rng.choice(np.flatnonzero(exists), n_dup, replace=False)
    dup_slot = n_live + np.arange(n_dup)
    for k in range(n_kf):
        T = se3_exp(torch.tensor([0.25 * k, 0.02 * k, 0.0, 0.01 * k, -0.02 * k, 0.0])).numpy()
        uv = _project(T, X, cam)
        inside = (uv[:, 0] > 5) & (uv[:, 0] < cam.width - 5) & (uv[:, 1] > 5) & (uv[:, 1] < cam.height - 5)
        pts = rng.permutation(np.flatnonzero(inside & (rng.uniform(size=n_pts) < 0.9)))[:N]
        n = pts.size
        d = desc[pts].copy()
        d[:, 0] ^= rng.integers(0, 2**4, n, dtype=np.uint32)
        m["kf_uv"][k, :n] = uv[pts] + rng.normal(0, 0.3, (n, 2))
        m["kf_desc"][k, :n] = d
        m["kf_level"][k, :n] = rng.integers(0, 2, n)
        m["kf_kp_valid"][k, :n] = True
        row = slot[pts]
        if k == n_kf - 1 and n_dup:
            dup_map = dict(zip(dup_of.tolist(), dup_slot.tolist()))
            row = np.array([dup_map.get(p, r) for p, r in zip(pts.tolist(), row.tolist())])
        m["kf_pt_idx"][k, :n] = row
        m["kf_Tcw"][k] = T
        m["kf_valid"][k] = True
        m["kf_frame_id"][k] = 10 + k
    live = np.flatnonzero(exists)
    src = np.concatenate([live, dup_of])
    n_all = src.size
    Xs = X[src]
    m["pt_xyz"][:n_all] = Xs
    m["pt_desc"][:n_all] = desc[src]
    dist = np.linalg.norm(Xs, axis=1)
    m["pt_normal"][:n_all] = Xs / dist[:, None]
    m["pt_max_dist"][:n_all] = dist * 1.2
    m["pt_min_dist"][:n_all] = dist * 1.2 / 1.2 ** 7
    m["pt_valid"][:n_all] = True
    m["pt_ref_kf"][:n_all] = 0
    m["pt_first_kf"][:n_all] = 10
    m["pt_visible"][:n_all] = 4.0
    m["pt_found"][:n_all] = 3.0
    m["n_kf"], m["n_pt"] = np.int32(n_kf), np.int32(n_all)
    return m, cap


@pytest.mark.parametrize("seed, kf, nbrs", [
    (0, 4, [3, 2, -1, 1]), (1, 2, [1, 3, 0, -1]), (2, 4, [-1, -1, -1, -1])])
def test_triangulate_with_neighbors(seed, kf, nbrs):
    arrays, cap = _scene_map(seed)
    jm, tm = jmap(arrays), entry.map_from_numpy(arrays, "cpu")
    jcap = jms.MapCapacity(**dataclasses.asdict(cap))
    j, jn = jlm.triangulate_with_neighbors(
        jm, JCAM, jnp.asarray(kf, jnp.int32), jnp.asarray(nbrs, jnp.int32), jcap, 4)
    got, n = tlm.triangulate_with_neighbors(
        tm, CAM, torch.tensor(kf, dtype=torch.int32), torch.tensor(nbrs), cap, 4)
    assert int(n) == int(jn)
    assert_maps_close(j, got)
    if max(nbrs) >= 0:
        assert int(n) > 20  # the neighbors' links followed
        assert ((got.kf_pt_idx.numpy() >= 0) & (arrays["kf_pt_idx"] < 0))[nbrs[0]].sum() > 0


# ---------------------------------------------------------------------------
# fuse_round
# ---------------------------------------------------------------------------


def _fuse_case(seed, n_cull):
    """A scene whose last keyframe linked duplicates of 30% of the
    points, plus 3000 extra points linked by the first keyframes, of
    which n_cull are culled without detaching (as the insertion does
    before fusion): the JAX package's kill list then holds n_cull plus
    the fusion's losers."""
    cap = tms.MapCapacity(max_keyframes=8, max_features=512, max_points=4096)
    arrays, _ = _scene_map(seed, n_kf=5, n_pts=300, linked_frac=0.6, cap=cap, dup_frac=0.3)
    rng = np.random.default_rng(seed)
    n0 = int(arrays["n_pt"])
    extra = n0 + np.arange(3000)
    arrays["pt_xyz"][extra] = rng.uniform([-3, -2, 4], [3, 2, 9], (3000, 3))
    arrays["pt_valid"][extra] = True
    arrays["pt_desc"][extra] = rng.integers(0, 2**32, (3000, 8), dtype=np.uint32)
    for k in range(2):  # the extra points' links, in free feature slots
        row = arrays["kf_pt_idx"][k]
        free = np.flatnonzero(~arrays["kf_kp_valid"][k])[:200]
        row[free] = rng.choice(extra, free.size, replace=False)
    arrays["n_pt"] = np.int32(n0 + 3000)
    dead = np.zeros(cap.max_points, bool)
    dead[rng.choice(extra, n_cull, replace=False)] = True
    jm = jmap(arrays)
    obs = jcov.observation_counts(jm)
    jm = jm._replace(pt_valid=jm.pt_valid & ~jnp.asarray(dead))
    return jm, obs, dead, cap


@pytest.mark.parametrize("n_cull, seed", [(0, 0), (200, 1), (2000, 2)])
def test_fuse_round(n_cull, seed):
    """n_cull 0 and 200: the JAX package's dense sweep (kill list <=
    1024); 2000: its gather."""
    jm, obs, dead, cap = _fuse_case(seed, n_cull)
    nbrs = jnp.asarray([3, 2, -1, 1], jnp.int32)
    kf = 4
    j = jax.jit(jlm.fuse_round, static_argnames=("cam", "n_nbrs"))(
        jm, JCAM, jnp.asarray(kf, jnp.int32), nbrs, obs, n_nbrs=4,
        dead_mask=jnp.asarray(dead))
    tm = entry.map_from_numpy(jm, "cpu")
    got = tlm.fuse_round(tm, CAM, torch.tensor(kf, dtype=torch.int32),
                         torch.tensor(np.asarray(nbrs)), torch.tensor(np.asarray(obs)), 4)
    assert int(got[1]) == int(j[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(j[2]))
    assert_maps_equal(j[0], got[0])
    n_kill = int((np.asarray(jm.pt_valid) != np.asarray(j[0].pt_valid)).sum()) + n_cull
    assert (n_kill > jlm.FUSE_SWEEP_CAP) == (n_cull > jlm.FUSE_SWEEP_CAP)
    # fusion worked: duplicates merged (losers erased), links moved on
    assert int(got[1]) > 20
    assert int(tm.n_pt) - int(got[0].n_pt) > 20
    # no live link to a dead slot
    idx = got[0].kf_pt_idx.numpy()
    assert got[0].pt_valid.numpy()[idx[idx >= 0]].all()


def test_fuse_round_matches_sequential_case():
    """tests/test_local_mapping.py's fuse_round case: two keyframes at
    one pose with duplicate points, a third without landmarks."""
    rng = np.random.default_rng(0)
    cap = tms.MapCapacity(max_keyframes=8, max_features=16, max_points=64)
    n = 6
    xyz = np.stack([np.linspace(-1.0, 1.0, n), np.zeros(n), np.full(n, 5.0)], -1).astype(np.float32)
    uv = _project(np.eye(4), xyz)
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    m = entry.map_to_numpy(tms.make_empty_map(cap))
    m["pt_xyz"][:2 * n] = np.concatenate([xyz, xyz])
    m["pt_desc"][:2 * n] = np.concatenate([desc, desc])
    m["pt_normal"][:2 * n] = [0.0, 0.0, 1.0]
    dist = np.linalg.norm(xyz, axis=1)
    m["pt_max_dist"][:2 * n] = np.concatenate([dist, dist])
    m["pt_min_dist"][:2 * n] = np.concatenate([dist, dist]) / 1.2 ** 7
    m["pt_valid"][:2 * n] = True
    for k, row in enumerate([np.arange(n), n + np.arange(n), np.full(n, -1)]):
        m["kf_uv"][k, :n] = uv
        m["kf_desc"][k, :n] = desc
        m["kf_kp_valid"][k, :n] = True
        m["kf_pt_idx"][k, :n] = row
        m["kf_valid"][k] = True
    m["n_kf"], m["n_pt"] = np.int32(3), np.int32(2 * n)
    jm, tm = jmap(m), entry.map_from_numpy(m, "cpu")
    obs = jcov.observation_counts(jm)
    j = jax.jit(jlm.fuse_round, static_argnames=("cam", "n_nbrs"))(
        jm, JCAM, jnp.asarray(0, jnp.int32), jnp.asarray([1, 2, -1], jnp.int32), obs, n_nbrs=3)
    got = tlm.fuse_round(tm, CAM, torch.tensor(0), torch.tensor([1, 2, -1]),
                         tcov.observation_counts(tm), 3)
    assert_maps_equal(j[0], got[0])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(j[2]))
    r0 = got[0].kf_pt_idx[0, :n].numpy()
    assert int(got[0].pt_valid.sum()) == n and (got[0].kf_pt_idx[1, :n].numpy() == r0).all()
    assert (np.sort(got[0].kf_pt_idx[2, :n].numpy()) == np.sort(r0)).all()


# ---------------------------------------------------------------------------
# keyframe and point culling
# ---------------------------------------------------------------------------


def _stacked(n_kf, n_pts=16, force_ref=None):
    """tests/test_local_mapping.py's stacked keyframes: n_kf keyframes
    1 cm apart, all observing the same n_pts points at level 0."""
    rng = np.random.default_rng(n_kf)
    cap = tms.MapCapacity(max_keyframes=8, max_features=16, max_points=64)
    m = entry.map_to_numpy(tms.make_empty_map(cap))
    xyz = np.stack([np.linspace(-1.0, 1.0, n_pts), np.zeros(n_pts), np.full(n_pts, 5.0)], -1)
    m["pt_xyz"][:n_pts] = xyz
    m["pt_valid"][:n_pts] = True
    m["pt_ref_kf"][:n_pts] = 0 if force_ref is None else force_ref
    for k in range(n_kf):
        m["kf_Tcw"][k, 0, 3] = 0.01 * k
        m["kf_uv"][k, :n_pts] = _project(m["kf_Tcw"][k], xyz)
        m["kf_desc"][k] = rng.integers(0, 2**32, (16, 8), dtype=np.uint32)
        m["kf_kp_valid"][k, :n_pts] = True
        m["kf_pt_idx"][k, :n_pts] = np.arange(n_pts)
        m["kf_valid"][k] = True
        m["kf_parent"][k] = k - 1
    m["n_kf"], m["n_pt"] = np.int32(n_kf), np.int32(n_pts)
    return m


@pytest.mark.parametrize("n_kf, force_ref, lvl_bm, covis, enable", [
    (5, None, False, False, None), (5, None, True, True, None), (5, 2, True, False, None),
    (5, 3, False, True, None), (3, None, True, True, None), (5, None, True, True, False)])
def test_cull_keyframes(n_kf, force_ref, lvl_bm, covis, enable):
    """The cases of tests/test_local_mapping.py (one redundant keyframe
    culled; point references re-homed to a surviving observer; nothing
    culled with 3 keyframes), with and without the level bitmap and a
    precomputed covisibility row, and a disabled cull."""
    arrays = _stacked(n_kf, force_ref=force_ref)
    jm, tm = jmap(arrays), entry.map_from_numpy(arrays, "cpu")
    cur = n_kf - 1
    jkw, tkw = {}, {}
    if lvl_bm:
        jkw["lvl_bm"], tkw["lvl_bm"] = jcov.build_observer_bitmap(jm), tcov.build_observer_bitmap(tm)
    if covis:
        jkw["covis_row"] = jcov.covisibility_weights(jm, jnp.asarray([cur]))[0]
        tkw["covis_row"] = tcov.covisibility_weights(tm, torch.tensor([cur]))[0]
    if enable is not None:
        jkw["enable"], tkw["enable"] = jnp.asarray(enable), torch.tensor(enable)
    j, jc = jlm.cull_keyframes(jm, jnp.asarray(cur, jnp.int32), **jkw)
    got, c = tlm.cull_keyframes(tm, torch.tensor(cur, dtype=torch.int32), **tkw)
    assert int(c) == int(jc) and c.dtype == torch.int32
    assert_maps_equal(j, got, float_atol=1e-6)
    culled = n_kf == 5 and enable is None
    assert (int(c) in (1, 2, 3)) if culled else int(c) == -1
    if force_ref is not None and int(c) == force_ref:
        refs = got.pt_ref_kf.numpy()[got.pt_valid.numpy()]
        assert (refs >= 0).all() and (refs != force_ref).all()


@pytest.mark.parametrize("detach", [True, False])
def test_cull_points(detach):
    """Found-ratio and age/observation culling on a bench map with
    creation stamps spread over the keyframes' frame ids."""
    cfg = dict(n_features=64, max_keyframes=16, max_points=512)
    from orb_slam2_test_tpu_torch.engine.tracking import TrackerConfig
    arrays = entry.bench_map(TrackerConfig(**cfg), 14, 400, 7)
    rng = np.random.default_rng(7)
    arrays["kf_frame_id"][:14] = np.sort(rng.choice(100, 14, replace=False))
    arrays["kf_valid"][5] = False  # a culled keyframe drops out of the ranks
    arrays["pt_first_kf"][:] = rng.integers(0, 100, arrays["pt_first_kf"].size)
    arrays["pt_found"][:] = rng.uniform(0, 10, arrays["pt_found"].size).astype(np.float32)
    jm, tm = jmap(arrays), entry.map_from_numpy(arrays, "cpu")
    for cur in (13, 9):
        j = jlm.cull_points(jm, jnp.asarray(cur, jnp.int32), detach=detach)
        got = tlm.cull_points(tm, torch.tensor(cur, dtype=torch.int32), detach=detach)
        if detach:
            assert_maps_equal(j, got)
        else:
            assert_maps_equal(j[0], got[0])
            for a, b in zip(j[1:], got[1:]):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            # counts passed in are used as given
            obs = jcov.observation_counts(jm)
            j2 = jlm.cull_points(jm, jnp.asarray(cur, jnp.int32), obs_counts=obs + 1, detach=False)
            g2 = tlm.cull_points(tm, torch.tensor(cur, dtype=torch.int32),
                                 obs_counts=torch.tensor(np.asarray(obs)) + 1, detach=False)
            np.testing.assert_array_equal(g2[2].numpy(), np.asarray(j2[2]))
        culled = int(tm.n_pt) - int((got if detach else got[0]).n_pt)
        assert 20 < culled < 380
