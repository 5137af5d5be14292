"""Parity of the port's keyframe-insertion building blocks with the JAX
package: closed-form inverses, the Huber loss, triangulation, the map's
mutations, covisibility, triangulation matching and point maintenance.

The cases are those of tests/test_mapstate.py, test_spanning_tree.py,
test_maintenance.py and test_ba_grid.py, plus seeded bench maps.
Tolerances:
- integer and boolean state, slots, links, parents, descriptors and
  `search_for_triangulation`'s matches: exact;
- copied floats (poses, keypoints written into a slot): exact;
- closed-form inverses, the Huber loss, triangulation checks, normals:
  atol 1e-5 (float32 in another operation order);
- triangulated points: rtol 1e-4 of the point's norm;
- distance ranges: rtol 1e-5. Where a reference keyframe links two
  features to one point, two writes hit one slot and which wins is
  unspecified, in XLA as in torch; those maps drop such duplicate links
  first (`_dedupe_rows`).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.engine import matchers as jmatch
from orb_slam2_test_tpu.geometry import linalg as jlin
from orb_slam2_test_tpu.geometry import robust as jrob
from orb_slam2_test_tpu.geometry import triangulation as jtri
from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu.ops import matching as jmatching
from orb_slam2_test_tpu.slam_map import covisibility as jcov
from orb_slam2_test_tpu.slam_map import maintenance as jmaint
from orb_slam2_test_tpu.slam_map import mapstate as jms
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.engine import matchers as tmatch
from orb_slam2_test_tpu_torch.engine import tracking as ttracking
from orb_slam2_test_tpu_torch.geometry import linalg as tlin
from orb_slam2_test_tpu_torch.geometry import robust as trob
from orb_slam2_test_tpu_torch.geometry import triangulation as ttri
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.ops import matching as tmatching
from orb_slam2_test_tpu_torch.slam_map import covisibility as tcov
from orb_slam2_test_tpu_torch.slam_map import maintenance as tmaint
from orb_slam2_test_tpu_torch.slam_map import mapstate as tms

torch.set_num_threads(2)

CAP = tms.MapCapacity(max_keyframes=8, max_features=16, max_points=64)
JCAP = jms.MapCapacity(**dataclasses.asdict(CAP))
CAM = PinholeCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
SMALL_CFG = dict(n_features=64, max_keyframes=16, max_points=512)


def t(a):
    """numpy (or JAX) -> torch on the CPU, uint32 as int32 bit patterns."""
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def jmap(arrays) -> jms.MapState:
    return jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def assert_maps_equal(jm, tm, float_atol=0.0):
    """Every field equal; float fields within float_atol."""
    b = entry.map_to_numpy(tm)
    for name in jms.MapState._fields:
        a = np.asarray(getattr(jm, name))
        assert b[name].dtype == a.dtype and b[name].shape == a.shape, name
        if a.dtype.kind == "f" and float_atol:
            np.testing.assert_allclose(b[name], a, atol=float_atol, err_msg=name)
        else:
            np.testing.assert_array_equal(b[name], a, err_msg=name)


def _dedupe_rows(arrays):
    """Unlink every second and later feature of a keyframe row that
    links a point already linked in that row."""
    idx = arrays["kf_pt_idx"]
    for row in idx:
        _, first = np.unique(row, return_index=True)
        dup = np.ones(row.size, bool)
        dup[first] = False
        row[dup & (row >= 0)] = -1
    return arrays


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def _spd(rng, n, k):
    A = rng.normal(size=(n, k, k)).astype(np.float32)
    return A @ np.swapaxes(A, -1, -2) + k * np.eye(k, dtype=np.float32)


def test_inv3x3(rng):
    A = _spd(rng, 32, 3)
    A[0] = 0.0  # det 0: the 1e-12 guard
    A[1] = [[1, 2, 3], [2, 4, 6], [1, 0, 1]]  # rank 2, adjugate != 0
    j = np.asarray(jlin.inv3x3(jnp.asarray(A)))
    got = tlin.inv3x3(t(A)).numpy()
    np.testing.assert_allclose(got[2:], j[2:], atol=1e-5)
    np.testing.assert_array_equal(got[0], j[0])
    np.testing.assert_allclose(got[1], j[1], rtol=1e-6)  # ~1e12 entries
    assert np.abs(got[1]).max() > 1e10


def test_inv6x6_spd(rng):
    A = _spd(rng, 16, 6)
    j = np.asarray(jlin.inv6x6_spd(jnp.asarray(A)))
    got = tlin.inv6x6_spd(t(A)).numpy()
    np.testing.assert_allclose(got, j, atol=1e-5)
    np.testing.assert_allclose(A @ got, np.broadcast_to(np.eye(6), A.shape), atol=1e-2)


def test_huber_loss(rng):
    chi2 = np.concatenate([rng.uniform(0, 20, 200), [0.0, 5.991, 7.815]]).astype(np.float32)
    stereo = rng.uniform(size=chi2.size) < 0.5
    for delta in (jrob.HUBER_MONO, jrob.HUBER_STEREO):
        np.testing.assert_allclose(
            trob.huber_loss(t(chi2), delta).numpy(),
            np.asarray(jrob.huber_loss(jnp.asarray(chi2), delta)), atol=1e-5)
    jd = jnp.where(jnp.asarray(stereo), jrob.HUBER_STEREO, jrob.HUBER_MONO)
    td = torch.where(t(stereo), trob.HUBER_STEREO, trob.HUBER_MONO)
    np.testing.assert_allclose(trob.huber_loss(t(chi2), td).numpy(),
                               np.asarray(jrob.huber_loss(jnp.asarray(chi2), jd)), atol=1e-5)


def _two_view(rng, n=200, noise=0.0):
    """The closed-form DLT case of tests/test_ba_grid.py: points seen by
    two cameras 0.3 m apart."""
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.eye(4, dtype=np.float32)
    T2[:3, 3] = [-0.3, 0.05, 0.02]
    P1 = (K @ T1[:3]).astype(np.float32)
    P2 = (K @ T2[:3]).astype(np.float32)
    X = rng.uniform([-2, -2, 3], [2, 2, 10], (n, 3))
    h = np.concatenate([X, np.ones((n, 1))], axis=1)
    uv1 = (P1 @ h.T).T
    uv2 = (P2 @ h.T).T
    uv1 = (uv1[:, :2] / uv1[:, 2:3] + rng.normal(0, noise, (n, 2))).astype(np.float32)
    uv2 = (uv2[:, :2] / uv2[:, 2:3] + rng.normal(0, noise, (n, 2))).astype(np.float32)
    return T1, T2, P1, P2, X, uv1, uv2


@pytest.mark.parametrize("noise", [0.0, 0.7])
def test_triangulate_dlt_and_checks(rng, noise):
    T1, T2, P1, P2, X, uv1, uv2 = _two_view(rng, noise=noise)
    n = X.shape[0]
    jP1, jP2 = (jnp.broadcast_to(jnp.asarray(P), (n, 3, 4)) for P in (P1, P2))
    tP1, tP2 = (t(P).expand(n, 3, 4) for P in (P1, P2))
    np.testing.assert_array_equal(
        ttri._dlt_system(tP1, tP2, t(uv1), t(uv2)).numpy(),
        np.asarray(jtri._dlt_system(jP1, jP2, jnp.asarray(uv1), jnp.asarray(uv2))))
    j = np.asarray(jtri.triangulate_dlt(jP1, jP2, jnp.asarray(uv1), jnp.asarray(uv2)))
    got = ttri.triangulate_dlt(tP1, tP2, t(uv1), t(uv2)).numpy()
    err = np.linalg.norm(got - j, axis=1) / np.linalg.norm(j, axis=1)
    assert err.max() <= 1e-4, err.max()
    if noise == 0.0:
        np.testing.assert_allclose(got, X, atol=5e-2)

    # the acceptance gates on a point set with failures of every kind
    pts = j.copy()
    pts[:10, 2] *= -1  # behind the cameras
    pts[10:20] *= 50  # no parallax
    jcam = JCam(**CAM._asdict())
    sig2 = (1.2 ** rng.integers(0, 8, n) ** 2).astype(np.float32)
    jc = jtri.triangulation_checks(
        jcam, jnp.broadcast_to(jnp.asarray(T1), (n, 4, 4)),
        jnp.broadcast_to(jnp.asarray(T2), (n, 4, 4)), jnp.asarray(pts),
        jnp.asarray(uv1), jnp.asarray(uv2), sigma2_1=jnp.asarray(sig2), sigma2_2=1.0)
    tc = ttri.triangulation_checks(
        CAM, t(T1).expand(n, 4, 4), t(T2).expand(n, 4, 4), t(pts), t(uv1), t(uv2),
        sigma2_1=t(sig2), sigma2_2=1.0)
    np.testing.assert_array_equal(tc.ok.numpy(), np.asarray(jc.ok))
    for name in ("parallax_cos", "z1", "z2"):
        np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                   atol=1e-5, err_msg=name)
    ok = tc.ok.numpy()
    assert ok.sum() > n // 2 and not ok[:20].any()


def test_th_low():
    assert tmatching.TH_LOW == jmatching.TH_LOW == 50


# ---------------------------------------------------------------------------
# map mutations (the cases of tests/test_mapstate.py, test_spanning_tree.py)
# ---------------------------------------------------------------------------


def _frame_args(n, pt_idx=None, level=None, T=None, ts=0.0, fid=0, seed=0):
    """(Tcw, timestamp, frame_id, uv, level, angle, ur, depth, desc,
    kp_valid, pt_idx) as numpy, for add_keyframe."""
    r = np.random.default_rng(seed)
    N = CAP.max_features
    if pt_idx is None:
        pt_idx = np.full(N, -1, np.int32)
    return (
        np.eye(4, dtype=np.float32) if T is None else np.asarray(T, np.float32),
        np.float32(ts), np.int32(fid),
        r.uniform(0, 300, (N, 2)).astype(np.float32),
        (np.zeros(N, np.int32) if level is None else np.asarray(level, np.int32)),
        r.uniform(0, 6, N).astype(np.float32),
        np.full(N, -1.0, np.float32), np.full(N, -1.0, np.float32),
        r.integers(0, 2**32, (N, 8), dtype=np.uint32),
        np.arange(N) < n, np.asarray(pt_idx, np.int32),
    )


class Both:
    """One map in both packages, mutated in lockstep."""

    def __init__(self, cap=CAP):
        self.j = jms.make_empty_map(jms.MapCapacity(**dataclasses.asdict(cap)))
        self.t = tms.make_empty_map(cap)

    def add_keyframe(self, *args):
        self.j, kj = jms.add_keyframe(self.j, *[jnp.asarray(a) for a in args])
        targs = [t(a) for a in args]
        targs[1], targs[2] = float(args[1]), int(args[2])  # Python numbers
        self.t, kt = tms.add_keyframe(self.t, *targs)
        assert int(kj) == int(kt) and kt.dtype == torch.int32
        return int(kt)

    def add_points(self, *args):
        self.j, sj = jms.add_points(self.j, *[jnp.asarray(a) for a in args])
        self.t, st = tms.add_points(self.t, *[t(a) for a in args])
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        return st.numpy()

    def set_valid(self, ids):
        self.j = self.j._replace(pt_valid=self.j.pt_valid.at[jnp.asarray(ids)].set(True))
        self.t = self.t._replace(pt_valid=self.t.pt_valid.clone().index_fill_(0, t(ids), True))

    def check(self, float_atol=0.0):
        assert_maps_equal(self.j, self.t, float_atol)


def _points(rng, B):
    return (rng.normal(size=(B, 3)).astype(np.float32),
            rng.integers(0, 2**32, (B, 8), dtype=np.uint32),
            rng.normal(size=(B, 3)).astype(np.float32),
            rng.uniform(0, 1, B).astype(np.float32), rng.uniform(1, 2, B).astype(np.float32))


def test_add_keyframe_and_points(rng):
    b = Both()
    assert b.add_keyframe(*_frame_args(10, fid=3)) == 0
    assert b.add_keyframe(*_frame_args(12, ts=1.0, fid=7, seed=1)) == 1
    ok = np.array([True, True, False, True, True])
    slots = b.add_points(*_points(rng, 5), np.int32(1), ok)
    assert (slots >= 0).sum() == 4
    # per-row reference keyframes: creation stamps from their frame ids
    slots2 = b.add_points(*_points(rng, 3), np.array([0, 1, 0], np.int32), np.ones(3, bool))
    assert (slots2 == [2, 5, 6]).all()  # slot 2 was left free above
    b.check()
    # slot allocation: the lowest free slots, ascending
    tslots, tok = tms.alloc_point_slots(b.t, 70)
    jslots, jok = jms.alloc_point_slots(b.j, 70)
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


def test_add_points_capacity_pressure():
    b = Both()
    P = CAP.max_points
    B = P + 8
    rng = np.random.default_rng(4)
    b.set_valid(np.arange(0, P, 3))  # a third of the slots live
    slots = b.add_points(*_points(rng, B), np.int32(0), np.ones(B, bool))
    assert (slots >= 0).sum() == P - len(range(0, P, 3))
    b.check()


def test_add_keyframe_full_map_is_noop():
    b = Both()
    for i in range(CAP.max_keyframes):
        assert b.add_keyframe(*_frame_args(10, ts=i, fid=i, seed=i)) == i
    assert b.add_keyframe(*_frame_args(5, T=np.full((4, 4), 7.0), ts=99, fid=99)) == -1
    b.check()
    b.j = jms.erase_keyframe(b.j, jnp.int32(3))
    b.t = tms.erase_keyframe(b.t, torch.tensor(3))
    assert b.add_keyframe(*_frame_args(5, ts=100, fid=100)) == 3
    b.check()


def test_erase_points_detaches_observations():
    b = Both()
    row = np.full(CAP.max_features, -1, np.int32)
    row[[0, 4, 5]] = [3, 7, 3]
    b.add_keyframe(*_frame_args(10, pt_idx=row))
    b.set_valid([3, 7, 9])
    b.j = jms.erase_points(b.j, jnp.array([3, 9, 64]))
    b.t = tms.erase_points(b.t, torch.tensor([3, 9, 64]))  # 64 = P: ignored
    b.check()
    assert b.t.kf_pt_idx[0, 0] == -1 and b.t.kf_pt_idx[0, 4] == 7


def _three_kfs(b):
    """kf0 and kf1 share 6 points, kf1 and kf2 share 4 (test_spanning_tree)."""
    b.set_valid(np.arange(10))
    rows = [np.full(16, -1, np.int32) for _ in range(3)]
    rows[0][:6] = np.arange(6)
    rows[1][:6] = np.arange(6)
    rows[1][6:8] = [6, 7]
    rows[2][:4] = [4, 5, 6, 7]
    T2 = np.eye(4, dtype=np.float32)
    T2[0, 3] = 0.5
    T2[:3, :3] = np.asarray(entry.se3_exp(torch.tensor([0, 0, 0, 0.1, -0.2, 0.05]))[:3, :3])
    for i, (row, T) in enumerate(zip(rows, [None, None, T2])):
        b.add_keyframe(*_frame_args(8, pt_idx=row, T=T, ts=i, fid=i, seed=i))


def test_spanning_tree_parent_erase_and_loop_edges():
    b = Both()
    _three_kfs(b)
    for k in (1, 2, 2):  # the second call on kf2 must not reassign
        b.j = jcov.assign_parent(b.j, jnp.asarray(k))
        b.t = tcov.assign_parent(b.t, torch.tensor(k))
    b.check()
    assert b.t.kf_parent[1] == 0 and b.t.kf_parent[2] == 1
    # a loop edge to the victim is severed; live children adopt its parent
    b.j = jcov.add_loop_edge(b.j, jnp.asarray(0), jnp.asarray(1))
    b.t = b.t._replace(kf_loop_edge=t(np.asarray(b.j.kf_loop_edge)))
    b.j = jms.erase_keyframe(b.j, jnp.asarray(1))
    b.t = tms.erase_keyframe(b.t, torch.tensor(1))
    b.check(float_atol=1e-6)  # kf_Tcp: a 4x4 product
    assert b.t.kf_parent[2] == 0 and b.t.kf_loop_edge[0] == -1
    # erase a child whose parent has a rotation: kf_Tcp = Tcw @ Tp^-1
    b.j = jms.erase_keyframe(b.j, jnp.asarray(2))
    b.t = tms.erase_keyframe(b.t, torch.tensor(2))
    b.check(float_atol=1e-6)


def test_assign_parent_no_covisibility_stays_root():
    b = Both()
    b.add_keyframe(*_frame_args(8))
    b.j = jcov.assign_parent(b.j, jnp.asarray(0))
    b.t = tcov.assign_parent(b.t, torch.tensor(0))
    b.check()
    assert b.t.kf_parent[0] == -1


# ---------------------------------------------------------------------------
# covisibility
# ---------------------------------------------------------------------------


def _bench(seed, n_kf=14, n_pt=400):
    return entry.bench_map(ttracking.TrackerConfig(**SMALL_CFG), n_kf, n_pt, seed)


@pytest.mark.parametrize("seed", [0, 1])
def test_covisibility(seed):
    arrays = _bench(seed)
    jm, tm = jmap(arrays), entry.map_from_numpy(arrays, "cpu")
    np.testing.assert_array_equal(tcov.observation_counts(tm).numpy(),
                                  np.asarray(jcov.observation_counts(jm)))
    q = np.array([0, 3, 13, 15], np.int32)  # 15: an empty slot
    tw = tcov.covisibility_weights(tm, t(q))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jcov.covisibility_weights(jm, jnp.asarray(q))))
    assert tw.dtype == torch.int32
    bm_j, bm_t = jcov.build_observer_bitmap(jm), tcov.build_observer_bitmap(tm)
    for k in q:
        row = tcov.covis_row_from_bitmap(tm, bm_t, torch.tensor(int(k)))
        np.testing.assert_array_equal(
            row.numpy(), np.asarray(jcov.covis_row_from_bitmap(jm, bm_j, jnp.asarray(k))))
        # tied weights: the lowest slot first
        ids, w = tcov.best_covisible(tm, torch.tensor(int(k)), 6)
        jids, jw = jcov.best_covisible(jm, jnp.asarray(k), 6)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    # parents from a weight row, on keyframes without a parent
    arrays["kf_parent"][:] = -1
    jm, tm = jmap(arrays), entry.map_from_numpy(arrays, "cpu")
    for k in (0, 5, 13):
        jm = jcov.assign_parent(jm, jnp.asarray(k))
        tm = tcov.assign_parent(tm, torch.tensor(k))
    np.testing.assert_array_equal(tm.kf_parent.numpy(), np.asarray(jm.kf_parent))
    assert (tm.kf_parent.numpy()[[0, 5, 13]] >= 0).all()


# ---------------------------------------------------------------------------
# triangulation matching
# ---------------------------------------------------------------------------


def _kf_pair(rng, n=300, N=400):
    """Two keyframes 0.4 m apart viewing the same n points (shared
    descriptors with a few flipped bits), plus N - n unrelated features;
    a third of the features already linked."""
    X = rng.uniform([-3, -2, 4], [3, 2, 12], (n, 3))
    T2 = np.eye(4)
    T2[:3, :3] = np.asarray(entry.se3_exp(torch.tensor([0, 0, 0, 0.01, -0.03, 0.02]))[:3, :3])
    T2[:3, 3] = [-0.4, 0.02, 0.05]
    out = []
    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    for T in (np.eye(4), T2):
        pc = X @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                       CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], 1)
        uv = np.concatenate([uv + rng.normal(0, 0.5, uv.shape),
                             rng.uniform([0, 0], [640, 480], (N - n, 2))])
        d = np.concatenate([desc, rng.integers(0, 2**32, (N - n, 8), dtype=np.uint32)])
        d[:n, 0] ^= rng.integers(0, 2**8, n, dtype=np.uint32)  # up to 8 bit flips
        perm = rng.permutation(N)
        out += [uv[perm].astype(np.float32), d[perm], rng.integers(0, 4, N).astype(np.int32),
                rng.uniform(size=N) > 0.33]
    return out[:4], out[4:], np.eye(4, dtype=np.float32), T2.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_for_triangulation(seed):
    rng = np.random.default_rng(seed)
    kf1, kf2, T1, T2 = _kf_pair(rng)
    j12, jn = jmatch.search_for_triangulation(
        JCam(**CAM._asdict()), *[jnp.asarray(a) for a in kf1 + kf2],
        jnp.asarray(T1), jnp.asarray(T2))
    t12, tn = tmatch.search_for_triangulation(CAM, *[t(a) for a in kf1 + kf2], t(T1), t(T2))
    np.testing.assert_array_equal(t12.numpy(), np.asarray(j12))
    assert int(tn) == int(jn) and t12.dtype == torch.int32
    assert int(tn) > 30


# ---------------------------------------------------------------------------
# maintenance (the cases of tests/test_maintenance.py and bench maps)
# ---------------------------------------------------------------------------


def _posed_bench(seed):
    """A bench map with rotated keyframe poses, points in front of them,
    and no duplicate links within a keyframe row."""
    arrays = _dedupe_rows(_bench(seed))
    rng = np.random.default_rng(seed + 10)
    K = arrays["kf_Tcw"].shape[0]
    xi = np.concatenate([rng.uniform(-0.5, 0.5, (K, 3)), rng.uniform(-0.2, 0.2, (K, 3))], 1)
    arrays["kf_Tcw"] = entry.se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy()
    arrays["pt_ref_kf"][:] = np.where(rng.uniform(size=arrays["pt_ref_kf"].size) < 0.7,
                                      arrays["pt_ref_kf"], -1)
    return arrays


@pytest.mark.parametrize("window", [None, [3, 0, 7, -1, 12], [13, -1]])
def test_update_normals_and_depth(window):
    arrays = _posed_bench(2)
    jm, tm = jmap(arrays), entry.map_from_numpy(arrays, "cpu")
    jw = None if window is None else jnp.asarray(window, jnp.int32)
    tw = None if window is None else torch.tensor(window, dtype=torch.int32)
    j = jmaint.update_normals_and_depth(jm, kf_window=jw)
    got = tmaint.update_normals_and_depth(tm, kf_window=tw)
    b = entry.map_to_numpy(got)
    np.testing.assert_allclose(b["pt_normal"], np.asarray(j.pt_normal), atol=1e-5)
    for name in ("pt_max_dist", "pt_min_dist"):
        np.testing.assert_allclose(b[name], np.asarray(getattr(j, name)), rtol=1e-5, err_msg=name)
    changed = (b["pt_normal"] != arrays["pt_normal"]).any(1)
    assert changed.sum() > 20
    if window is None or len(window) > 2:  # reference keyframes in the window
        assert (b["pt_max_dist"] != arrays["pt_max_dist"]).sum() > 5
    for name in jms.MapState._fields:  # nothing else moves
        if name not in ("pt_normal", "pt_max_dist", "pt_min_dist"):
            np.testing.assert_array_equal(b[name], arrays[name], err_msg=name)


def test_update_normals_two_views():
    """tests/test_maintenance.py's case: two cameras looking at one point."""
    b = Both(tms.MapCapacity(max_keyframes=4, max_features=16, max_points=16))
    b.set_valid([0])
    b.j = b.j._replace(pt_xyz=b.j.pt_xyz.at[0].set(jnp.asarray([0.0, 0.0, 4.0])),
                       pt_ref_kf=b.j.pt_ref_kf.at[0].set(0))
    b.t = entry.map_from_numpy(b.j, "cpu")
    row = np.full(16, -1, np.int32)
    row[0] = 0
    T1 = np.eye(4, dtype=np.float32)
    T1[0, 3] = -1.0
    b.add_keyframe(*_frame_args(8, pt_idx=row, level=np.full(16, 2)))
    b.add_keyframe(*_frame_args(8, pt_idx=row, T=T1, ts=1.0, fid=1, seed=1))
    j = jmaint.update_normals_and_depth(b.j)
    got = tmaint.update_normals_and_depth(b.t)
    assert_maps_equal(j, got, float_atol=1e-6)
    np.testing.assert_allclose(float(got.pt_max_dist[0]), 4.0 * 1.2**2, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_update_distinctive_descriptors(seed):
    """Bench maps, duplicate links included (the selection is an integer
    scatter-min, exact whatever the order)."""
    arrays = _bench(seed)
    # clusters of near-identical descriptors, so the central member is
    # well defined for many points
    rng = np.random.default_rng(seed)
    pid = arrays["kf_pt_idx"]
    base = arrays["pt_desc"][np.clip(pid, 0, None)]
    noise = rng.integers(0, 2**32, base.shape, dtype=np.uint32) & rng.integers(
        0, 2**32, base.shape, dtype=np.uint32) & rng.integers(0, 2**32, base.shape, dtype=np.uint32)
    arrays["kf_desc"] = np.where((pid >= 0)[..., None], base ^ noise, arrays["kf_desc"])
    jm, tm = jmap(arrays), entry.map_from_numpy(arrays, "cpu")
    for window in ([0, 4, 9, 13], [2, -1, 5, -1, 11, 12]):
        j = jmaint.update_distinctive_descriptors(jm, jnp.asarray(window, jnp.int32), len(window))
        got = tmaint.update_distinctive_descriptors(tm, torch.tensor(window), len(window))
        assert_maps_equal(j, got)
        assert (got.pt_desc != tm.pt_desc).any(1).sum() > 10
    bits = tmaint._unpack_bits(t(arrays["pt_desc"][:5]))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jmaint._unpack_bits(jnp.asarray(arrays["pt_desc"][:5]))))


def test_distinctive_descriptor_cases():
    """tests/test_maintenance.py: the duplicated descriptor beats an
    outlier; a single observation leaves the descriptor alone."""
    b = Both(tms.MapCapacity(max_keyframes=4, max_features=16, max_points=16))
    b.set_valid([0, 1])
    row = np.full(16, -1, np.int32)
    row[0], row[1] = 0, 1
    for i, word in enumerate([0, 0xFFFFFFFF, 0]):
        args = list(_frame_args(16, pt_idx=row if i < 3 else None, ts=i, fid=i, seed=i))
        args[8] = np.zeros((16, 8), np.uint32)
        args[8][0] = word
        if i:
            args[10] = np.where(np.arange(16) == 0, 0, -1).astype(np.int32)
        b.add_keyframe(*args)
    window = [0, 1, 2, -1]
    j = jmaint.update_distinctive_descriptors(b.j, jnp.asarray(window, jnp.int32), 4)
    got = tmaint.update_distinctive_descriptors(b.t, torch.tensor(window), 4)
    assert_maps_equal(j, got)
    np.testing.assert_array_equal(got.pt_desc[0].numpy(), np.zeros(8))
