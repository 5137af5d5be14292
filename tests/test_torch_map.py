"""Parity of the port's map state, observer bitmap and local keyframe /
point set with the JAX package.

Everything here is integer or copied data, so every comparison is
exact, with one exception the JAX package leaves open: when a keyframe
links two of its features to one point, two writes hit one bitmap cell
and which level wins is unspecified in XLA (and in torch). Every
consumer reads only `bitmap > 0`, so incidence is held exactly and the
stored level exactly at the cells written once.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import bench
from orb_slam2_test_tpu.engine import tracking as jtracking
from orb_slam2_test_tpu.slam_map import covisibility as jcov
from orb_slam2_test_tpu.slam_map import mapstate as jms
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.engine import tracking as ttracking
from orb_slam2_test_tpu_torch.slam_map import covisibility as tcov
from orb_slam2_test_tpu_torch.slam_map import mapstate as tms

torch.set_num_threads(2)

SMALL_CFG = dict(n_features=64, max_keyframes=16, max_points=512)


def _numpy(name, x):
    """A port tensor as numpy in the JAX package's layout."""
    x = x.numpy()
    return x.view(np.uint32) if name.endswith("_desc") else x


def _jax_map(arrays) -> jms.MapState:
    return jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def test_tracker_config_is_a_copy():
    jf = {f.name: f.default for f in dataclasses.fields(jtracking.TrackerConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ttracking.TrackerConfig)}
    assert tf == jf
    cfg = ttracking.TrackerConfig(**SMALL_CFG)
    jcfg = jtracking.TrackerConfig(**SMALL_CFG)
    assert dataclasses.asdict(cfg.map_capacity) == dataclasses.asdict(jcfg.map_capacity)
    np.testing.assert_array_equal(cfg.map_capacity.level_scales,
                                  jcfg.map_capacity.level_scales)
    np.testing.assert_array_equal(cfg.map_capacity.level_sigma2,
                                  jcfg.map_capacity.level_sigma2)
    assert cfg.map_capacity.level_sigma2.dtype == np.float32


def test_kitti_configuration_is_the_bench_one():
    assert tuple(entry.KITTI_CAM) == tuple(bench.KITTI_CAM)
    assert dataclasses.asdict(entry.KITTI_CFG) == dataclasses.asdict(bench.KITTI_CFG)
    assert entry.KITTI_CAM.baseline == bench.KITTI_CAM.baseline


def test_make_empty_map():
    cap = tms.MapCapacity(max_keyframes=4, max_features=8, max_points=16)
    j = jms.make_empty_map(jms.MapCapacity(**dataclasses.asdict(cap)))
    t = tms.make_empty_map(cap)
    assert t._fields == j._fields
    for name, a, b in zip(j._fields, j, t):
        b = _numpy(name, b)
        assert b.shape == a.shape and b.dtype == a.dtype, name
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)


@pytest.mark.parametrize("n_kf, n_pt, seed", [(12, 300, 0), (16, 512, 5)])
def test_bench_map_equals_bench(n_kf, n_pt, seed):
    j = bench._bench_map(jtracking.TrackerConfig(**SMALL_CFG), n_kf, n_pt, seed)
    t = entry.bench_map(ttracking.TrackerConfig(**SMALL_CFG), n_kf, n_pt, seed)
    assert list(t) == list(j._fields)
    for name in j._fields:
        a, b = np.asarray(getattr(j, name)), t[name]
        assert b.dtype == a.dtype and b.shape == a.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_map_from_numpy_round_trip():
    m = entry.bench_map(ttracking.TrackerConfig(**SMALL_CFG), 10, 200, 1)
    t = entry.map_from_numpy(m, "cpu")
    assert t.kf_desc.dtype == torch.int32 and t.pt_valid.dtype == torch.bool
    for name, b in zip(t._fields, t):
        np.testing.assert_array_equal(_numpy(name, b), m[name], err_msg=name)
    # a JAX MapState (a NamedTuple) is taken as well
    t2 = entry.map_from_numpy(_jax_map(m), "cpu")
    for a, b in zip(t, t2):
        assert torch.equal(a, b)


def test_build_observer_bitmap():
    m = entry.bench_map(ttracking.TrackerConfig(**SMALL_CFG), 12, 300, 2)
    # some keyframe rows link two features to one point: duplicate writes
    K, N = m["kf_pt_idx"].shape
    dup = sum(
        np.bincount(row[row >= 0]).max(initial=0) > 1
        for row in m["kf_pt_idx"][: int(m["n_kf"])]
    )
    assert dup > 0
    j = np.asarray(jcov.build_observer_bitmap(_jax_map(m)))
    t = tcov.build_observer_bitmap(entry.map_from_numpy(m, "cpu")).numpy()
    assert t.dtype == np.uint8 and t.shape == j.shape == (m["pt_valid"].size, K)
    np.testing.assert_array_equal(t > 0, j > 0)
    # cells written once hold the level + 1 exactly
    linked = (m["kf_pt_idx"] >= 0) & m["kf_kp_valid"] & m["kf_valid"][:, None]
    kk, nn = np.nonzero(linked)
    writes = np.zeros(j.shape, int)
    np.add.at(writes, (m["kf_pt_idx"][kk, nn], kk), 1)
    once = writes == 1
    np.testing.assert_array_equal(t[once], j[once])
    assert (writes > 1).any() and once.sum() > 100


def _local_map_case():
    """The map of tests/test_local_map_set.py: KF0 sees points 0..19,
    KF1 16 of them plus 30..33, KF2 5 of them plus 40..43; the frame
    matched points 0..3."""
    cap = jms.MapCapacity(max_keyframes=8, max_features=32, max_points=64)
    N = cap.max_features
    m = jms.make_empty_map(cap)
    for i, pts in enumerate([
        list(range(20)),
        list(range(4, 20)) + [30, 31, 32, 33],
        list(range(15, 20)) + [40, 41, 42, 43],
    ]):
        pt_idx = np.full((N,), -1, np.int32)
        pt_idx[: len(pts)] = pts
        m, _ = jms.add_keyframe(
            m, jnp.eye(4), float(i), i, jnp.zeros((N, 2)), jnp.zeros((N,), jnp.int32),
            jnp.zeros((N,)), jnp.full((N,), -1.0), jnp.full((N,), -1.0),
            jnp.zeros((N, 8), jnp.uint32), jnp.asarray(np.arange(N) < len(pts)),
            jnp.asarray(pt_idx),
        )
    live = list(range(20)) + [30, 31, 32, 33, 40, 41, 42, 43]
    m = m._replace(pt_valid=m.pt_valid.at[jnp.asarray(live)].set(True))
    cur = np.full((N,), -1, np.int32)
    cur[:4] = np.arange(4)
    return m, cur, 4, 4


def _bench_case(seed):
    """A bench map with many tied votes: the frame links 60 random live
    points, so most keyframes get 0-3 votes."""
    rng = np.random.default_rng(seed)
    cfg = ttracking.TrackerConfig(**SMALL_CFG)
    arrays = entry.bench_map(cfg, 14, 400, seed)
    cur = np.full((cfg.n_features,), -1, np.int32)
    cur[rng.choice(cfg.n_features, 60, replace=False)] = rng.integers(0, 400, 60)
    return _jax_map(arrays), cur, 6, 5


@pytest.mark.parametrize("case", ["test_local_map_set", "bench_ties", "bench_ties_2"])
def test_local_keyframe_point_set(case):
    if case == "test_local_map_set":
        jm, cur, k1, k2 = _local_map_case()
    else:
        jm, cur, k1, k2 = _bench_case(3 if case == "bench_ties" else 4)
    jbm = jcov.build_observer_bitmap(jm)
    jw, jk, jp = jtracking._local_keyframe_point_set(jm, jbm, jnp.asarray(cur), k1, k2)
    tm = entry.map_from_numpy(jm, "cpu")
    tw, tk, tp = ttracking._local_keyframe_point_set(
        tm, tcov.build_observer_bitmap(tm), torch.from_numpy(cur), k1, k2
    )
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert tk.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    if case == "test_local_map_set":
        # the expectations of tests/test_local_map_set.py
        assert tk[0] == 0 and tw[0] == 4 and (tw[1:] == 0).all()
        assert tp[30:34].all() and not tp[40] and tp[:20].all()
    else:
        w = tw.numpy()
        assert (w[:-1] >= w[1:]).all() and len(set(w[w > 0])) < (w > 0).sum()
