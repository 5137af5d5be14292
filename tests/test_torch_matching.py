"""Parity of the PyTorch port's matching with the JAX package.

Hamming distances, best-two selection and conflict resolution are
integer computations (the bipolar product sums +-1 terms to at most
256, exact in float32 in any order), so every comparison here is
exact, ties included. `search_by_projection` gets the same frame arrays
on both sides and must produce the same assignments.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.engine import matchers as jm
from orb_slam2_test_tpu.engine.frame import FrameData as JFrame
from orb_slam2_test_tpu.engine.frame import build_frame_mono as jbuild
from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu.geometry.se3 import se3_exp
from orb_slam2_test_tpu.ops import matching as jmatch
from orb_slam2_test_tpu_torch.engine import matchers as tm
from orb_slam2_test_tpu_torch.engine.frame import FrameData as TFrame
from orb_slam2_test_tpu_torch.entry import consistent_scene, state_from_numpy
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera as TCam
from orb_slam2_test_tpu_torch.ops import matching as tmatch

torch.set_num_threads(2)

W, H = 320, 240
CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=W, height=H)


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def _t_desc(d):
    return torch.from_numpy(np.array(d, np.uint32).view(np.int32))


def test_hamming_matrix(rng):
    a, b = _desc(rng, 40), _desc(rng, 50)
    b[:5] = a[:5]  # zero distances
    b[5] = ~a[5]  # distance 256
    j = jmatch.hamming_matrix(jnp.asarray(a), jnp.asarray(b))
    t = tmatch.hamming_matrix(_t_desc(a), _t_desc(b))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    va = rng.random(40) > 0.2
    vb = rng.random(50) > 0.2
    j = jmatch.masked_hamming_matrix(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(va), jnp.asarray(vb))
    t = tmatch.masked_hamming_matrix(_t_desc(a), _t_desc(b),
                                     torch.from_numpy(va), torch.from_numpy(vb))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_best_two_with_ties(rng, dtype):
    d = rng.integers(0, 4, (64, 30)).astype(dtype)  # many tied minima
    d[0] = 7  # a row that is all one value
    j = jmatch.best_two(jnp.asarray(d))
    t = tmatch.best_two(torch.from_numpy(d))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_resolve_conflicts_with_ties(rng):
    P, N = 200, 40
    best_feat = rng.integers(-1, N, P).astype(np.int32)  # ~5 points per feature
    best_dist = rng.integers(0, 3, P).astype(np.int32)  # equal distances tie
    pt_ids = rng.permutation(10 * P)[:P].astype(np.int32)
    for ids in (None, pt_ids):
        j = jm._resolve_conflicts(
            jnp.asarray(best_feat), jnp.asarray(best_dist), N,
            None if ids is None else jnp.asarray(ids),
        )
        t = tm._resolve_conflicts(
            torch.from_numpy(best_feat), torch.from_numpy(best_dist), N,
            None if ids is None else torch.from_numpy(ids),
        )
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _synthetic_frame(rng, n=300, dup=False):
    """Frame arrays as numpy (JAX layouts): uniform keypoints and levels;
    with dup=True, pairs of nearby keypoints share a descriptor, so
    several points compete for one feature."""
    uv = np.stack([rng.uniform(20, W - 20, n), rng.uniform(20, H - 20, n)], 1)
    level = rng.integers(0, 8, n).astype(np.int32)
    desc = _desc(rng, n)
    if dup:
        uv[1::2] = uv[0::2] + rng.uniform(-2, 2, (n // 2, 2))
        level[1::2] = level[0::2]
        desc[1::2] = desc[0::2]
    valid = rng.random(n) > 0.1
    minus = -np.ones(n, np.float32)
    return JFrame(
        uv=uv.astype(np.float32), uv_raw=uv.astype(np.float32), level=level,
        angle=np.zeros(n, np.float32), desc=desc, valid=valid, ur=minus,
        depth=minus, timestamp=np.float32(0.0),
    )


@pytest.fixture(scope="module")
def real_frame():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (H, W)).astype(np.uint8)
    f = jbuild(jnp.asarray(img), 0.0, JCam(**CAM_KW), n_features=300)
    return JFrame(*[np.asarray(x) for x in f])


@pytest.mark.parametrize("kind", ["real", "synthetic", "synthetic_dup"])
def test_search_by_projection(rng, real_frame, kind):
    if kind == "real":
        frame = real_frame
    else:
        frame = _synthetic_frame(rng, dup=kind == "synthetic_dup")
    n_pts = 512
    T_true = np.asarray(se3_exp(jnp.asarray([0.05, -0.02, 0.1, 0.01, -0.02, 0.005])))
    scene = consistent_scene(rng, frame, TCam(**CAM_KW), n_pts, T_true)
    T_pred = np.asarray(
        se3_exp(jnp.asarray([0.02, 0.01, -0.02, 0.003, 0.002, -0.004]))
    ) @ T_true
    args = state_from_numpy(np.zeros((H, W), np.uint8), *scene, T_pred, device="cpu")

    j = jm.search_by_projection(
        JCam(**CAM_KW), jnp.asarray(T_pred, jnp.float32),
        *[jnp.asarray(a) for a in scene],
        jnp.arange(n_pts, dtype=jnp.int32),
        JFrame(*[jnp.asarray(x) for x in frame]),
        radius=15.0, check_view_cos=False,
    )
    tframe = TFrame(*[torch.from_numpy(np.array(x)) for x in frame])
    tframe = tframe._replace(desc=_t_desc(frame.desc))
    t = tm.search_by_projection(
        TCam(**CAM_KW), args[7], *args[1:7],
        torch.arange(n_pts, dtype=torch.int32), tframe, radius=15.0,
        check_view_cos=False,
    )
    np.testing.assert_array_equal(t.feat_pt.numpy(), np.asarray(j.feat_pt))
    np.testing.assert_array_equal(t.pt_feat.numpy(), np.asarray(j.pt_feat))
    assert int(t.n_matches) == int(j.n_matches)
    assert int(t.n_matches) > 0.5 * frame.valid.sum()


@pytest.mark.parametrize("kind", ["real", "synthetic_dup"])
@pytest.mark.parametrize("max_candidates", [None, 120])
def test_search_by_projection_local_map_settings(rng, real_frame, kind, max_candidates):
    """The local-map settings: view-angle gate, ratio 0.8 and the
    compaction of the usable points into max_candidates < P rows. A
    third of the normals face away (the view gate drops them), a tenth
    of the points are invalid, and duplicated descriptors make exact
    ties for the ratio test; the compaction keeps the first usable
    points in index order."""
    frame = real_frame if kind == "real" else _synthetic_frame(rng, dup=True)
    n_pts = 512
    T_true = np.asarray(se3_exp(jnp.asarray([0.05, -0.02, 0.1, 0.01, -0.02, 0.005])))
    scene = list(consistent_scene(rng, frame, TCam(**CAM_KW), n_pts, T_true))
    k = int(scene[2].sum())
    away = rng.random(n_pts) < 0.33
    scene[3] = np.where(away[:, None], -scene[3], scene[3]).astype(np.float32)
    scene[2] = scene[2] & (rng.random(n_pts) > 0.1)
    T_pred = np.asarray(
        se3_exp(jnp.asarray([0.02, 0.01, -0.02, 0.003, 0.002, -0.004]))
    ) @ T_true
    args = state_from_numpy(np.zeros((H, W), np.uint8), *scene, T_pred, device="cpu")
    pt_ids = rng.permutation(4 * n_pts)[:n_pts].astype(np.int32)
    kw = dict(radius=3.0, ratio=0.8, max_candidates=max_candidates)

    j = jm.search_by_projection(
        JCam(**CAM_KW), jnp.asarray(T_pred, jnp.float32),
        *[jnp.asarray(a) for a in scene], jnp.asarray(pt_ids),
        JFrame(*[jnp.asarray(x) for x in frame]), **kw,
    )
    tframe = TFrame(*[torch.from_numpy(np.array(x)) for x in frame])
    tframe = tframe._replace(desc=_t_desc(frame.desc))
    t = tm.search_by_projection(
        TCam(**CAM_KW), args[7], *args[1:7], torch.from_numpy(pt_ids), tframe, **kw,
    )
    np.testing.assert_array_equal(t.feat_pt.numpy(), np.asarray(j.feat_pt))
    np.testing.assert_array_equal(t.pt_feat.numpy(), np.asarray(j.pt_feat))
    assert int(t.n_matches) == int(j.n_matches)
    # the gates bite: fewer matches than usable points, and with the
    # compaction only points among the first usable ones match
    n = int(t.n_matches)
    assert 0 < n < 0.9 * k
    matched = np.flatnonzero(t.pt_feat.numpy() >= 0)
    assert not away[matched].any()
    if max_candidates is not None:
        assert (scene[2] & ~away).sum() > max_candidates  # the cut is real
        assert matched.max() < k and n <= max_candidates
