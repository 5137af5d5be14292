"""Parity of the port's monocular initialization, its matchers and
filters, and `grow_map` with the JAX package, on the CPU.

- `match_nn_ratio`, `mutual_filter`, `rotation_consistency` (tied bins
  included), `match_descriptors`, `search_for_initialization` and
  `match_by_descriptor_to_map`: exact (integer outputs; argmin/argmax
  take the first index on ties in both packages, and the histogram's
  tied bins are taken lowest first by a stable sort).
- `initialize_mono` on the two-view scenes of tests/test_initializer.py
  (general, planar, outliers, pure rotation) with the JAX package's own
  RANSAC samples fed in: success and used_homography equal, Tcw2 within
  atol 1e-4, the good mask equal on >= 99% of the entries. The DLT and
  8-point solves agree up to scale and sign (SVD sign conventions differ
  between LAPACK and XLA), within 1e-4 after normalization.
- `grow_map`: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_test_tpu.engine import matchers as jmatch
from orb_slam2_test_tpu.engine.frame import build_frame_mono as jbuild
from orb_slam2_test_tpu.ops import matching as jmatching
from orb_slam2_test_tpu.slam_map import mapstate as jms
from orb_slam2_test_tpu.solvers import initializer as jinit
from orb_slam2_test_tpu.utils.synthetic import default_camera, make_sequence
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.engine import matchers as tmatch
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera as TCam
from orb_slam2_test_tpu_torch.ops import matching as tmatching
from orb_slam2_test_tpu_torch.slam_map import mapstate as tms
from orb_slam2_test_tpu_torch.solvers import initializer as tinit

from test_initializer import _two_view

torch.set_num_threads(2)


def _t(a):
    """A JAX or numpy array as a CPU tensor (uint32 viewed as int32)."""
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _eq(t, j, msg=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=msg)


def _random_desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


@pytest.fixture(scope="module")
def frames():
    """Two frames of the quick end-to-end sequence (320x240, 400
    features), built by the JAX package, as (jax frames, port frames)."""
    cam = default_camera(320, 240)
    _, _, _, images = make_sequence(
        np.random.default_rng(0), 3, cam=cam, n_landmarks=160,
        step=np.array([0.12, 0.01, 0.0, 0.001, 0.003, 0.001]),
    )
    jf = [jbuild(jnp.asarray(im), float(i), cam, n_features=400)
          for i, im in enumerate(images[::2])]
    tf = [entry.frame_from_numpy(type(f)(*[np.asarray(x) for x in f]), "cpu") for f in jf]
    return jf, tf


def test_match_nn_ratio_and_mutual_filter():
    rng = np.random.default_rng(1)
    d = rng.integers(0, 90, (300, 250)).astype(np.int32)
    d[:, 7] = d[:, 3]  # tied minima
    for check in (True, False):
        ji, jd = jmatching.match_nn_ratio(jnp.asarray(d), 50, 0.9, check_ratio=check)
        ti, td = tmatching.match_nn_ratio(torch.from_numpy(d), 50, 0.9, check_ratio=check)
        _eq(ti, ji)
        _eq(td, jd)
    jab, _ = jmatching.match_nn_ratio(jnp.asarray(d), 60, 1.0, check_ratio=False)
    jba, _ = jmatching.match_nn_ratio(jnp.asarray(d.T), 60, 1.0, check_ratio=False)
    _eq(tmatching.mutual_filter(_t(jab), _t(jba)), jmatching.mutual_filter(jab, jba))


def test_rotation_consistency_with_tied_bins():
    rng = np.random.default_rng(2)
    n, m = 400, 300
    idx = np.where(rng.uniform(size=n) < 0.8, rng.integers(0, m, n), -1).astype(np.int32)
    a = rng.uniform(-np.pi, 3 * np.pi, n).astype(np.float32)
    b = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
    # five bins with the same count: the top three must be the lowest
    delta = (np.arange(5) * 6 + 0.5) * (2 * np.pi / 30)
    a[:100] = b[np.clip(idx[:100], 0, None)] + np.repeat(delta, 20).astype(np.float32)
    idx[:100] = np.abs(idx[:100])
    out_j = jmatching.rotation_consistency(jnp.asarray(idx), jnp.asarray(a), jnp.asarray(b))
    out_t = tmatching.rotation_consistency(torch.from_numpy(idx), torch.from_numpy(a),
                                           torch.from_numpy(b))
    _eq(out_t, out_j)
    assert (out_t >= 0).sum() > 0


def test_match_descriptors():
    rng = np.random.default_rng(3)
    da = _random_desc(rng, 300)
    db = da[rng.permutation(300)[:250]].copy()
    db[:, 0] ^= rng.integers(0, 2**20, 250, dtype=np.uint32)  # a few flipped bits
    va, vb = rng.uniform(size=300) < 0.9, rng.uniform(size=250) < 0.9
    for mutual in (True, False):
        ji, jd = jmatching.match_descriptors(*map(jnp.asarray, (da, db, va, vb)), mutual=mutual)
        ti, td = tmatching.match_descriptors(*map(_t, (da, db, va, vb)), mutual=mutual)
        _eq(ti, ji)
        _eq(td, jd)
        assert (ti >= 0).sum() > 100


def test_search_for_initialization(frames):
    jf, tf = frames
    jm, jn = jmatch.search_for_initialization(jf[0], jf[1])
    tm, tn = tmatch.search_for_initialization(tf[0], tf[1])
    _eq(tm, jm)
    assert int(tn) == int(jn) > 30


def test_match_by_descriptor_to_map(frames):
    jf, tf = frames
    rng = np.random.default_rng(4)
    desc = np.asarray(jf[1].desc)
    P = 600
    pts = np.concatenate([desc[rng.permutation(desc.shape[0])[:300]],
                          _random_desc(rng, P - 300)])
    pts[::3, 1] ^= np.uint32(1 << 5)
    valid = rng.uniform(size=P) < 0.95
    ids = rng.permutation(5000)[:P].astype(np.int32)
    jout = jmatch.match_by_descriptor_to_map(
        jf[0], jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(ids))
    tout = tmatch.match_by_descriptor_to_map(tf[0], _t(pts), _t(valid), _t(ids))
    for name in ("feat_pt", "pt_feat", "n_matches"):
        _eq(getattr(tout, name), getattr(jout, name), name)
    assert int(tout.n_matches) > 20


def _up_to_scale(a, b):
    """a and b normalized to unit norm with the sign of their largest
    entry's index in b."""
    a = a / np.linalg.norm(a, axis=(-2, -1), keepdims=True)
    b = b / np.linalg.norm(b, axis=(-2, -1), keepdims=True)
    flat = b.reshape(b.shape[0], -1)
    k = np.abs(flat).argmax(1)
    s = np.sign(a.reshape(a.shape[0], -1)[np.arange(len(k)), k] * flat[np.arange(len(k)), k])
    return a * s[:, None, None], b


def test_minimal_solves_up_to_scale_and_sign():
    rng = np.random.default_rng(5)
    x1 = rng.normal(0, 1, (200, 8, 2)).astype(np.float32)
    x2 = (x1 + rng.normal(0, 0.05, x1.shape)).astype(np.float32)
    for jf, tf in ((jinit._solve_h_dlt, tinit._solve_h_dlt),
                   (jinit._solve_f_8pt, tinit._solve_f_8pt)):
        a, b = _up_to_scale(tf(torch.from_numpy(x1), torch.from_numpy(x2)).numpy(),
                            np.asarray(jf(jnp.asarray(x1), jnp.asarray(x2))))
        np.testing.assert_allclose(a, b, atol=1e-4)


SCENES = {"general": {}, "planar": {"planar": True}, "outliers": {"outlier_frac": 0.25},
          "pure_rotation": {"baseline": 0.0}}


@pytest.mark.parametrize("seed,scene", enumerate(SCENES))
def test_initialize_mono_with_jax_samples(seed, scene):
    cam, X, T2, uv1, uv2, valid = _two_view(np.random.default_rng(0), **SCENES[scene])
    key = jax.random.PRNGKey(seed)
    jres = jinit.initialize_mono(cam, uv1, uv2, valid, key)
    kh, kf = jax.random.split(key)
    samples = tuple(_t(jinit._sample_indices(k, valid, jinit.RANSAC_ITERS, jinit.SAMPLE))
                    for k in (kh, kf))
    tres = tinit.initialize_mono(TCam(**cam._asdict()), _t(uv1), _t(uv2), _t(valid),
                                 samples=samples)
    assert bool(tres.success) == bool(jres.success)
    assert bool(tres.used_homography) == bool(jres.used_homography)
    if scene != "pure_rotation":
        assert bool(tres.success)
        np.testing.assert_allclose(tres.Tcw2.numpy(), np.asarray(jres.Tcw2), atol=1e-4)
        good_t, good_j = tres.good.numpy(), np.asarray(jres.good)
        assert (good_t == good_j).mean() >= 0.99, (good_t != good_j).sum()
        assert abs(int(tres.n_good) - int(jres.n_good)) <= 0.01 * int(jres.n_good)


def test_initialize_mono_own_samples():
    """The port's own generator draws only valid matches and succeeds on
    the general scene."""
    cam, X, T2, uv1, uv2, valid = _two_view(np.random.default_rng(0))
    v = _t(valid)
    v[::2] = False
    idx = tinit.sample_indices(v, 200, 8, torch.Generator().manual_seed(3))
    assert idx.shape == (200, 8) and bool(v[idx].all())
    res = tinit.initialize_mono(TCam(**cam._asdict()), _t(uv1), _t(uv2), v,
                                torch.Generator().manual_seed(3))
    assert bool(res.success) and not bool(res.used_homography)
    t_est, t_true = res.Tcw2[:3, 3].numpy(), np.asarray(T2[:3, 3])
    assert abs(t_est @ t_true) / np.linalg.norm(t_est) / np.linalg.norm(t_true) > 0.99


def test_grow_map_exact():
    cfg = dataclasses.replace(entry.KITTI_CFG, max_keyframes=8, max_points=512,
                              n_features=64)
    m = entry.bench_map(cfg, 5, 300, seed=1)
    old = cfg.map_capacity
    new = dataclasses.replace(old, max_keyframes=16, max_points=1024)
    jold = jms.MapCapacity(**dataclasses.asdict(old))
    jnew = jms.MapCapacity(**dataclasses.asdict(new))
    jm = jms.grow_map(jms.MapState(**{k: jnp.asarray(v) for k, v in m.items()}), jold, jnew)
    tm = tms.grow_map(entry.map_from_numpy(m, "cpu"), old, new)
    out = entry.map_to_numpy(tm)
    for name in tms.MapState._fields:
        np.testing.assert_array_equal(out[name], np.asarray(getattr(jm, name)), err_msg=name)
    with pytest.raises(ValueError):
        tms.grow_map(tm, new, old)
