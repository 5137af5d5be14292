"""The map past 512 keyframes in the port against the JAX package, on the
CPU: the capacity growth from 512 to 1,024 keyframe slots, the loop
correction on the grown map (where the pose graph leaves its dense
[7K, 7K] solve for block-Jacobi CG, `solvers/pose_graph.DENSE_MAX_K`),
and the chunked global BA after it.

The map: `entry.synthetic_loop_map` with 362 keyframes one degree apart
on tests/test_torch_loop_closing.py's out-and-back ring (its lap of 360
keyframes drifts as its 20 do), 100 features each, the last two
revisiting the views of 0 and 1 with duplicate points; the loop at
keyframes 361-1. It is built at K = 512, P = 4,096 and grown to
K = 1,024, P = 8,192, so no global BA is pending across the growth (the JAX package raises on one; the port
pads it, tests/test_torch_loop_closing.py::test_gba_across_capacity_growth).

- `grow_map`, 512 -> 1,024: field by field equal to the JAX package's
  (a copy into an empty map; dtypes and shapes too).
- `_correct_loop_device` on the grown map, both packages on the CG
  branch: poses within CG_POSE_ATOL (1e-3, the CG bound of
  tests/test_torch_pose_graph.py), points within it on 99%, links on
  99%, loop edges equal (measured 4.4e-5, points 9.2e-5).
- The same correction on the map cut to K = 384 takes the dense branch
  in both packages (port vs JAX within POSE_ATOL, 1e-4; measured
  3.9e-5); the port's dense-to-CG gap must stay within GAP_FACTOR (2x)
  the JAX package's own (measured 1.153e-3 against 1.152e-3 on the
  poses: CG's 100 iterations a step stop short of the dense solve on
  this graph of 362 nodes).
- The global BA from the JAX closer's corrected map at K = 1,024, 3
  chunks, with a keyframe slot recycled and a keyframe created in a
  slot past 512 (its points past 4,096) after the first chunk: poses
  within GBA_ATOL (2e-3), points within it on 99% (measured 7.4e-5,
  all points, the largest 1.1e-4).

Serial time about 110 s on an 8-core CPU at 2 torch threads, most of it
the four corrections (the CG branch's 4,000 matvecs over ~6,000 edges).
`-m slow`: a map of 602 live keyframes at K = 1,024, the
correction and the global BA's first chunk at the same bounds.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.bow.vocabulary import build_vocabulary as jbuild_vocabulary
from orb_slam2_test_tpu.slam_map.mapstate import MapCapacity as JCap
from orb_slam2_test_tpu.slam_map.mapstate import grow_map as jgrow_map
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.slam_map.mapstate import MapCapacity, grow_map
from orb_slam2_test_tpu_torch.solvers import pose_graph as tpg
from orb_slam2_test_tpu_torch.utils.scatter import segment_sum, segments

from test_torch_loop_closing import (
    GBA_ATOL,
    _assert_maps_close,
    _cam,
    _closers,
    _jcam,
    _jmap,
    _np,
    _tmap,
    jlc,
    tlc,
)

torch.set_num_threads(2)

K_OLD, P_OLD = 512, 4096
K, P = 1024, 8192
K_DENSE = 384  # entry.KITTI_CFG's max_keyframes: the dense branch
N = 100
REVISIT = 360
N_KF = REVISIT + 2
LOOP = (N_KF - 1, 1)  # the revisit of view 1 closes on keyframe 1
CG_POSE_ATOL = 1e-3
GAP_FACTOR = 2.0
# after the first global BA chunk: keyframe 5's slot recycled, and a
# keyframe created in a slot past the old capacity with points past it
NEW_KF = 700
N_NEW_PTS = 30
VOC_KF = 22


def _cap(k: int, p: int, cls=MapCapacity):
    return cls(max_keyframes=k, max_features=N, max_points=p)


def _loop_map(n_kf: int, revisit: int, k: int, p: int):
    """entry.synthetic_loop_map with a vocabulary the JAX package built
    from its first keyframes' descriptors (the closers need one; no
    query runs on it here)."""
    m, T_true = entry.synthetic_loop_map(n_kf=n_kf, K=k, N=N, P=p, revisit=revisit)
    descs = m["kf_desc"][:VOC_KF][m["kf_kp_valid"][:VOC_KF]]
    return m, jbuild_vocabulary(descs, k=8, depth=2, seed=0), T_true


def _s12(m: dict, T_true, kf: int, cand: int) -> np.ndarray:
    """The loop's Sim3 (scale 1): the true relative pose of the two
    keyframes, carried onto the candidate's drifted estimate."""
    return (T_true[kf] @ np.linalg.inv(T_true[cand]) @ m["kf_Tcw"][cand]
            @ np.linalg.inv(m["kf_Tcw"][cand])).astype(np.float32)


def _correct_both(m: dict, S12: np.ndarray, loop=LOOP) -> tuple[dict, dict]:
    """_correct_loop_device in both packages from the same map and S12,
    with a fixed scale: (JAX's map, the port's map) as numpy. The JAX
    program runs while the port's does (JAX dispatches asynchronously)."""
    kf, cand = loop
    jm = jlc._correct_loop_device(_jcam(_cam()), _jmap(m), jnp.asarray(kf, jnp.int32),
                                  jnp.asarray(cand, jnp.int32), jnp.asarray(S12), True)
    tm = tlc._correct_loop_device(_cam(), _tmap(m), torch.tensor(kf), torch.tensor(cand),
                                  torch.from_numpy(S12), True)
    return _np(jm), _np(tm)


def _cut(m: dict, k: int) -> dict:
    """The map's first k keyframe slots (its live ones lie there)."""
    K0 = m["kf_valid"].shape[0]
    assert not m["kf_valid"][k:].any()
    return {f: v[:k] if v.ndim and v.shape[0] == K0 else v for f, v in m.items()}


def _pose_gap(a: dict, b: dict) -> float:
    live = a["kf_valid"]
    k = live.shape[0]
    return float(np.abs(a["kf_Tcw"][live] - b["kf_Tcw"][:k][live]).max())


@pytest.fixture(scope="module")
def grown():
    """The map at K 512 / P 4,096 grown to 1,024 / 8,192 by each package."""
    m, jvoc, T_true = _loop_map(N_KF, REVISIT, K_OLD, P_OLD)
    jg = _np(jgrow_map(_jmap(m), _cap(K_OLD, P_OLD, JCap), _cap(K, P, JCap)))
    tg = entry.map_to_numpy(grow_map(_tmap(m), _cap(K_OLD, P_OLD), _cap(K, P)))
    return m, jvoc, T_true, jg, tg


def test_grow_map_512_to_1024_matches_jax(grown):
    """Exact, field by field: a copy into an empty map of the new
    capacity, every slot where it was."""
    m, _, _, jg, tg = grown
    assert set(tg) == set(jg) == set(m)
    for f, j in jg.items():
        t = tg[f]
        assert t.dtype == j.dtype and t.shape == j.shape, (f, t.dtype, j.dtype, t.shape)
        np.testing.assert_array_equal(t, j, err_msg=f)
        if t.ndim:
            np.testing.assert_array_equal(t[:m[f].shape[0]], m[f], err_msg=f)
    assert tg["kf_Tcw"].shape[0] == K and tg["pt_xyz"].shape[0] == P
    assert int(tg["kf_valid"].sum()) == N_KF and not tg["kf_valid"][K_OLD:].any()


@pytest.fixture(scope="module")
def corrected(grown):
    """The correction in both packages on the grown map (CG) and on the
    map cut to K = 384 (dense)."""
    _, _, T_true, jg, _ = grown
    S12 = _s12(jg, T_true, *LOOP)
    return {"cg": _correct_both(jg, S12), "dense": _correct_both(_cut(jg, K_DENSE), S12)}


def test_correct_loop_device_cg_matches_jax(grown, corrected):
    """The CG branch in both packages at K = 1,024: poses within 1e-3,
    points within 1e-3 on 99%, links on 99%, loop edges equal."""
    # the JAX package's switch: `if K <= 512` (solvers/pose_graph.py:118)
    assert K_DENSE <= tpg.DENSE_MAX_K == 512 < K
    m = grown[3]
    jm, tm = corrected["cg"]
    _assert_maps_close(tm, jm, pose_atol=CG_POSE_ATOL, pt_atol=CG_POSE_ATOL)
    kf, cand = LOOP
    assert tm["kf_loop_edge"][kf] == cand and tm["kf_loop_edge"][cand] == kf
    # the revisit moved towards the keyframe it closes on
    before = np.linalg.norm(m["kf_Tcw"][kf][:3, 3] - m["kf_Tcw"][cand][:3, 3])
    after = np.linalg.norm(tm["kf_Tcw"][kf][:3, 3] - tm["kf_Tcw"][cand][:3, 3])
    assert after < before
    pv = jm["pt_valid"]
    print(f"_correct_loop_device at K = {K} ({N_KF} live keyframes, CG): port vs JAX poses "
          f"{_pose_gap(jm, tm):.3e}, points "
          f"{np.abs(tm['pt_xyz'][pv] - jm['pt_xyz'][pv]).max():.3e}")


def test_dense_to_cg_gap_within_jax(corrected):
    """Each package's CG result at K = 1,024 against its dense one at
    K = 384 on the same map: the port's gap within GAP_FACTOR x the JAX
    package's."""
    (jcg, tcg), (jd, td) = corrected["cg"], corrected["dense"]
    jgap, tgap = _pose_gap(jd, jcg), _pose_gap(td, tcg)
    pv = jd["pt_valid"]
    print(f"dense (K = {K_DENSE}) to CG (K = {K}): JAX {jgap:.3e}, port {tgap:.3e} (poses); "
          f"points JAX {np.abs(jcg['pt_xyz'][pv] - jd['pt_xyz'][pv]).max():.3e}, "
          f"port {np.abs(tcg['pt_xyz'][pv] - td['pt_xyz'][pv]).max():.3e}; dense "
          f"port vs JAX {_pose_gap(jd, td):.3e}")
    _assert_maps_close(td, jd)
    assert tgap <= GAP_FACTOR * jgap, (tgap, jgap)


def _edits_past_old_capacity(m: dict) -> dict:
    """Between two global BA chunks: keyframe 5's slot recycled by a new
    keyframe (a new frame id), and a keyframe created in slot NEW_KF,
    past the old capacity, with N_NEW_PTS points of its own in the first
    free slots past the old point capacity."""
    m = {k: np.array(v) for k, v in m.items()}
    kf = LOOP[0]
    m["kf_frame_id"][5] = 10_000
    m["kf_Tcw"][5][:3, 3] += np.float32(0.02)
    m["kf_valid"][NEW_KF] = True
    m["kf_frame_id"][NEW_KF] = 10_003
    m["kf_parent"][NEW_KF] = kf
    m["kf_Tcw"][NEW_KF] = m["kf_Tcw"][kf]
    free = np.nonzero(~m["pt_valid"][P_OLD:])[0][:N_NEW_PTS] + P_OLD
    m["pt_valid"][free] = True
    m["pt_ref_kf"][free] = NEW_KF
    m["pt_first_kf"][free] = 10_003
    m["pt_xyz"][free] = m["pt_xyz"][m["kf_pt_idx"][kf][:N_NEW_PTS]] + 0.01
    m["n_kf"] = np.int32(m["n_kf"] + 1)
    return m


def _gba_chunks(closer, m, to_map, n_chunks=None):
    """Advance a started global BA chunk by chunk (to its end, or
    n_chunks), editing the map after the first."""
    chunks, done = 0, False
    while not done and chunks != n_chunks:
        m, done = closer.advance_global_ba(m)
        chunks += 1
        if chunks == 1 and n_chunks is None:
            m = to_map(_edits_past_old_capacity(_np(m)))
    return m, chunks


def test_global_ba_past_512_matches_jax(grown, corrected):
    """Both packages' global BA from the JAX closer's corrected map at
    K = 1,024, edited after its first chunk: poses within GBA_ATOL,
    points within it on 99%; the new keyframe past the old capacity
    moves with its parent."""
    jm0 = corrected["cg"][0]
    jc, tc = _closers(grown[1])
    jc._start_global_ba(_jmap(jm0))
    tc._start_global_ba(_tmap(jm0))
    jm, jchunks = _gba_chunks(jc, _jmap(jm0), _jmap)
    tm, tchunks = _gba_chunks(tc, _tmap(jm0), _tmap)
    assert jchunks == tchunks == 3 and not tc.gba_running()
    jm, tm = _np(jm), _np(tm)
    _assert_maps_close(tm, jm, pose_atol=GBA_ATOL, pt_atol=GBA_ATOL)
    cb, ca = tc.last_gba_cost
    assert float(ca) < float(cb)
    edited = _edits_past_old_capacity(jm0)
    kf = LOOP[0]
    np.testing.assert_allclose(
        tm["kf_Tcw"][NEW_KF], edited["kf_Tcw"][NEW_KF] @ np.linalg.inv(edited["kf_Tcw"][kf])
        @ tm["kf_Tcw"][kf], atol=1e-4)
    pv = jm["pt_valid"]
    pts = np.abs(tm["pt_xyz"][pv] - jm["pt_xyz"][pv]).max(-1)
    print(f"global BA at K = {K}: poses within {_pose_gap(jm, tm):.3e} of the JAX package's, "
          f"points {(pts <= GBA_ATOL).mean():.4f} within {GBA_ATOL:g} (largest {pts.max():.3e})")


def test_sorted_segment_sum_matches_index_add():
    """`utils.scatter.segment_sum` through `segments`, the order the
    global BA's sums take on the card (ba_core._normal_blocks): within
    float32 rounding of index_add_ (rtol 1e-5, atol 1e-5), exactly zero
    where no live row lands, the rows that are not live (zeros) left
    out, and bit-equal from call to call. Shapes of the global BA's
    sums: [O, 6, 6], [O, 3] and [O] over 20,000 rows and 3,000 slots,
    two thirds of the rows not live and all of those at slot 0, as
    ba_core's clamped point index puts them."""
    g = torch.Generator().manual_seed(0)
    O, n = 20_000, 3_000
    live = torch.rand(O, generator=g) < 1 / 3
    idx = torch.where(live, torch.randint(0, n - 100, (O,), generator=g), 0)
    seg = segments(n, idx, live)
    assert int(seg.lengths[:n].sum()) == int(live.sum())
    for shape in ((6, 6), (3,), ()):
        v = torch.randn((O,) + shape, generator=g) * live.view((O,) + (1,) * len(shape))
        got = segment_sum(n, idx, v, seg)
        ref = segment_sum(n, idx, v)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, segment_sum(n, idx, v, seg))
        assert not got[n - 100:].any()


@pytest.mark.slow
def test_more_than_512_live_keyframes():
    """602 live keyframes at K = 1,024: the correction (CG) and the global
    BA's first chunk in both packages, at the bounds above."""
    n_kf = 602
    m, jvoc, T_true = _loop_map(n_kf, n_kf - 2, K, P)
    jm0, tm0 = _correct_both(m, _s12(m, T_true, n_kf - 1, 1), loop=(n_kf - 1, 1))
    _assert_maps_close(tm0, jm0, pose_atol=CG_POSE_ATOL, pt_atol=CG_POSE_ATOL)
    jc, tc = _closers(jvoc)
    jc._start_global_ba(_jmap(jm0))
    tc._start_global_ba(_tmap(jm0))
    jc.advance_global_ba(_jmap(jm0))
    tc.advance_global_ba(_tmap(jm0))
    jp, tp = jc._gba["prob"], tc._gba["prob"]
    cams = ~np.asarray(jp.cam_fixed)
    pv = np.asarray(jp.pt_valid)
    pose = np.abs(tp.cam_Tcw.numpy() - np.asarray(jp.cam_Tcw))[cams].max()
    pts = np.abs(tp.pt_xyz.numpy() - np.asarray(jp.pt_xyz))[pv].max(-1)
    print(f"{n_kf} live keyframes at K = {K}: correction poses {_pose_gap(jm0, tm0):.3e}; "
          f"the first global BA chunk poses {pose:.3e}, points within {GBA_ATOL:g} on "
          f"{(pts <= GBA_ATOL).mean():.4f}")
    assert pose <= GBA_ATOL
    assert (pts <= GBA_ATOL).mean() >= 0.99
