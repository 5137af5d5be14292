"""The loop correction's essential graph holds the loop open, in both
packages, on the CPU: the fault behind the 2,600-frame KITTI loop run's
ATE (examples/kitti_loop_run.py; PERF.md §5, ROADMAP queue 3).

`_correct_loop_device` (both packages) takes the full covisibility
matrix after SearchAndFuse, so the links the fuse makes between the
current keyframe's group and the loop side become strong covisibility
edges of the essential graph, and every covisibility edge is measured
from the poses before the correction. Those new edges say "keep the
revisit where it was before the loop", against the one loop edge
measured from the corrected poses. The reference
(Optimizer::OptimizeEssentialGraph) measures these loop connections
from the corrected poses and leaves them out of the covisibility edges.

On tests/test_torch_loop_closing.py's loop map (22 keyframes, the loop
at 21-1; its drift puts the keyframes 0.1339 m from the truth after a
rigid alignment) the correction leaves them 0.1300 m from it in both
packages. With the covisibility edges taken from the links before the
fuse (the loop connections left out) it leaves them 0.1033 m from it,
again in both. The test holds: the fuse makes new strong covisibility
pairs between the two sides in both packages; the shipped correction
removes at most a third of the error that the correction without those
edges removes, in both packages; and the port within POSE_ATOL of the
JAX package either way. The JAX package is the reference here, so the
port keeps its essential graph.
"""

import contextlib

import numpy as np
import jax
import pytest
import torch

import test_torch_loop_closing as small
from test_torch_loop_closing import POSE_ATOL, jcov, jlc, tcov, tlc
from test_torch_large_map import _correct_both, _s12

from orb_slam2_test_tpu_torch.utils.loop_probes import loop_connections_left_out

torch.set_num_threads(2)

LOOP = (small.N_KF - 1, 1)
# the shipped correction removes at most this share of the error that
# the correction without the loop connections removes (measured 0.13)
SHARE_OF_REFERENCE = 1 / 3


def _centre_error(Tcw: np.ndarray, T_true: np.ndarray) -> float:
    """RMS distance of the camera centres from the true ones after the
    best rigid alignment (the ATE of the keyframes, SE3)."""
    def centres(T):
        T = np.asarray(T, np.float64)
        return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])
    a, b = centres(Tcw), centres(T_true)
    A, B = a - a.mean(0), b - b.mean(0)
    U, _, Vt = np.linalg.svd(B.T @ A)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    return float(np.sqrt((np.linalg.norm(A @ (U @ D @ Vt).T - B, axis=1) ** 2).mean()))


@contextlib.contextmanager
def _loop_connections_left_out():
    """Both packages' `_correct_loop_device` with its full covisibility
    matrix taken from the map it was given (the links before the fuse),
    so the fuse's new links make no covisibility edge. The JAX program
    is traced again inside and after."""
    with loop_connections_left_out(jlc), loop_connections_left_out(tlc):
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()


@pytest.fixture(scope="module")
def corrections():
    m, _, T_true = small.make_loop_map()
    S12 = _s12(m, T_true, *LOOP)
    shipped = _correct_both(m, S12, LOOP)
    with _loop_connections_left_out():
        left_out = _correct_both(m, S12, LOOP)
    return m, np.stack(T_true), shipped, left_out


def test_fuse_makes_cross_loop_covisibility_edges(corrections):
    """The fuse links the revisit's group to the loop side's points, and
    those pairs reach the essential graph's covisibility threshold in
    both packages (the same pairs)."""
    m, _, (jm, tm), _ = corrections
    strong = tlc.COVIS_EDGE_MIN
    before = tcov.covisibility_weights(small._tmap(m)).numpy() >= strong
    new = {}
    for side, after in (("jax", np.asarray(jcov.covisibility_weights(small._jmap(jm)))),
                        ("port", tcov.covisibility_weights(small._tmap(tm)).numpy())):
        pairs = np.argwhere(np.triu((after >= strong) & ~before, 1))
        new[side] = {tuple(p) for p in pairs.tolist()}
    print(f"strong covisibility pairs the fuse adds: {sorted(new['port'])}")
    assert new["port"] == new["jax"] and new["port"]


def test_loop_connections_hold_the_loop_open_in_both_packages(corrections):
    """The keyframes' error from the truth (SE3-aligned centres) before
    the correction, after it as shipped and after it with the loop
    connections left out of the covisibility edges: the shipped
    correction removes at most SHARE_OF_REFERENCE of what the other
    removes, in both packages; the port within POSE_ATOL of the JAX
    package either way."""
    m, T_true, shipped, left_out = corrections
    live = m["kf_valid"]
    err0 = _centre_error(m["kf_Tcw"][live], T_true)
    errs = {}
    for name, (jm, tm) in (("shipped", shipped), ("left out", left_out)):
        small._assert_maps_close(tm, jm)
        errs[name] = {side: _centre_error(x["kf_Tcw"][live], T_true)
                      for side, x in (("jax", jm), ("port", tm))}
    print(f"keyframe centres from the truth: before {err0:.4f} m, shipped {errs['shipped']}, "
          f"loop connections left out {errs['left out']}")
    for side in ("jax", "port"):
        removed = err0 - errs["shipped"][side]
        reference = err0 - errs["left out"][side]
        assert reference > 0 and removed <= SHARE_OF_REFERENCE * reference, (side, errs)
    assert abs(errs["shipped"]["port"] - errs["shipped"]["jax"]) <= POSE_ATOL
