"""`_compute_and_correct` and the chunked global BA in the port against
the JAX package at the card's capacities (K = 384, P = 131,072), on the
CPU, from tests/test_torch_full_capacity_loop.py's loop map (that file
describes the checks and holds the helpers):

- both closers with the JAX key chain's draws, with
  tests/test_torch_loop_closing.py's checks (POSE_ATOL on keyframe
  poses and on 99% of the points, links on 99%, loop edges equal);
- the global BA from the JAX closer's corrected map, 3 chunks with
  `_mid_ba_edits` after the first: poses within GBA_ATOL (2e-3), points
  on 99%; each package's run bit-equal to its run cut to K = 32,
  P = 4096; and its 12 LM steps from the JAX run's states against a
  float64 solve.

Apart from that file so that the Tier-1 command's `--dist loadfile` runs
the two on two workers; the tests here share the JAX closer's run.
"""

import numpy as np
import pytest
import torch

import test_torch_loop_closing as small
from test_torch_full_capacity_loop import (  # noqa: F401 (fixtures)
    K,
    K_CUT,
    P,
    P_CUT,
    _assert_steps_match,
    _cut,
    _gba,
    jax_closed,
    loop_map,
)
from test_torch_loop_closing import GBA_ATOL

torch.set_num_threads(2)


def test_compute_and_correct_full_capacity(loop_map, jax_closed):  # noqa: F811
    small.test_compute_and_correct_matches_jax(loop_map, jax_closed, True)


@pytest.fixture(scope="module")
def gba_runs(loop_map, jax_closed):  # noqa: F811
    """The global BA in both packages from the JAX package's corrected
    map, at K = 384 and cut to K = 32, P = 4096."""
    jvoc, jm = loop_map[1], jax_closed[1]
    return {"full": _gba(jvoc, jm), "cut": _gba(jvoc, _cut(jm, K_CUT, P_CUT))}


def test_global_ba_full_capacity_matches_jax(gba_runs):
    jm, tm = gba_runs["full"]
    small._assert_maps_close(tm, jm, pose_atol=GBA_ATOL, pt_atol=GBA_ATOL)
    pv = jm["pt_valid"]
    pts = np.abs(tm["pt_xyz"][pv] - jm["pt_xyz"][pv]).max(-1)
    print(f"global BA at K = {K}, P = {P}: poses within "
          f"{np.abs(tm['kf_Tcw'] - jm['kf_Tcw'])[jm['kf_valid']].max():.3e} of the JAX "
          f"package's, points {(pts <= GBA_ATOL).mean():.4f} within {GBA_ATOL:g} (largest "
          f"{pts.max():.3e})")


def test_global_ba_capacity_alone_moves_nothing(gba_runs):
    """Each package's global BA at K = 384 equals, bit for bit, its run
    on the same live content at K = 32, P = 4096: the padded slots enter
    no sum that changes a live result."""
    for side, name in enumerate(("jax", "port")):
        full, cut = gba_runs["full"][side], gba_runs["cut"][side]
        for f in ("kf_Tcw", "pt_xyz", "kf_pt_idx", "pt_valid", "kf_valid"):
            np.testing.assert_array_equal(cut[f], full[f][:cut[f].shape[0]], err_msg=(name, f))
        assert not full["kf_valid"][K_CUT:].any() and not full["pt_valid"][P_CUT:].any()


def test_global_ba_steps_match_jax(loop_map, jax_closed):  # noqa: F811
    e = _assert_steps_match(loop_map[1], jax_closed[1])
    print(f"global BA steps from the JAX states (poses / points' p99): {e}")


