"""Loop correction and the chunked global BA in the port against the JAX
package at the card's capacities, on the CPU: tests/test_torch_loop_closing.py's
loop map (`make_loop_map`: 22 keyframes on the out-and-back ring, the
loop at keyframes 20-21) at K = 384 keyframes and P = 131,072 points,
`entry.KITTI_CFG`'s capacities, with that file's checks and tolerances.
This file holds the map, the JAX closer's correction and the shared
helpers, the correction from one S12 and the wide map (`-m slow`);
`_compute_and_correct` and the global BA are
tests/test_torch_full_capacity_closing.py, so that the Tier-1 command's
`--dist loadfile` spreads the two.

- `_correct_loop_device` from one S12 and `_compute_and_correct` with
  the JAX key chain's draws: POSE_ATOL (1e-4) on keyframe poses and on
  99% of the points, links on 99%, loop edges equal.
- The global BA (3 chunks, `_mid_ba_edits` after the first), both
  packages from the JAX closer's corrected map: poses within GBA_ATOL
  (2e-3), points on 99% (measured 1.12e-3 and 99.46%). The padded
  capacity alone moves neither package: each ends bit-equal to its run
  on the same content cut to K = 32, P = 4096.
- Its 12 LM steps from the JAX run's states, in both packages and in the
  port's code in float64: the same accept / reject decisions, and the
  port's float32 steps on average within STEP_FACTOR of the JAX
  package's distance from the float64 ones (measured: the port 1.3e-4 /
  1.6e-4, JAX 2.4e-4 / 3.2e-4, poses / points' 99th percentile).
  This found the fault the port repaired (solvers/ba_core.py): at small
  damping a point seen along nearly one ray has a 3x3 block of
  condition 1e7-1e8 whose float32 determinant, each product rounded on
  its own as eager ops round it, cancelled below inv3x3's 1e-12 floor,
  so the point stepped by 1e12 m and the step was rejected where the
  JAX package's (compiled, its error bounded) was accepted. Before the
  repair the port sat on 98.1% of the points within 2e-3 at K = 384.
- KITTI's width (`-m slow`, ~5 min): the same loop at N = 2000 features
  per keyframe (a wall of 16,000 points; 1,978-2,000 features in every
  keyframe): the correction at POSE_ATOL, the global BA's steps as
  above, and the whole global BA against the JAX package's own spread
  between two capacities (there GBA_ATOL holds for neither package
  against itself: `test_wide_loop_map_full_capacity`).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.solvers import ba_core as jba
from orb_slam2_test_tpu_torch.solvers import ba_core as tba

import test_torch_loop_closing as small
from test_torch_loop_closing import GBA_ATOL, _closers, _jmap, _mid_ba_edits, _np, _run_gba, _tmap

torch.set_num_threads(2)

K, P = 384, 131_072  # entry.KITTI_CFG's max_keyframes, max_points
K_CUT, P_CUT = 32, 4096  # tests/test_torch_loop_closing.py's
# the port's float32 steps' mean distance from the float64 ones against
# the JAX package's: measured 0.51-0.55 (poses, points' 99th percentile)
STEP_FACTOR = 2.0
# the global BA's schedule: bundle_adjust_partial's CG iterations, and the
# robust LM iterations before the chi2 gate (LoopCloser._start_global_ba)
CG_ITERS = 40
GBA_ROBUST = 4


def _cut(m: dict, k: int, p: int) -> dict:
    """The map's first k keyframe and p point slots (its live slots must
    lie there)."""
    K0, P0 = m["kf_valid"].shape[0], m["pt_valid"].shape[0]
    assert not m["kf_valid"][k:].any() and not m["pt_valid"][p:].any()
    assert m["kf_pt_idx"].max() < p
    return {f: (v[:k] if v.ndim and v.shape[0] == K0 else
                v[:p] if v.ndim and v.shape[0] == P0 else v) for f, v in m.items()}


def _gba(jvoc, m: dict) -> tuple[dict, dict]:
    """Both packages' global BA from map m, edited after the first chunk:
    (JAX's result, the port's)."""
    jc, tc = _closers(jvoc)
    jc._start_global_ba(_jmap(m))
    tc._start_global_ba(_tmap(m))
    jm, jchunks = _run_gba(jc, _jmap(m), _jmap, _mid_ba_edits)
    tm, tchunks = _run_gba(tc, _tmap(m), _tmap, _mid_ba_edits)
    assert jchunks == tchunks == 3
    cb, ca = tc.last_gba_cost
    assert float(ca) < float(cb)
    return _np(jm), _np(tm)


def _step_errors(jvoc, m: dict) -> dict:
    """The global BA's 12 LM steps (dxc, dxp) from the JAX run's states
    (problem, damping, cost, active set), each in both packages and in
    the port's code in float64: per iteration, the largest pose step gap
    and the points' 99th percentile, port vs JAX, JAX vs float64 and port
    vs float64; and each package's accept decisions."""
    jc, _ = _closers(jvoc)
    jcam, tcam = jc.cam, small._cam()
    step = jax.jit(jba._schur_step_cg, static_argnames=("cam", "robust", "cg_iters"))
    prob = jc._build_gba_prob(_jmap(m))
    active = jnp.ones_like(prob.obs_valid)
    lam, cost = jnp.float32(1e-4), small.jlc._gba_cost_device(prob, jcam)
    pv = np.asarray(prob.pt_valid)
    out = {"port vs jax": [], "jax vs f64": [], "port vs f64": [], "jax accepts": [],
           "port accepts": []}
    for it in range(jc.GBA_ITERS):
        robust = it < GBA_ROBUST
        if it == GBA_ROBUST:
            active, cost = jba.chi2_active_gate(prob, jcam)
        t32 = tba.BAProblem(*[torch.from_numpy(np.array(x)) for x in prob])
        t64 = tba.BAProblem(*[x.double() if x.is_floating_point() else x for x in t32])
        t_active = torch.from_numpy(np.array(active))
        steps = {"jax": [np.asarray(x, np.float64) for x in
                         step(prob, jcam, lam, robust, active, CG_ITERS)]}
        for name, tp in (("port", t32), ("f64", t64)):
            dxc, dxp = tba._schur_step_cg(tp, tcam, torch.tensor(float(lam), dtype=tp.pt_xyz.dtype),
                                          robust, t_active, CG_ITERS)
            steps[name] = [dxc.double().numpy(), dxp.double().numpy()]
            if name == "port":
                cand = tba._robust_cost(tba._apply_update(tp, dxc, dxp), tcam, t_active)
                out["port accepts"].append(bool(float(cand) < float(cost)))
        for key in ("port vs jax", "jax vs f64", "port vs f64"):
            a, b = (steps[k] for k in key.split(" vs "))
            out[key].append((float(np.abs(a[0] - b[0]).max()),
                             float(np.quantile(np.abs(a[1] - b[1])[pv].max(-1), 0.99))))
        new_prob, new_lam, new_cost = jba.bundle_adjust_partial(prob, jcam, lam, cost, active,
                                                                iters=1, robust=robust)
        out["jax accepts"].append(bool(float(new_lam) < float(lam)))
        prob, lam, cost = new_prob, new_lam, new_cost
    return out


def _assert_steps_match(jvoc, m: dict) -> str:
    """`_step_errors`: the same decisions, and the port's float32 steps
    on average over the iterations no farther from the float64 ones than
    STEP_FACTOR times the JAX package's (either package's step can be
    the worse one at a given iteration). Returns the figures as text."""
    e = _step_errors(jvoc, m)
    assert e["port accepts"] == e["jax accepts"], e
    mean = {k: np.mean(e[k], axis=0) for k in ("port vs jax", "jax vs f64", "port vs f64")}
    worst = {k: np.max(e[k], axis=0) for k in mean}
    assert (mean["port vs f64"] <= STEP_FACTOR * mean["jax vs f64"]).all(), e
    return "; ".join(f"{k} mean {a[0]:.2e} / {a[1]:.2e}, largest {b[0]:.2e} / {b[1]:.2e}"
                     for (k, a), b in zip(mean.items(), worst.values()))


# ---------------------------------------------------------------------------
# the loop map at K = 384, P = 131,072, N = 200
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loop_map():
    return small.make_loop_map(K=K, P=P)


@pytest.fixture(scope="module")
def jax_closed(loop_map):
    """The JAX closer's _compute_and_correct at full capacity."""
    m, jvoc, _ = loop_map
    jc, _ = _closers(jvoc)
    closed, jm = jc._compute_and_correct(_jmap(m), 21, 1)
    assert closed
    return closed, _np(jm), jc


def test_correct_loop_device_full_capacity(loop_map):
    small.test_correct_loop_device_matches_jax(loop_map, True)


# ---------------------------------------------------------------------------
# KITTI's width: N = 2000 features per keyframe
# ---------------------------------------------------------------------------

N_WIDE = 2000
N_WORLD_WIDE = 16_000
P_WIDE_CUT = 32_768  # holds the wide map's ~18,000 points
# the wide global BA run whole, port vs JAX, against the JAX package's own
# spread between its runs from its corrected maps at two capacities:
# measured ratios 0.46-0.67 (poses, points' 99th percentile)
SPREAD_FACTOR = 2.0


def _gaps(a: dict, b: dict) -> dict:
    """Over a's live slots: the largest pose entry gap, and the live
    points' largest coordinate gaps at the 99th percentile."""
    kv, pv = a["kf_valid"], a["pt_valid"]
    k, p = kv.shape[0], pv.shape[0]
    pts = np.abs(a["pt_xyz"][pv] - b["pt_xyz"][:p][pv]).max(-1)
    return {"pose": float(np.abs(a["kf_Tcw"][kv] - b["kf_Tcw"][:k][kv]).max()),
            "p99": float(np.quantile(pts, 0.99)), "within": float((pts <= GBA_ATOL).mean())}


@pytest.mark.slow
def test_wide_loop_map_full_capacity():
    """At N = 2000 the global BA is chaotic in float32 in both packages: a
    2.9e-6 change of the corrected map (the JAX package's at K = 32 and
    at K = 384) moves the JAX package's result by 4.0e-3 (poses) and
    8.5e-3 (points' 99th percentile; 26% of them within GBA_ATOL), the
    port's by 1.5e-2 and 2.5e-2. So the whole run is held to the JAX
    package's spread (port vs JAX measured 2.7e-3 and 3.9e-3), and its
    steps from the JAX run's states as at N = 200."""
    loop_map = small.make_loop_map(K=K, P=P, N=N_WIDE, n_world=N_WORLD_WIDE)
    m, jvoc, _ = loop_map
    feats = m["kf_kp_valid"][:small.N_KF].sum(1)
    assert feats.min() > 1000, feats
    small.test_correct_loop_device_matches_jax(loop_map, True)
    jc, _ = _closers(jvoc)
    closed, jm = jc._compute_and_correct(_jmap(m), 21, 1)
    small.test_compute_and_correct_matches_jax(loop_map, (closed, _np(jm), jc), True)
    jm = _np(jm)
    steps = _assert_steps_match(jvoc, jm)
    m_cut, jvoc_cut, _ = small.make_loop_map(K=K_CUT, P=P_WIDE_CUT, N=N_WIDE,
                                             n_world=N_WORLD_WIDE)
    jc_cut, _ = _closers(jvoc_cut)
    closed, jm_cut = jc_cut._compute_and_correct(_jmap(m_cut), 21, 1)
    assert closed
    full, cut = _gba(jvoc, jm), _gba(jvoc_cut, _np(jm_cut))
    gap, jax_spread, port_spread = (_gaps(full[0], full[1]), _gaps(cut[0], full[0]),
                                    _gaps(cut[1], full[1]))
    print(f"N = {N_WIDE}: {feats.min()}-{feats.max()} features per keyframe; global BA steps "
          f"from the JAX states: {steps}; the whole global BA, port vs JAX {gap}; the JAX "
          f"package's spread between its corrected maps at K = {K_CUT} and {K} {jax_spread}, "
          f"the port's over the same two {port_spread}")
    assert gap["pose"] <= SPREAD_FACTOR * jax_spread["pose"], (gap, jax_spread)
    assert gap["p99"] <= SPREAD_FACTOR * jax_spread["p99"], (gap, jax_spread)
