"""The port's essential-graph optimizer against the JAX package's, on the
CPU, on both sides of the K = 512 switch.

- The per-edge Jacobian [E, 7, 14] (`tangent_jacobian`, a batched jvp)
  against `jax.vmap(jax.jacfwd)` on random edges: atol 1e-4, except
  near the series switch of sim3_exp at |sigma| = 1e-4 (there against
  the port in float64, 1e-4).
- Dense side: the 12-keyframe drifted chain with a loop edge of
  tests/test_loop_solvers.py (TestPoseGraph), free and fixed scale:
  Scw atol 1e-4; with a free scale every node within 0.01 of the
  truth, as the JAX test asks; a fixed node does not move.
- CG side: the 600-node noisy ring of tests/test_pose_graph_large.py
  (block-Jacobi PCG, 100 iterations per LM step): Scw atol 1e-3, the
  CG path's float32 sums in another order; the mean error drops below
  12% of the start, as the JAX test asks.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.geometry import sim3 as jsim3
from orb_slam2_test_tpu.geometry.se3 import se3_exp as jse3_exp
from orb_slam2_test_tpu.solvers.pose_graph import optimize_essential_graph as j_oeg
from orb_slam2_test_tpu_torch.geometry import sim3 as tsim3
from orb_slam2_test_tpu_torch.solvers import pose_graph as tpg

torch.set_num_threads(2)

POSE_ATOL = 1e-4
CG_ATOL = 1e-3


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def test_edge_jacobian_matches_jax():
    rng = np.random.default_rng(0)
    E = 32
    Siw = np.asarray(jsim3.sim3_exp(jnp.asarray(rng.normal(0, 0.5, (E, 7)), jnp.float32)))
    Sjw = np.asarray(jsim3.sim3_exp(jnp.asarray(rng.normal(0, 0.5, (E, 7)), jnp.float32)))
    noise = jsim3.sim3_exp(jnp.asarray(rng.normal(0, 0.05, (E, 7)), jnp.float32))
    Sji = np.asarray(noise @ jnp.asarray(Sjw) @ jsim3.sim3_inverse(jnp.asarray(Siw)))

    def jres(xi, a, b, m):
        return jsim3.sim3_log(m @ (jsim3.sim3_exp(xi[:7]) @ a)
                              @ jsim3.sim3_inverse(jsim3.sim3_exp(xi[7:]) @ b))

    Jj = np.asarray(jax.jit(jax.vmap(jax.jacfwd(jres)))(jnp.zeros((E, 14)), Siw, Sjw, Sji))
    a, b, m = _t(Siw), _t(Sjw), _t(Sji)
    Jt = tsim3.tangent_jacobian(lambda xi: tpg._edge_residual(xi, a, b, m), torch.zeros(E, 14))
    assert Jt.shape == Jj.shape == (E, 7, 14)
    # sim3_exp switches to its series at |sigma| = 1e-4, where the
    # float32 derivative of (e^sigma - 1) / sigma cancels badly in both
    # packages (jit and eager JAX differ by 2e-2 there): edges whose
    # residual log-scale lies near the switch are held to float64 only
    sigma = tpg._residuals(a, b, m)[:, 6].abs()
    far = ((sigma < 3e-5) | (sigma > 3e-4)).numpy()
    assert far.sum() >= E - 2
    np.testing.assert_allclose(Jt.numpy()[far], Jj[far], atol=POSE_ATOL)
    J64 = tsim3.tangent_jacobian(lambda xi: tpg._edge_residual(xi, a.double(), b.double(),
                                                               m.double()),
                                 torch.zeros(E, 14, dtype=torch.float64))
    np.testing.assert_allclose(Jt.numpy(), J64.numpy(), atol=1e-4)


@pytest.fixture(scope="module")
def drifted_chain():
    """TestPoseGraph.test_loop_correction_distributes_drift's graph."""
    rng = np.random.default_rng(0)
    K = 12
    true_T = jnp.stack([jse3_exp(jnp.asarray(np.array([0.3, 0.0, 0.0, 0.0, 0.08, 0.0]) * i,
                                             jnp.float32)) for i in range(K)])
    drift = np.zeros((K, 7), np.float32)
    for i in range(1, K):
        drift[i] = drift[i - 1] + rng.normal(0, 0.01, 7)
    S_est = jnp.stack([jsim3.sim3_exp(jnp.asarray(drift[i])) @ jsim3.sim3_from_se3(true_T[i])
                       for i in range(K)])
    ei = list(range(K - 1)) + [0]
    ej = list(range(1, K)) + [K - 1]
    S_true = jsim3.sim3_from_se3(true_T)
    meas = jnp.stack([S_true[j] @ jsim3.sim3_inverse(S_true[i]) for i, j in zip(ei, ej)])
    return dict(K=K, S_est=np.asarray(S_est), S_true=np.asarray(S_true),
                ei=np.asarray(ei, np.int32), ej=np.asarray(ej, np.int32), meas=np.asarray(meas))


@pytest.mark.parametrize("fix_scale", [False, True])
def test_dense_chain_matches_jax(drifted_chain, fix_scale):
    g = drifted_chain
    K, E = g["K"], len(g["ei"])
    fixed = np.arange(K) == 0
    # all edges valid, then one edge invalid (the edge masks), then a
    # dead node (the node masks)
    valid = np.ones(K, bool)
    ev = np.ones(E, bool)
    ev[3] = False
    args_j = (jnp.asarray(g["S_est"]), jnp.asarray(valid), jnp.asarray(fixed),
              jnp.asarray(g["ei"]), jnp.asarray(g["ej"]), jnp.asarray(g["meas"]))
    args_t = (_t(g["S_est"]), _t(valid, torch.bool), _t(fixed, torch.bool),
              _t(g["ei"], torch.int64), _t(g["ej"], torch.int64), _t(g["meas"]))
    dead = valid.copy()
    dead[7] = False
    for ev_case, nv in ((np.ones(E, bool), valid), (ev, valid), (np.ones(E, bool), dead)):
        j_out = np.asarray(j_oeg(args_j[0], jnp.asarray(nv), *args_j[2:], jnp.asarray(ev_case),
                                 jnp.ones(E), fix_scale=fix_scale))
        t_out = tpg.optimize_essential_graph(args_t[0], _t(nv, torch.bool), *args_t[2:],
                                             _t(ev_case, torch.bool), torch.ones(E),
                                             fix_scale=fix_scale).numpy()
        np.testing.assert_allclose(t_out, j_out, atol=POSE_ATOL)
    # all edges valid: the fixed node unmoved, and with a free scale
    # (the chain drifts in scale too) every node near the truth
    t_all = tpg.optimize_essential_graph(*args_t, torch.ones(E, dtype=torch.bool),
                                         torch.ones(E), fix_scale=fix_scale)
    np.testing.assert_array_equal(t_all[0].numpy(), g["S_est"][0])
    if not fix_scale:
        err = tsim3.sim3_log(tsim3.sim3_compose(t_all, tsim3.sim3_inverse(_t(g["S_true"]))))
        assert float(err.norm(dim=-1).max()) < 0.01


def test_cg_ring_matches_jax():
    """K = 600 > 512: the block-Jacobi PCG path."""
    rng = np.random.default_rng(0)
    K = 600
    th = np.linspace(0, 2 * np.pi, K, endpoint=False)
    Tgt = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    Tgt[:, 0, 3] = 10 * np.cos(th)
    Tgt[:, 2, 3] = 10 * np.sin(th)
    Tn = Tgt.copy()
    Tn[:, :3, 3] += rng.normal(0, 0.2, (K, 3)).astype(np.float32)
    Tn[0] = Tgt[0]
    S_gt = tsim3.sim3_from_se3(_t(Tgt))
    S0 = tsim3.sim3_from_se3(_t(Tn))
    ei = np.concatenate([np.arange(K - 1), [K - 1]]).astype(np.int32)
    ej = np.concatenate([np.arange(1, K), [0]]).astype(np.int32)
    meas = S_gt[ej] @ tsim3.sim3_inverse(S_gt[ei])
    fixed = np.arange(K) == 0
    E = len(ei)
    j_out = np.asarray(j_oeg(
        jnp.asarray(S0.numpy()), jnp.ones(K, bool), jnp.asarray(fixed), jnp.asarray(ei),
        jnp.asarray(ej), jnp.asarray(meas.numpy()), jnp.ones(E, bool), jnp.ones(E), iters=40))
    t_out = tpg.optimize_essential_graph(
        S0, torch.ones(K, dtype=torch.bool), _t(fixed, torch.bool), _t(ei, torch.int64),
        _t(ej, torch.int64), meas, torch.ones(E, dtype=torch.bool), torch.ones(E), iters=40)
    np.testing.assert_allclose(t_out.numpy(), j_out, atol=CG_ATOL)
    err0 = (S0[:, :3, 3] - S_gt[:, :3, 3]).norm(dim=1).mean()
    err1 = (t_out[:, :3, 3] - S_gt[:, :3, 3]).norm(dim=1).mean()
    assert float(err1) < 0.12 * float(err0)
