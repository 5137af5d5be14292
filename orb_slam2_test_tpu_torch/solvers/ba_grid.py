"""Local bundle adjustment on a dense [Q, C] observation grid.

Port of orb_slam2_test_tpu/solvers/ba_grid.py (reference:
Optimizer::LocalBundleAdjustment). Observations live on a dense grid of
Q points x C cameras:

    obs_uvr   [Q, C, 3]   (u, v, u_r), u_r < 0 for a monocular cell
    obs_isig2 [Q, C]
    obs_valid [Q, C]

so each LM iteration is a set of dense contractions and one [6C, 6C]
solve of the reduced camera system (Schur complement over the 3x3
point blocks). The schedule: `iters1` Huber-robust iterations, a chi2
gate (5.991 mono, 7.815 stereo), `iters2` iterations on the inliers.

Every accept/reject is a tensor select, so the solver never reads a
value back to the host; the products run in full float32 (TF32 off,
`utils.precision.f32_matmuls`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.geometry.linalg import inv3x3
from orb_slam2_test_tpu_torch.geometry.robust import (
    CHI2_MONO,
    CHI2_STEREO,
    HUBER_MONO,
    HUBER_STEREO,
    huber_loss,
    huber_weight,
)
from orb_slam2_test_tpu_torch.geometry.se3 import se3_exp, se3_project
from orb_slam2_test_tpu_torch.solvers.reprojection import project_residual


class GridBAProblem(NamedTuple):
    cam_Tcw: torch.Tensor  # [C, 4, 4]
    cam_fixed: torch.Tensor  # [C] bool
    pt_xyz: torch.Tensor  # [Q, 3]
    pt_valid: torch.Tensor  # [Q] bool
    obs_uvr: torch.Tensor  # [Q, C, 3]
    obs_isig2: torch.Tensor  # [Q, C]
    obs_valid: torch.Tensor  # [Q, C] bool


class GridBAResult(NamedTuple):
    cam_Tcw: torch.Tensor
    pt_xyz: torch.Tensor
    obs_inlier: torch.Tensor  # [Q, C] chi2 inlier with positive depth
    cost: torch.Tensor


def _grid_residual(prob: GridBAProblem, cam: PinholeCamera, cam_Tcw, pt_xyz):
    """Residuals and Jacobians over the whole grid."""
    Q, C = prob.obs_isig2.shape
    Tcw = cam_Tcw[None].expand(Q, C, 4, 4)
    X = pt_xyz[:, None, :].expand(Q, C, 3)
    return project_residual(cam, Tcw, X, prob.obs_uvr, prob.obs_isig2)


def _huber_delta(prob: GridBAProblem) -> torch.Tensor:
    return torch.where(prob.obs_uvr[..., 2] >= 0.0, HUBER_STEREO, HUBER_MONO)


def _grid_cost(prob: GridBAProblem, cam, cam_Tcw, pt_xyz, active) -> torch.Tensor:
    res = _grid_residual(prob, cam, cam_Tcw, pt_xyz)
    c = huber_loss(res.chi2, _huber_delta(prob))
    mask = prob.obs_valid & res.depth_ok & active
    return torch.where(mask, c, 0.0).sum()


def _grid_step(prob: GridBAProblem, cam: PinholeCamera, cam_Tcw, pt_xyz,
               lam, robust: bool, active):
    """One LM linearization and dense Schur solve: (dxc [C, 6], dxp [Q, 3])."""
    Q, C = prob.obs_isig2.shape
    dev = pt_xyz.device
    res = _grid_residual(prob, cam, cam_Tcw, pt_xyz)
    w_huber = huber_weight(res.chi2, _huber_delta(prob)) if robust else 1.0
    w = torch.where(
        active & prob.obs_valid & res.depth_ok, w_huber * prob.obs_isig2, 0.0
    )
    Jc = torch.where(prob.cam_fixed[None, :, None, None], 0.0, res.Jc)
    Jp = torch.where(prob.pt_valid[:, None, None, None], res.Jp, 0.0)
    wJc = Jc * w[..., None, None]
    wJp = Jp * w[..., None, None]
    wr = w[..., None] * res.r  # [Q, C, 3]

    # contractions over q, c and the residual row k are products; the
    # per-cell 3-wide ones are broadcast multiply-sums, as in the JAX
    # package
    Hcc = torch.einsum("qcki,qckj->cij", Jc, wJc)  # [C, 6, 6]
    Hpp = (Jp[..., :, None] * wJp[..., None, :]).sum((1, 2))  # [Q, 3, 3]
    bc = -torch.einsum("qcki,qck->ci", Jc, wr)  # [C, 6]
    bp = -(Jp * wr[..., None]).sum((1, 2))  # [Q, 3]
    Wqc = (Jc[..., :, :, None] * wJp[..., :, None, :]).sum(2)  # [Q, C, 6, 3]

    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)
    dHc = lam * torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1), min=1e-6)
    Hcc_d = Hcc + torch.diag_embed(dHc)
    dHp = lam * torch.clamp(torch.diagonal(Hpp, dim1=-2, dim2=-1), min=1e-6)
    Hpp_d = Hpp + torch.diag_embed(dHp)
    seen = w.sum(1) > 0.0  # [Q]
    Hpp_d = torch.where(seen[:, None, None], Hpp_d, eye3)
    Hpp_inv = inv3x3(Hpp_d)

    # Schur: S = Hcc_d - sum_q Wqc Hpp_inv Wqc^T
    Y = (Wqc[..., :, None] * Hpp_inv[:, None, None, :, :]).sum(-2)  # [Q, C, 6, 3]
    S_red = torch.einsum("qcik,qdjk->cdij", Y, Wqc)  # [C, C, 6, 6]
    rhs_red = torch.einsum("qcik,qk->ci", Y, bp)
    diag = torch.eye(C, dtype=torch.bool, device=dev)[:, :, None, None]
    S = torch.where(diag, -S_red + Hcc_d[:, None], -S_red)
    rhs = bc - rhs_red

    # a fixed camera's rows and columns become an identity block
    fix = prob.cam_fixed
    S = torch.where(fix[:, None, None, None] | fix[None, :, None, None], 0.0, S)
    S = S + torch.where(diag & fix[:, None, None, None], eye6, 0.0)
    rhs = torch.where(fix[:, None], 0.0, rhs)

    # solve_ex: a singular system gives non-finite values (as XLA's LU
    # does) instead of raising, and the select below zeroes them
    Sd = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
    dxc = torch.linalg.solve_ex(Sd, rhs.reshape(C * 6, 1)).result.reshape(C, 6)
    dxc = torch.where(torch.isfinite(dxc).all(), dxc, 0.0)

    wtd = torch.einsum("qcij,ci->qj", Wqc, dxc)
    dxp = (Hpp_inv * (bp - wtd)[:, None, :]).sum(-1)
    dxp = torch.where((seen & prob.pt_valid)[:, None], dxp, 0.0)
    dxp = torch.where(torch.isfinite(dxp).all(), dxp, 0.0)
    return dxc, dxp


def _apply(cam_Tcw, pt_xyz, cam_fixed, dxc, dxp):
    new_Tcw = se3_project(se3_exp(dxc) @ cam_Tcw)
    new_Tcw = torch.where(cam_fixed[:, None, None], cam_Tcw, new_Tcw)
    return new_Tcw, pt_xyz + dxp


def _lm_phase(prob, cam, carry, robust: bool, active, iters: int):
    """`iters` LM iterations; accept when the cost drops, with the
    damping halved on accept and quadrupled on reject."""
    cam_Tcw, pt_xyz, lam, cost = carry
    for _ in range(iters):
        dxc, dxp = _grid_step(prob, cam, cam_Tcw, pt_xyz, lam, robust, active)
        cand_Tcw, cand_xyz = _apply(cam_Tcw, pt_xyz, prob.cam_fixed, dxc, dxp)
        new_cost = _grid_cost(prob, cam, cand_Tcw, cand_xyz, active)
        accept = new_cost < cost
        cam_Tcw = torch.where(accept, cand_Tcw, cam_Tcw)
        pt_xyz = torch.where(accept, cand_xyz, pt_xyz)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        cost = torch.where(accept, new_cost, cost)
    return cam_Tcw, pt_xyz, lam, cost


def grid_bundle_adjust(
    prob: GridBAProblem,
    cam: PinholeCamera,
    iters1: int = 4,
    iters2: int = 6,
    lam0: float = 1e-4,
) -> GridBAResult:
    """`iters1` robust LM iterations, the chi2 outlier gate, then
    `iters2` iterations on the inliers."""
    active_all = torch.ones_like(prob.obs_valid)
    cam_Tcw, pt_xyz = prob.cam_Tcw, prob.pt_xyz
    cost0 = _grid_cost(prob, cam, cam_Tcw, pt_xyz, active_all)
    lam = torch.full((), lam0, device=pt_xyz.device)
    carry = _lm_phase(prob, cam, (cam_Tcw, pt_xyz, lam, cost0), True, active_all, iters1)
    cam_Tcw, pt_xyz, lam, _ = carry

    res = _grid_residual(prob, cam, cam_Tcw, pt_xyz)
    chi2_th = torch.where(prob.obs_uvr[..., 2] >= 0.0, CHI2_STEREO, CHI2_MONO)
    active = (res.chi2 <= chi2_th) & res.depth_ok

    cost = _grid_cost(prob, cam, cam_Tcw, pt_xyz, active)
    cam_Tcw, pt_xyz, _, cost = _lm_phase(
        prob, cam, (cam_Tcw, pt_xyz, lam, cost), False, active, iters2
    )
    res = _grid_residual(prob, cam, cam_Tcw, pt_xyz)
    inlier = (res.chi2 <= chi2_th) & res.depth_ok & prob.obs_valid
    return GridBAResult(cam_Tcw=cam_Tcw, pt_xyz=pt_xyz, obs_inlier=inlier, cost=cost)
