"""Bundle adjustment over flat observation arrays: Levenberg-Marquardt
with a Schur complement, dense or by preconditioned CG.

Port of orb_slam2_test_tpu/solvers/ba_core.py (reference: g2o's
BlockSolver_6_3 with OptimizationAlgorithmLevenberg, Optimizer.cc
BundleAdjustment). The problem is a set of cameras and points and one
row per observation:

    cam_Tcw   [C, 4, 4]   poses (some flagged fixed)
    pt_xyz    [Q, 3]      points
    obs_cam   [O] int     camera index per observation
    obs_pt    [O] int     point index per observation
    obs_uvr   [O, 3]      (u, v, u_r), u_r < 0 for monocular
    obs_isig2 [O]         1 / sigma^2
    obs_valid [O] bool

One LM iteration gathers and linearizes every observation, reduces the
3x3 point blocks, the 6x6 camera blocks and the gradients by index
adds, eliminates the points (Schur) and solves the reduced camera
system: dense [6C, 6C] by LU (`_schur_step`), or by block-Jacobi CG
with an implicit Schur matvec that never forms the camera-point blocks
(`_schur_step_cg`, the global BA). The loop closer's global BA runs it
in resumable chunks (`bundle_adjust_partial`). Every accept is a
select; no value is read back to the host.
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
from orb_slam2_test_tpu_torch.utils.scatter import segment_sum


class BAProblem(NamedTuple):
    cam_Tcw: torch.Tensor  # [C, 4, 4]
    cam_fixed: torch.Tensor  # [C] bool
    pt_xyz: torch.Tensor  # [Q, 3]
    pt_valid: torch.Tensor  # [Q] bool
    obs_cam: torch.Tensor  # [O] int
    obs_pt: torch.Tensor  # [O] int
    obs_uvr: torch.Tensor  # [O, 3]
    obs_isig2: torch.Tensor  # [O]
    obs_valid: torch.Tensor  # [O] bool


class BAResult(NamedTuple):
    cam_Tcw: torch.Tensor
    pt_xyz: torch.Tensor
    obs_chi2: torch.Tensor  # final per-observation chi2
    obs_inlier: torch.Tensor  # chi2 <= threshold and positive depth
    cost: torch.Tensor  # final robust cost


def _residual(prob: BAProblem, cam: PinholeCamera):
    return project_residual(cam, prob.cam_Tcw[prob.obs_cam.long()],
                            prob.pt_xyz[prob.obs_pt.long()], prob.obs_uvr, prob.obs_isig2)


def _huber_delta(prob: BAProblem) -> torch.Tensor:
    return torch.where(prob.obs_uvr[..., 2] >= 0.0, HUBER_STEREO, HUBER_MONO)


def _chi2_threshold(prob: BAProblem) -> torch.Tensor:
    return torch.where(prob.obs_uvr[..., 2] >= 0.0, CHI2_STEREO, CHI2_MONO)


def _blocks(prob: BAProblem, cam: PinholeCamera, robust: bool, active: torch.Tensor):
    """Linearize every observation: (residuals, Jc, Jp, weight)."""
    res = _residual(prob, cam)
    w_huber = huber_weight(res.chi2, _huber_delta(prob)) if robust else 1.0
    w = torch.where(active & prob.obs_valid & res.depth_ok, w_huber * prob.obs_isig2, 0.0)
    Jc = torch.where(prob.cam_fixed[prob.obs_cam.long(), None, None], 0.0, res.Jc)
    Jp = torch.where(prob.pt_valid[prob.obs_pt.long(), None, None], res.Jp, 0.0)
    return res, Jc, Jp, w


def _robust_cost(prob: BAProblem, cam: PinholeCamera,
                 active: torch.Tensor | None = None) -> torch.Tensor:
    """The robust objective over the active observations (it must be the
    set being optimized, or LM rejects steps that improve it)."""
    res = _residual(prob, cam)
    cost = huber_loss(res.chi2, _huber_delta(prob))
    mask = prob.obs_valid & res.depth_ok
    if active is not None:
        mask = mask & active
    return torch.where(mask, cost, 0.0).sum()


def _normal_blocks(prob, cam, lam, robust, active):
    """The block reductions both solvers share: (Hcc_d, Hpp_inv, bc, bp,
    Wcp [O, 6, 3], seen [Q])."""
    C = prob.cam_Tcw.shape[0]
    Q = prob.pt_xyz.shape[0]
    oc, op = prob.obs_cam.long(), prob.obs_pt.long()
    res, Jc, Jp, w = _blocks(prob, cam, robust, active)
    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]
    wr = w[:, None] * res.r
    Hcc = segment_sum(C, oc, torch.einsum("oki,okj->oij", Jc, wJc))
    Hpp = segment_sum(Q, op, torch.einsum("oki,okj->oij", Jp, wJp))
    bc = segment_sum(C, oc, -torch.einsum("oki,ok->oi", Jc, wr))
    bp = segment_sum(Q, op, -torch.einsum("oki,ok->oi", Jp, wr))
    Wcp = torch.einsum("oki,okj->oij", Jc, wJp)  # [O, 6, 3]

    # LM damping, multiplicative on the diagonal (g2o's Levenberg)
    dHc = lam * torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1), min=1e-6)
    Hcc_d = Hcc + torch.diag_embed(dHc)
    dHp = lam * torch.clamp(torch.diagonal(Hpp, dim1=-2, dim2=-1), min=1e-6)
    Hpp_d = Hpp + torch.diag_embed(dHp)
    # unobserved points get identity blocks (their dxp stays 0: bp = 0)
    seen = segment_sum(Q, op, w) > 0.0
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    Hpp_d = torch.where(seen[:, None, None], Hpp_d, eye3)
    return Hcc_d, inv3x3(Hpp_d), bc, bp, Wcp, seen


def _back_substitute(prob, Hpp_inv, bp, u, seen):
    """dxp = Hpp^-1 (bp - W^T dxc), zero for unseen or invalid points."""
    dxp = torch.einsum("qij,qj->qi", Hpp_inv, bp - u)
    dxp = torch.where((seen & prob.pt_valid)[:, None], dxp, 0.0)
    return torch.where(torch.isfinite(dxp).all(), dxp, 0.0)


def _schur_step(prob: BAProblem, cam: PinholeCamera, lam, robust: bool,
                active: torch.Tensor):
    """One LM linearization and a dense Schur solve: (dxc [C, 6], dxp [Q, 3])."""
    C = prob.cam_Tcw.shape[0]
    Q = prob.pt_xyz.shape[0]
    oc, op = prob.obs_cam.long(), prob.obs_pt.long()
    Hcc_d, Hpp_inv, bc, bp, Wcp, seen = _normal_blocks(prob, cam, lam, robust, active)
    Wqc = segment_sum(Q * C, op * C + oc, Wcp).view(Q, C, 6, 3)

    # S = Hcc_d - sum_q Wqc Hpp^-1 Wqc^T, rhs = bc - Wqc Hpp^-1 bp
    Y = torch.einsum("qcij,qjk->qcik", Wqc, Hpp_inv)
    S = -torch.einsum("qcik,qdjk->cdij", Y, Wqc)
    rhs = bc - torch.einsum("qcik,qk->ci", Y, bp)
    diag = torch.eye(C, dtype=torch.bool, device=S.device)[:, :, None, None]
    S = torch.where(diag, S + Hcc_d[:, None], S)

    # a fixed camera's rows and columns become an identity block
    fix = prob.cam_fixed
    eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
    S = torch.where(fix[:, None, None, None] | fix[None, :, None, None], 0.0, S)
    S = S + torch.where(diag & fix[:, None, None, None], eye6, 0.0)
    rhs = torch.where(fix[:, None], 0.0, rhs)

    Sd = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
    dxc = torch.linalg.solve_ex(Sd, rhs.reshape(C * 6, 1)).result.reshape(C, 6)
    dxc = torch.where(torch.isfinite(dxc).all(), dxc, 0.0)
    wtd = torch.einsum("qcij,ci->qj", Wqc, dxc)
    return dxc, _back_substitute(prob, Hpp_inv, bp, wtd, seen)


def _schur_step_cg(prob: BAProblem, cam: PinholeCamera, lam, robust: bool,
                   active: torch.Tensor, cg_iters: int = 30):
    """One LM linearization with the reduced camera system solved by
    block-Jacobi preconditioned CG over an implicit Schur matvec, S v =
    Hcc v - W Hpp^-1 W^T v through per-observation index adds: memory
    O(observations), the global BA's path."""
    C = prob.cam_Tcw.shape[0]
    Q = prob.pt_xyz.shape[0]
    oc, op = prob.obs_cam.long(), prob.obs_pt.long()
    Hcc_d, Hpp_inv, bc, bp, Wcp, seen = _normal_blocks(prob, cam, lam, robust, active)
    fix = prob.cam_fixed
    eye6 = torch.eye(6, dtype=Hcc_d.dtype, device=Hcc_d.device)

    def schur_matvec(v):  # v [C, 6]
        v = torch.where(fix[:, None], 0.0, v)
        hv = torch.einsum("cij,cj->ci", Hcc_d, v)
        u = segment_sum(Q, op, torch.einsum("oji,oj->oi", Wcp, v[oc]))
        y = torch.einsum("qij,qj->qi", Hpp_inv, u)
        wv = segment_sum(C, oc, torch.einsum("oij,oj->oi", Wcp, y[op]))
        return torch.where(fix[:, None], v, hv - wv)

    yb = torch.einsum("qij,qj->qi", Hpp_inv, bp)
    rhs = bc - segment_sum(C, oc, torch.einsum("oij,oj->oi", Wcp, yb[op]))
    rhs = torch.where(fix[:, None], 0.0, rhs)

    Minv = torch.linalg.inv_ex(Hcc_d + 1e-6 * eye6).inverse
    Minv = torch.where(fix[:, None, None], eye6, Minv)

    def precond(r):
        return torch.einsum("cij,cj->ci", Minv, r)

    x = torch.zeros_like(rhs)
    r = rhs - schur_matvec(x)
    z = precond(r)
    p = z
    rz = (r * z).sum()
    for _ in range(cg_iters):
        Ap = schur_matvec(p)
        denom = (p * Ap).sum()
        alpha = rz / torch.where(denom.abs() > 1e-20, denom, 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = (r * z).sum()
        beta = rz_new / torch.where(rz.abs() > 1e-20, rz, 1e-20)
        p = z + beta * p
        rz = rz_new
    dxc = torch.where(torch.isfinite(x).all(), x, 0.0)
    dxc = torch.where(fix[:, None], 0.0, dxc)
    u = segment_sum(Q, op, torch.einsum("oji,oj->oi", Wcp, dxc[oc]))
    return dxc, _back_substitute(prob, Hpp_inv, bp, u, seen)


def _apply_update(prob: BAProblem, dxc, dxp) -> BAProblem:
    # re-projected onto SE3: float32 scale and skew creep in R would be
    # amplified by later transpose-inverses
    new_Tcw = se3_project(se3_exp(dxc) @ prob.cam_Tcw)
    new_Tcw = torch.where(prob.cam_fixed[:, None, None], prob.cam_Tcw, new_Tcw)
    return prob._replace(cam_Tcw=new_Tcw, pt_xyz=prob.pt_xyz + dxp)


def _lm_iter(prob, cam, lam, cost, robust, active, solver, cg_iters):
    """One accept/reject LM iteration: the damping halves on accept and
    quadruples on reject."""
    if solver == "cg":
        dxc, dxp = _schur_step_cg(prob, cam, lam, robust, active, cg_iters)
    else:
        dxc, dxp = _schur_step(prob, cam, lam, robust, active)
    cand = _apply_update(prob, dxc, dxp)
    new_cost = _robust_cost(cand, cam, active)
    accept = new_cost < cost
    prob = BAProblem(*[torch.where(accept, a, b) if a is not b else a
                       for a, b in zip(cand, prob)])
    lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
    return prob, lam, torch.where(accept, new_cost, cost)


def bundle_adjust_partial(
    prob: BAProblem,
    cam: PinholeCamera,
    lam: torch.Tensor,
    cost: torch.Tensor,
    active: torch.Tensor,
    iters: int = 4,
    robust: bool = True,
    solver: str = "cg",
    cg_iters: int = 40,
) -> tuple[BAProblem, torch.Tensor, torch.Tensor]:
    """`iters` LM iterations from a carried (lam, cost): `bundle_adjust`
    cut into resumable chunks. The loop closer's global BA runs one
    chunk per backend flush, and a new loop closure drops the chunks
    left (reference RunGlobalBundleAdjustment in a detached thread,
    stopped by mbStopGBA). Returns (prob, lam, cost)."""
    for _ in range(iters):
        prob, lam, cost = _lm_iter(prob, cam, lam, cost, robust, active, solver, cg_iters)
    return prob, lam, cost


def chi2_active_gate(prob: BAProblem, cam: PinholeCamera):
    """The outlier gate between the robust and the inlier phases
    (chi2 5.991 mono / 7.815 stereo): (active mask, cost over it)."""
    res = _residual(prob, cam)
    active = (res.chi2 <= _chi2_threshold(prob)) & res.depth_ok
    return active, _robust_cost(prob, cam, active)


def bundle_adjust(
    prob: BAProblem,
    cam: PinholeCamera,
    iters1: int = 5,
    iters2: int = 10,
    lam0: float = 1e-4,
    solver: str = "dense",
    cg_iters: int = 30,
) -> BAResult:
    """The LM schedule of Optimizer::LocalBundleAdjustment: `iters1`
    robust iterations, the chi2 gate, `iters2` iterations on the
    inliers."""
    active_all = torch.ones_like(prob.obs_valid)
    cost = _robust_cost(prob, cam, active_all)
    lam = torch.full((), lam0, dtype=prob.pt_xyz.dtype, device=prob.pt_xyz.device)
    for _ in range(iters1):
        prob, lam, cost = _lm_iter(prob, cam, lam, cost, True, active_all, solver, cg_iters)
    active, cost = chi2_active_gate(prob, cam)
    for _ in range(iters2):
        prob, lam, cost = _lm_iter(prob, cam, lam, cost, False, active, solver, cg_iters)
    res = _residual(prob, cam)
    inlier = (res.chi2 <= _chi2_threshold(prob)) & res.depth_ok & prob.obs_valid
    return BAResult(cam_Tcw=prob.cam_Tcw, pt_xyz=prob.pt_xyz, obs_chi2=res.chi2,
                    obs_inlier=inlier, cost=cost)
