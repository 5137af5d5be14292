"""Motion-only bundle adjustment (pose optimization).

Port of orb_slam2_test_tpu/solvers/pose_opt.py (reference:
Optimizer::PoseOptimization): 4 rounds x 10 Gauss-Newton iterations
over one pose, Huber kernel (delta = sqrt(5.991) mono / sqrt(7.815)
stereo) in the first two rounds, chi2 reclassification between rounds
with outliers re-tested every round.

`pose_optimization` dispatches by device: CUDA tensors go to kernel 2
(solvers/pose_opt_cuda.py), CPU tensors to the plain version
`_pose_optimization_plain`, a port of `_pose_optimization_xla`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.geometry.robust import (
    CHI2_MONO,
    CHI2_STEREO,
    HUBER_MONO,
    HUBER_STEREO,
    huber_weight,
)
from orb_slam2_test_tpu_torch.geometry.se3 import se3_exp, se3_project
from orb_slam2_test_tpu_torch.solvers.pose_opt_cuda import pose_optimization_cuda
from orb_slam2_test_tpu_torch.solvers.reprojection import project_residual


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor  # [4, 4] optimized pose
    inliers: torch.Tensor  # [O] bool — final inlier classification
    n_inliers: torch.Tensor  # [] int32
    chi2: torch.Tensor  # [O] final per-observation chi2


def pose_optimization(
    cam: PinholeCamera,
    Tcw0: torch.Tensor,
    X: torch.Tensor,
    obs: torch.Tensor,
    inv_sigma2: torch.Tensor,
    valid: torch.Tensor,
    rounds: int = 4,
    iters_per_round: int = 10,
    damping: float = 1e-3,
) -> PoseOptResult:
    """Motion-only BA: kernel 2 for CUDA tensors, the plain version for
    CPU tensors; any other device raises."""
    if X.is_cuda:
        return PoseOptResult(*pose_optimization_cuda(
            cam, Tcw0, X, obs, inv_sigma2, valid,
            rounds=rounds, iters_per_round=iters_per_round, damping=damping,
        ))
    if X.device.type == "cpu":
        return _pose_optimization_plain(
            cam, Tcw0, X, obs, inv_sigma2, valid,
            rounds=rounds, iters_per_round=iters_per_round, damping=damping,
        )
    raise ValueError(f"pose_optimization: unsupported device {X.device}")


def _pose_optimization_plain(
    cam: PinholeCamera,
    Tcw0: torch.Tensor,  # [4, 4] initial pose
    X: torch.Tensor,  # [O, 3] world points
    obs: torch.Tensor,  # [O, 3] (u, v, u_r); u_r < 0 = mono
    inv_sigma2: torch.Tensor,  # [O]
    valid: torch.Tensor,  # [O] bool — observation exists
    rounds: int = 4,
    iters_per_round: int = 10,
    damping: float = 1e-3,
) -> PoseOptResult:
    """Batched motion-only BA in plain PyTorch, on any device. The 6x6
    solve is `torch.linalg.solve_ex`, which neither raises nor waits on
    the device; a non-finite step is zeroed as in the JAX package."""
    is_stereo = obs[..., 2] >= 0.0
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = torch.where(is_stereo, HUBER_STEREO, HUBER_MONO)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)

    def gn_iteration(Tcw, inlier_mask, robust):
        res = project_residual(cam, Tcw, X, obs, inv_sigma2)
        w_huber = huber_weight(res.chi2, delta) if robust else 1.0
        w = torch.where(
            inlier_mask & valid & res.depth_ok,
            w_huber * inv_sigma2,
            torch.zeros_like(inv_sigma2),
        )
        # H = sum w Jc^T Jc ; b = -sum w Jc^T r
        JTw = res.Jc.transpose(-1, -2) * w[:, None, None]  # [O, 6, 3]
        H = torch.einsum("oij,ojk->ik", JTw, res.Jc)
        b = -torch.einsum("oij,oj->i", JTw, res.r)
        H = H + damping * eye6 * (1.0 + torch.diagonal(H))
        dx = torch.linalg.solve_ex(H, b)[0]
        dx = torch.where(torch.isfinite(dx).all(), dx, torch.zeros_like(dx))
        return se3_exp(dx) @ Tcw

    inlier = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
    # keep the initial pose on the SE3 manifold
    Tcw = se3_project(Tcw0)
    for ridx in range(rounds):
        robust = ridx < 2  # the reference drops the Huber kernel after round 2
        for _ in range(iters_per_round):
            Tcw = gn_iteration(Tcw, inlier, robust)
        res = project_residual(cam, Tcw, X, obs, inv_sigma2)
        inlier = (res.chi2 <= chi2_th) & res.depth_ok
    Tcw = se3_project(Tcw)

    res = project_residual(cam, Tcw, X, obs, inv_sigma2)
    inliers = inlier & valid
    return PoseOptResult(
        Tcw=Tcw,
        inliers=inliers,
        n_inliers=inliers.sum(dtype=torch.int32),
        chi2=res.chi2,
    )
