"""Reprojection residuals + analytic Jacobians for SE3 edges.

Port of orb_slam2_test_tpu/solvers/reprojection.py (reference: g2o's
EdgeSE3ProjectXYZ / EdgeStereoSE3ProjectXYZ). The pose update is left
multiplicative, T <- exp(xi) T with xi = (upsilon, omega); the residual
is r = observation - projection; observations are (u, v, u_r) with
u_r < 0 marking a monocular edge.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.geometry.se3 import se3_apply


class Residuals(NamedTuple):
    r: torch.Tensor  # [..., 3] residual (third component 0 for mono)
    chi2: torch.Tensor  # [...] weighted squared error r^T Omega r
    Jc: torch.Tensor  # [..., 3, 6] d r / d camera-update xi
    Jp: torch.Tensor  # [..., 3, 3] d r / d point position (world)
    depth_ok: torch.Tensor  # [...] positive-depth mask


def project_residual(
    cam: PinholeCamera,
    Tcw: torch.Tensor,  # [..., 4, 4]
    X: torch.Tensor,  # [..., 3] world points
    obs: torch.Tensor,  # [..., 3] (u, v, u_r); u_r < 0 => monocular
    inv_sigma2: torch.Tensor,  # [...] information scale
) -> Residuals:
    """Residual + Jacobians for one (pose, point, observation) triple."""
    pc = se3_apply(Tcw, X)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_safe = torch.where(z.abs() > 1e-6, z, 1e-6)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z

    is_stereo = obs[..., 2] >= 0.0
    zero = torch.zeros_like(x)
    r = torch.stack(
        [obs[..., 0] - u, obs[..., 1] - v,
         torch.where(is_stereo, obs[..., 2] - ur, zero)],
        dim=-1,
    )

    # d(proj)/d(pc): rows for u, v, ur
    du = torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], dim=-1)
    dv = torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1)
    dur = du + torch.stack([zero, zero, cam.bf * inv_z2], dim=-1)
    dur = torch.where(is_stereo[..., None], dur, torch.zeros_like(dur))
    dproj = torch.stack([du, dv, dur], dim=-2)  # [..., 3, 3]

    # d(pc)/d(xi) for the left update exp(xi) T: [I | -[pc]_x]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    px = torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )
    dpc_dxi = torch.cat([eye, -px], dim=-1)  # [..., 3, 6]

    # r = obs - proj => J = -dproj @ (...), as broadcast multiply-sums
    # like the JAX package (exact float32, no small batched matmuls)
    Jc = -(dproj[..., :, :, None] * dpc_dxi[..., None, :, :]).sum(-2)
    R = Tcw[..., :3, :3]
    Jp = -(dproj[..., :, :, None] * R[..., None, :, :]).sum(-2)

    chi2 = (r * r).sum(-1) * inv_sigma2
    return Residuals(r=r, chi2=chi2, Jc=Jc, Jp=Jp, depth_ok=z > 0.0)
