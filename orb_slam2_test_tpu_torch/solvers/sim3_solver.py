"""Sim(3) RANSAC between two keyframes' matched map points, and its
Gauss-Newton refinement.

Port of orb_slam2_test_tpu/solvers/sim3_solver.py (reference:
src/Sim3Solver.cc, Optimizer::OptimizeSim3): Horn's closed-form
absolute orientation on 3-point samples, every hypothesis solved as one
batched SVD and checked by reprojection in both images as one [S, M]
pass; fixed scale 1 for stereo and RGB-D (bFixScale).

The JAX package draws the samples with `jax.random.choice` inside the
jitted solver; here the caller passes them in (`idx`), so a test can
feed the JAX draws and the loop closer draws from its own generator.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.geometry.robust import huber_weight
from orb_slam2_test_tpu_torch.geometry.sim3 import (
    sim3_exp,
    sim3_inverse,
    sim3_make,
    tangent_jacobian,
)


class Sim3Result(NamedTuple):
    success: torch.Tensor
    S12: torch.Tensor  # [4, 4] maps camera-2 points into the camera-1 frame
    inliers: torch.Tensor  # [M]
    n_inliers: torch.Tensor


def sample_probabilities(valid: torch.Tensor) -> torch.Tensor:
    """The sampling weights of `jax.random.choice(..., p=p)` in the JAX
    solver: uniform over the valid pairs."""
    p = valid.to(torch.float32)
    return p / torch.clamp(p.sum(), min=1.0)


def _horn_batch(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool):
    """Batched Horn absolute orientation: p1, p2 [S, k, 3] -> (s [S],
    R [S, 3, 3], t [S, 3]) with p1 ~ s R p2 + t.

    The reflection fix multiplies the last singular pair by
    sign(det U det Vt), which does not depend on the signs the SVD
    backend gives its vectors; a 3-point sample has a rank <= 2 H, so
    its third singular pair is arbitrary on every backend."""
    c1 = p1.mean(1, keepdim=True)
    c2 = p2.mean(1, keepdim=True)
    q1 = p1 - c1
    q2 = p2 - c2
    H = (q1[..., :, None] * q2[..., None, :]).sum(1)  # [S, 3, 3]
    U, _, Vt = torch.linalg.svd(H)
    detUV = torch.linalg.det(U) * torch.linalg.det(Vt)
    d = torch.ones(U.shape[:-1], dtype=U.dtype, device=U.device)
    d = torch.cat([d[..., :2], torch.sign(detUV)[..., None]], dim=-1)
    R = (U * d[..., None, :]) @ Vt
    if fix_scale:
        s = torch.ones(p1.shape[0], dtype=p1.dtype, device=p1.device)
    else:
        Rq2 = (R[:, None] @ q2[..., None])[..., 0]
        num = (q1 * Rq2).sum((1, 2))
        den = torch.clamp((q2 * q2).sum((1, 2)), min=1e-12)
        s = num / den
    t = c1[:, 0, :] - s[:, None] * (R @ c2[:, 0, :, None])[..., 0]
    return s, R, t


def _proj(cam: PinholeCamera, p3: torch.Tensor) -> torch.Tensor:
    z = torch.where(p3[..., 2].abs() > 1e-6, p3[..., 2], 1e-6)
    return torch.stack([cam.fx * p3[..., 0] / z + cam.cx,
                        cam.fy * p3[..., 1] / z + cam.cy], dim=-1)


def sim3_ransac(
    cam: PinholeCamera,
    pc1: torch.Tensor,  # [M, 3] matched points in the camera-1 frame
    pc2: torch.Tensor,  # [M, 3] the same points in the camera-2 frame
    valid: torch.Tensor,  # [M]
    idx: torch.Tensor,  # [n_iters, 3] sampled pair indices
    fix_scale: bool = False,
    min_inliers: int = 20,
    chi2_1: float = 9.210,
    chi2_2: float = 9.210,
) -> Sim3Result:
    """Sim3Solver::iterate: one Horn hypothesis per row of idx, inliers
    by reprojection both ways; the hypothesis with the most inliers
    wins (the first on ties, as jnp.argmax). Returns S12 with pc1 ~
    s12 R12 pc2 + t12."""
    idx = idx.to(torch.int64)
    s, R, t = _horn_batch(pc1[idx], pc2[idx], fix_scale)

    uv1_obs = _proj(cam, pc1)
    uv2_obs = _proj(cam, pc2)
    p2in1 = s[:, None, None] * (pc2 @ R.transpose(1, 2)) + t[:, None, :]
    inv_s = 1.0 / torch.clamp(s, min=1e-12)
    p1in2 = inv_s[:, None, None] * ((pc1[None] - t[:, None, :]) @ R)
    e1 = ((_proj(cam, p2in1) - uv1_obs[None]) ** 2).sum(-1)
    e2 = ((_proj(cam, p1in2) - uv2_obs[None]) ** 2).sum(-1)
    inl = (e1 < chi2_1) & (e2 < chi2_2) & valid[None, :]
    scores = inl.sum(-1, dtype=torch.int32)
    best = torch.argmax(scores).reshape(1)
    n = scores.index_select(0, best)[0]
    return Sim3Result(
        success=n >= min_inliers,
        S12=sim3_make(s.index_select(0, best), R.index_select(0, best),
                      t.index_select(0, best))[0],
        inliers=inl.index_select(0, best)[0],
        n_inliers=n,
    )


def sim3_residuals(cam: PinholeCamera, xi, S, pc1, pc2, uv1_obs, uv2_obs) -> torch.Tensor:
    """[..., 2M, 2] reprojection residuals of exp(xi) S both ways, xi
    [..., 7]: camera-2 points into image 1, camera-1 points into image 2."""
    Sc = sim3_exp(xi) @ S
    p2in1 = pc2 @ Sc[..., :3, :3].transpose(-1, -2) + Sc[..., None, :3, 3]
    Sinv = sim3_inverse(Sc)
    p1in2 = pc1 @ Sinv[..., :3, :3].transpose(-1, -2) + Sinv[..., None, :3, 3]
    return torch.cat([_proj(cam, p2in1) - uv1_obs, _proj(cam, p1in2) - uv2_obs], -2)


def optimize_sim3(
    cam: PinholeCamera,
    S12: torch.Tensor,  # [4, 4] initial Sim3
    pc1: torch.Tensor,  # [M, 3]
    pc2: torch.Tensor,
    valid: torch.Tensor,
    iters: int = 10,
    fix_scale: bool = False,
    chi2_th: float = 9.210,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gauss-Newton refinement of the relative Sim3 on reprojection
    residuals both ways, Huber-weighted with delta = sqrt(chi2_th)
    (Optimizer::OptimizeSim3). The Jacobian is forward-mode autodiff
    (`tangent_jacobian`), as the JAX package's `jax.jacfwd`; the
    iterations are a fixed-length loop of selects, no host read.
    Returns (S12 refined, inliers [M], n_inliers)."""
    M = pc1.shape[0]
    uv1_obs = _proj(cam, pc1)
    uv2_obs = _proj(cam, pc2)

    def residuals(xi, S):
        return sim3_residuals(cam, xi, S, pc1, pc2, uv1_obs, uv2_obs)

    w_valid = torch.cat([valid, valid]).to(torch.float32)
    xi0 = torch.zeros(7, dtype=S12.dtype, device=S12.device)
    eye7 = torch.eye(7, dtype=S12.dtype, device=S12.device)
    # 1e12 on sigma freezes the scale (a select: no element written
    # from the host)
    freeze = torch.diag_embed(torch.where(
        torch.arange(7, device=eye7.device) == 6, 1e12 if fix_scale else 0.0, 0.0)).to(eye7.dtype)
    S = S12
    for _ in range(iters):
        J = tangent_jacobian(lambda xi: residuals(xi, S), xi0)  # [2M, 2, 7]
        r = residuals(xi0, S)
        chi2 = (r * r).sum(-1)
        w = w_valid * huber_weight(chi2, chi2_th ** 0.5)
        Jw = J * w[:, None, None]
        H = torch.einsum("mki,mkj->ij", Jw, J) + freeze + 1e-6 * eye7
        b = -torch.einsum("mki,mk->i", Jw, r)
        dx = torch.linalg.solve_ex(H, b[:, None]).result[:, 0]
        dx = torch.where(torch.isfinite(dx).all(), dx, 0.0)
        S = sim3_exp(dx) @ S
    r = residuals(xi0, S)
    chi2 = (r * r).sum(-1)
    inl = (chi2[:M] < chi2_th) & (chi2[M:] < chi2_th) & valid
    return S, inl, inl.sum(dtype=torch.int32)
