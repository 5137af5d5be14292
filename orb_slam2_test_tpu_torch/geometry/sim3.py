"""Sim(3) similarity transforms, batched over leading dimensions.

Port of orb_slam2_test_tpu/geometry/sim3.py (reference: g2o::Sim3 in
Thirdparty/g2o/g2o/types/sim3.h), used by loop closing: the Sim3
solver, its refinement and the essential graph. A Sim3 is the 4x4
matrix [[s R, t], [0, 1]]; tangent vectors are xi = (upsilon, omega,
sigma): translation, rotation, log-scale.
"""

from __future__ import annotations

import torch

from orb_slam2_test_tpu_torch.geometry.se3 import hat, rt_to_mat, so3_exp, so3_log

_EPS = 1e-8


def sim3_make(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(s [...], R [..., 3, 3], t [..., 3]) -> S [..., 4, 4] = [[sR, t], [0, 1]]."""
    return rt_to_mat(s[..., None, None] * R, t)


def sim3_scale(S: torch.Tensor) -> torch.Tensor:
    """s = the norm of the first row of sR (R orthonormal)."""
    return torch.linalg.norm(S[..., 0, :3], dim=-1)


def sim3_rotation(S: torch.Tensor) -> torch.Tensor:
    return S[..., :3, :3] / sim3_scale(S)[..., None, None]


def sim3_translation(S: torch.Tensor) -> torch.Tensor:
    return S[..., :3, 3]


def sim3_from_se3(T: torch.Tensor, s: torch.Tensor | None = None) -> torch.Tensor:
    """Lift SE3 to Sim3 with scale s (default 1), as the reference's
    LoopClosing builds g2o::Sim3(Rcw, tcw, 1.0)."""
    if s is None:
        s = torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device)
    return sim3_make(s, T[..., :3, :3], T[..., :3, 3])


def se3_from_sim3(S: torch.Tensor) -> torch.Tensor:
    """Project Sim3 back to SE3 as T = [R | t / s] (the reference's
    CorrectLoop)."""
    s = sim3_scale(S)
    return rt_to_mat(sim3_rotation(S), sim3_translation(S) / s[..., None])


def sim3_inverse(S: torch.Tensor) -> torch.Tensor:
    """S^-1 = [[R^T / s, -R^T t / s], [0, 1]]."""
    s = sim3_scale(S)
    Rt = sim3_rotation(S).transpose(-1, -2)
    inv_s = 1.0 / s
    t = (Rt @ sim3_translation(S)[..., None])[..., 0]
    return sim3_make(inv_s, Rt, -inv_s[..., None] * t)


def sim3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The matrix product composes Sim3s."""
    return A @ B


def sim3_apply(S: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply S [..., 4, 4] to points x [..., 3]: s R x + t."""
    return (S[..., :3, :3] @ x[..., None])[..., 0] + S[..., :3, 3]


def _sim3_W(omega: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """W of the Sim(3) exponential (t = W upsilon): A I + B [w]_x +
    C [w]_x^2, with series forms for small sigma and theta."""
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    s = torch.exp(sigma)
    sigma2 = sigma * sigma
    small_sigma = sigma.abs() < 1e-4
    small_theta = theta < 1e-4

    A_gen = (s - 1.0) / torch.where(small_sigma, 1.0, sigma)
    A0 = 1.0 + sigma / 2.0 + sigma2 / 6.0
    coefA = torch.where(small_sigma, A0, A_gen)

    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    denom = sigma2 + theta2
    safe_theta = torch.where(small_theta, 1.0, theta)
    safe_denom = torch.where(denom < _EPS, 1.0, denom)
    a_ = s * sin_t
    b_ = s * cos_t

    B_gen = (a_ * sigma + (1.0 - b_) * safe_theta) / (safe_theta * safe_denom)
    B_sigma0 = torch.where(
        small_theta, 0.5 - theta2 / 24.0,
        (1.0 - cos_t) / torch.where(small_theta, 1.0, theta2))
    coefB = torch.where(small_sigma, B_sigma0, torch.where(small_theta, 0.5 * coefA, B_gen))

    C_gen = (coefA - ((b_ - 1.0) * sigma + a_ * safe_theta) / safe_denom) / torch.where(
        small_theta, 1.0, theta2)
    C_sigma0 = torch.where(
        small_theta, 1.0 / 6.0 - theta2 / 120.0,
        (theta - sin_t) / torch.where(small_theta, 1.0, theta2 * safe_theta))
    coefC = torch.where(small_sigma, C_sigma0, torch.where(small_theta, coefA / 6.0, C_gen))

    K = hat(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    return (coefA[..., None, None] * eye + coefB[..., None, None] * K
            + coefC[..., None, None] * (K @ K))


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """xi [..., 7] = (upsilon, omega, sigma) -> S [..., 4, 4]."""
    upsilon, omega, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    W = _sim3_W(omega, sigma)
    t = (W @ upsilon[..., None])[..., 0]
    return sim3_make(torch.exp(sigma), so3_exp(omega), t)


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    """S [..., 4, 4] -> xi [..., 7] = (upsilon, omega, sigma), solving W
    upsilon = t. `solve_ex` gives non-finite values for a singular W
    instead of raising or reading a status back to the host."""
    s = sim3_scale(S)
    sigma = torch.log(s)
    omega = so3_log(sim3_rotation(S))
    W = _sim3_W(omega, sigma)
    upsilon = torch.linalg.solve_ex(W, sim3_translation(S)[..., None]).result[..., 0]
    return torch.cat([upsilon, omega, sigma[..., None]], dim=-1)


def tangent_jacobian(f, xi: torch.Tensor) -> torch.Tensor:
    """Forward-mode Jacobian of f at xi [..., n]: [..., *out, n], where
    f maps xi [d, ..., n] to [d, ..., *out] broadcasting over its leading
    dims. The n basis directions run as one batch of `torch.func.jvp`
    (what jax.jacfwd does); every tensor keeps its batch dims, since
    torch.func's transforms give a float64 tangent to a 0-d float32
    tensor divided by a Python number."""
    n = xi.shape[-1]
    eye = torch.eye(n, dtype=xi.dtype, device=xi.device)
    prim = xi.unsqueeze(0).expand((n,) + tuple(xi.shape)).contiguous()
    tang = eye.view((n,) + (1,) * (xi.dim() - 1) + (n,)).expand_as(prim).contiguous()
    _, jt = torch.func.jvp(f, (prim,), (tang,))
    return jt.movedim(0, -1)
