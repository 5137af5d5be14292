"""PnP RANSAC for relocalization.

Port of orb_slam2_test_tpu/solvers/pnp.py (reference: src/PnPsolver.cc,
EPnP + Gauss-Newton inside adaptive RANSAC). Each round draws a batch
of 6-point samples, solves every sample's DLT projection system with
one batched SVD, extracts [R|t], refines each hypothesis by 3
Gauss-Newton sweeps on its own sample, and scores all hypotheses
against all points in one [S, M] reprojection pass. The winner is
polished by Gauss-Newton on its consensus set.

Two departures from the JAX package:
- Samples come from the caller (`draw(valid, n) -> [n, 6]` indices per
  round), not from a PRNG key inside the round, so tests can replay the
  JAX package's `jax.random.choice` draws.
- `_extract_rt` is sign-free. The DLT null vector's sign is whatever the
  SVD backend returns (LAPACK, cuSOLVER and XLA differ), and for
  P = lambda [R|t] with lambda < 0 the JAX package's extraction returns
  a rotation 180 degrees off. Here P is first multiplied by the sign of
  det P[:, :3], which leaves a P of positive det exactly as the JAX
  package treats it.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.geometry.linalg import inv6x6_spd
from orb_slam2_test_tpu_torch.geometry.se3 import rt_to_mat, se3_exp
from orb_slam2_test_tpu_torch.solvers.reprojection import project_residual
from orb_slam2_test_tpu_torch.utils.precision import f32_matmuls

SAMPLE = 6  # points per DLT hypothesis


class PnPResult(NamedTuple):
    success: torch.Tensor  # [] bool
    Tcw: torch.Tensor  # [4, 4]
    inliers: torch.Tensor  # [M] bool
    n_inliers: torch.Tensor  # [] int32


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 determinant by cofactors, [..., 3, 3] -> [...]."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _solve_p6p_dlt(X: torch.Tensor, uvn: torch.Tensor) -> torch.Tensor:
    """Batched DLT: X [S, 6, 3] world points, uvn [S, 6, 2] normalized
    image coords -> P [S, 3, 4] projection matrices, up to scale and
    sign (the right singular vector of the smallest singular value)."""
    S = X.shape[0]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)  # [S, 6, 4]
    zeros = torch.zeros_like(Xh)
    u = uvn[..., 0:1]
    v = uvn[..., 1:2]
    r1 = torch.cat([Xh, zeros, -u * Xh], dim=-1)  # [S, 6, 12]
    r2 = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=1)  # [S, 12, 12]
    Vh = torch.linalg.svd(A, full_matrices=True).Vh
    return Vh[:, 11, :].reshape(S, 3, 4)


def _extract_rt(P: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[S, 3, 4] -> (R [S, 3, 3], t [S, 3]): P's sign made that of a
    positive det P[:, :3], R orthogonalized via SVD with det(R) = +1 and
    the scale fixed by the mean singular value."""
    P = P * torch.where(_det3(P[:, :, :3]) < 0, -1.0, 1.0)[:, None, None]
    U, d, Vt = torch.linalg.svd(P[:, :, :3])
    sign_uv = torch.sign(_det3(U @ Vt))
    D = torch.diag_embed(torch.stack(
        [torch.ones_like(sign_uv), torch.ones_like(sign_uv), sign_uv], dim=-1))
    R = U @ D @ Vt
    scale = d.mean(-1) * sign_uv
    t = P[:, :, 3] / torch.where(scale.abs() > 1e-12, scale, 1e-12)[:, None]
    return R, t


def _pnp_round(
    cam: PinholeCamera,
    X: torch.Tensor,  # [M, 3]
    uv: torch.Tensor,  # [M, 2]
    valid: torch.Tensor,  # [M] bool
    idx: torch.Tensor,  # [S, 6] sample indices
    chi2_th: float,
):
    """One batch of S DLT-P6P hypotheses, scored against all points.
    Returns (best_score [] int32, best_Tcw [4, 4], best_inliers [M],
    n_negative [] int32: the hypotheses whose DLT P had a negative det
    P[:, :3], the ones the JAX package's extraction turns 180 degrees)."""
    f32_matmuls()
    idx = idx.to(torch.int64)
    uvn = torch.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], dim=-1)
    Xs = X[idx]  # [S, 6, 3]
    P = _solve_p6p_dlt(Xs, uvn[idx])
    n_negative = (_det3(P[:, :, :3]) < 0).sum(dtype=torch.int32)
    R, t = _extract_rt(P)

    # per-hypothesis Gauss-Newton on its own sample (the reference EPnP's
    # gauss_newton step): the orthogonalized DLT pose is too loose to
    # capture the consensus set at low inlier ratios
    obs_s = torch.cat([uv[idx], -torch.ones_like(uv[idx][..., :1])], dim=-1)
    ones = torch.ones(Xs.shape[:2], dtype=X.dtype, device=X.device)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    T = rt_to_mat(R, t)  # [S, 4, 4]
    for _ in range(3):
        res = project_residual(cam, T[:, None, :, :], Xs, obs_s, ones)
        ok = res.depth_ok[..., None, None].to(X.dtype)
        Jc = res.Jc * ok  # [S, 6, 3, 6]
        H = torch.einsum("snki,snkj->sij", Jc, Jc) + 1e-5 * eye6
        b = -torch.einsum("snki,snk->si", Jc, res.r * ok[..., 0])
        dx = torch.einsum("sij,sj->si", inv6x6_spd(H), b)
        dx = torch.where(torch.isfinite(dx).all(-1, keepdim=True), dx, 0.0)
        T = se3_exp(dx) @ T
    R = T[:, :3, :3]
    t = T[:, :3, 3]

    # score: reprojection error per hypothesis x point
    pc = torch.einsum("sij,mj->smi", R, X) + t[:, None, :]  # [S, M, 3]
    z = pc[..., 2]
    zs = torch.where(z.abs() > 1e-6, z, 1e-6)
    up = cam.fx * pc[..., 0] / zs + cam.cx
    vp = cam.fy * pc[..., 1] / zs + cam.cy
    e2 = (up - uv[None, :, 0]) ** 2 + (vp - uv[None, :, 1]) ** 2
    inl = (e2 < chi2_th) & (z > 0.0) & valid[None, :]
    scores = inl.sum(-1, dtype=torch.int32)
    best = scores.argmax()  # the first of equal scores, as jnp.argmax
    return scores[best], rt_to_mat(R[best], t[best]), inl[best], n_negative


def _pnp_polish(
    cam: PinholeCamera,
    X: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    Tcw: torch.Tensor,
    cur_inl: torch.Tensor,
    chi2_th: float,
    min_inliers: int,
) -> PnPResult:
    """Gauss-Newton polish on the consensus set and inlier re-estimation,
    2 rounds of 5 sweeps (the reference's EPnP refines with gauss_newton
    the same way). The 6x6 solve is `solve_ex`: no status read back."""
    f32_matmuls()
    M = X.shape[0]
    obs = torch.cat([uv, -torch.ones((M, 1), dtype=X.dtype, device=X.device)], dim=-1)
    isig2 = torch.ones(M, dtype=X.dtype, device=X.device)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(2):
        for _ in range(5):
            res = project_residual(cam, Tcw, X, obs, isig2)
            w = (cur_inl & valid & res.depth_ok).to(X.dtype)
            JTw = res.Jc.transpose(-1, -2) * w[:, None, None]
            Hm = torch.einsum("oij,ojk->ik", JTw, res.Jc) + 1e-6 * eye6
            bm = -torch.einsum("oij,oj->i", JTw, res.r)
            dx = torch.linalg.solve_ex(Hm, bm)[0]
            dx = torch.where(torch.isfinite(dx).all(), dx, torch.zeros_like(dx))
            Tcw = se3_exp(dx) @ Tcw
        res = project_residual(cam, Tcw, X, obs, isig2)
        cur_inl = (res.chi2 < chi2_th) & res.depth_ok & valid
    n_inl = cur_inl.sum(dtype=torch.int32)
    return PnPResult(success=n_inl >= min_inliers, Tcw=Tcw, inliers=cur_inl, n_inliers=n_inl)


def pnp_ransac(
    cam: PinholeCamera,
    X: torch.Tensor,  # [M, 3] world points
    uv: torch.Tensor,  # [M, 2] observed pixels
    valid: torch.Tensor,  # [M]
    idx: torch.Tensor,  # [n_iters, 6] sample indices
    chi2_th: float = 5.991,
    min_inliers: int = 10,
) -> PnPResult:
    """Fixed-budget batched-hypothesis PnP RANSAC (one round)."""
    _, Tcw, inl, _ = _pnp_round(cam, X, uv, valid, idx, chi2_th)
    return _pnp_polish(cam, X, uv, valid, Tcw, inl, chi2_th, min_inliers)


class PnPStats(NamedTuple):
    rounds: int
    hypotheses: int
    negative_det: int  # hypotheses whose DLT P had det P[:, :3] < 0


def pnp_ransac_adaptive(
    cam: PinholeCamera,
    X: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    draw: Callable[[torch.Tensor, int], torch.Tensor],
    batch: int = 256,
    max_hypotheses: int = 16384,
    confidence: float = 0.99,
    chi2_th: float = 5.991,
    min_inliers: int = 10,
) -> tuple[PnPResult, PnPStats]:
    """Adaptive-iteration PnP RANSAC (PnPsolver::SetRansacParameters:
    nIterations = log(1 - p) / log(1 - w^6) from the running inlier
    ratio) in rounds of `batch` hypotheses, `draw(valid, batch)` giving
    each round's [batch, 6] sample indices. The host reads back one
    score per round (with the round's negative-det count), updates the
    required-trials bound from the best consensus so far and stops when
    the trials reach it or max_hypotheses (64 rounds of 256)."""
    n_valid = max(int(valid.sum()), 1)
    best_score, best_Tcw, best_inl = 0, None, None
    done = rounds = n_negative = 0
    required = max_hypotheses
    while done < min(required, max_hypotheses):
        score, Tcw, inl, neg = _pnp_round(cam, X, uv, valid, draw(valid, batch), chi2_th)
        score, neg = torch.stack([score, neg]).tolist()
        done += batch
        rounds += 1
        n_negative += neg
        if score > best_score:
            best_score, best_Tcw, best_inl = score, Tcw, inl
            w = min(max(score / n_valid, 1e-3), 0.999)
            denom = math.log(max(1.0 - w ** SAMPLE, 1e-12))
            required = int(math.ceil(math.log(1.0 - confidence) / denom))
    stats = PnPStats(rounds, done, n_negative)
    if best_Tcw is None or best_score < SAMPLE:
        M = X.shape[0]
        return PnPResult(
            success=torch.zeros((), dtype=torch.bool, device=X.device),
            Tcw=torch.eye(4, dtype=X.dtype, device=X.device),
            inliers=torch.zeros(M, dtype=torch.bool, device=X.device),
            n_inliers=torch.zeros((), dtype=torch.int32, device=X.device),
        ), stats
    return _pnp_polish(cam, X, uv, valid, best_Tcw, best_inl, chi2_th, min_inliers), stats
