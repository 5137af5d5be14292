"""Monocular map initialization: homography and fundamental RANSAC, then
reconstruction.

Port of orb_slam2_test_tpu/solvers/initializer.py (reference:
src/Initializer.cc). Both model families are batches of hypotheses: one
[S, 8] sample tensor each, one batched SVD for the DLT solves, one
[S, M] scoring pass; the model is chosen by RH = SH / (SH + SF) > 0.40,
each is refitted on its consensus set, and the 8 (homography) or 4
(fundamental) motion hypotheses are triangulated and scored as a batch.

RANSAC samples come from an explicit torch.Generator on the host (the
JAX package draws them with jax.random), or are passed in, so that a
test can feed the JAX package's own samples. Inverses are taken with
`inv_ex`: random 8-point samples make near-singular matrices, and
`inv_ex` returns inf or nan for them, as XLA does, where `inv` raises
(and on the card synchronizes to check). SVD signs differ between
LAPACK, cuSOLVER and XLA; every use here is sign-free (H is normalized
by H[2, 2], F enters squared, E's factors are made proper rotations).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera, camera_matrix
from orb_slam2_test_tpu_torch.geometry.linalg import svd
from orb_slam2_test_tpu_torch.geometry.se3 import rt_to_mat
from orb_slam2_test_tpu_torch.geometry.triangulation import triangulate_dlt
from orb_slam2_test_tpu_torch.utils.precision import f32_matmuls

# reference Initializer: mSigma = 1.0, 200 RANSAC iterations, 8-pt samples
SIGMA = 1.0
RANSAC_ITERS = 200
SAMPLE = 8
TH_H = 5.991  # 2-dof transfer error
TH_F = 3.841  # 1-dof epipolar distance
TH_SCORE = 5.991
MIN_TRIANGULATED = 50
MIN_PARALLAX_DEG = 1.0


class InitResult(NamedTuple):
    success: torch.Tensor  # [] bool
    used_homography: torch.Tensor  # [] bool
    Tcw2: torch.Tensor  # [4, 4] second-camera pose (first camera = identity)
    points: torch.Tensor  # [M, 3] triangulated points
    good: torch.Tensor  # [M] bool: triangulated and every gate passed
    n_good: torch.Tensor  # [] int32


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device):
    """(W of the essential decomposition, 3x3 identity), on `device`."""
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], device=device)
    return W, torch.eye(3, device=device)


def _inv(A: torch.Tensor) -> torch.Tensor:
    """LU inverse without a singularity check (see the module docstring)."""
    return torch.linalg.inv_ex(A).inverse


def _normalize(uv: torch.Tensor, valid: torch.Tensor):
    """Zero-mean / unit mean-absolute-deviation normalization (reference
    Initializer::Normalize). Returns (normalized uv, T [3, 3])."""
    w = valid.to(uv.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (uv * w[:, None]).sum(0) / n
    meandev = ((uv - mean).abs() * w[:, None]).sum(0) / n
    s = 1.0 / torch.clamp(meandev, min=1e-8)
    uvn = (uv - mean) * s
    z = torch.zeros_like(s[0])
    one = torch.ones_like(s[0])
    T = torch.stack([
        torch.stack([s[0], z, -mean[0] * s[0]]),
        torch.stack([z, s[1], -mean[1] * s[1]]),
        torch.stack([z, z, one]),
    ])
    return uvn, T


def sample_indices(
    valid: torch.Tensor, n_iters: int, k: int, generator: torch.Generator
) -> torch.Tensor:
    """[n_iters, k] indices drawn with replacement, uniformly over the
    valid entries (the JAX package's `_sample_indices`), from a host
    generator; returned on valid's device."""
    p = valid.detach().to("cpu", torch.float64)
    if not bool((p > 0).any()):
        p = torch.ones_like(p)
    idx = torch.multinomial(p, n_iters * k, replacement=True, generator=generator)
    return idx.view(n_iters, k).to(valid.device)


def _h_rows(u1, v1, u2, v2):
    """The two DLT rows of each homography correspondence."""
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    row1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    row2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    return row1, row2


def _f_rows(u1, v1, u2, v2):
    """The epipolar-constraint row of each correspondence."""
    o = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], dim=-1)


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """The right singular vector of the smallest singular value, [..., 9]."""
    return torch.linalg.svd(A, full_matrices=True).Vh[..., 8, :]


def _rank2(F: torch.Tensor) -> torch.Tensor:
    """F with its smallest singular value zeroed."""
    U, d, Vh = svd(F)
    d = torch.cat([d[..., :2], torch.zeros_like(d[..., 2:])], dim=-1)
    return U @ (d[..., None] * Vh)


def _solve_h_dlt(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Batched homography DLT: x1, x2 [S, 8, 2] -> H [S, 3, 3], x2 ~ H x1."""
    row1, row2 = _h_rows(x1[..., 0], x1[..., 1], x2[..., 0], x2[..., 1])
    return _null_vector(torch.cat([row1, row2], dim=1)).reshape(-1, 3, 3)


def _solve_f_8pt(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Batched 8-point fundamental: [S, 8, 2] pairs -> F [S, 3, 3], rank 2."""
    A = _f_rows(x1[..., 0], x1[..., 1], x2[..., 0], x2[..., 1])
    return _rank2(_null_vector(A).reshape(-1, 3, 3))


def _refit_f(uv1n, uv2n, mask) -> torch.Tensor:
    """Least-squares F on the whole consensus set (rows outside it zeroed).
    The reference keeps the best minimal-sample model; the refit brings
    the model error down to the noise before reconstruction."""
    A = _f_rows(uv1n[:, 0], uv1n[:, 1], uv2n[:, 0], uv2n[:, 1])
    A = A * mask[:, None].to(A.dtype)
    return _rank2(_null_vector(A).reshape(3, 3))


def _refit_h(uv1n, uv2n, mask) -> torch.Tensor:
    """Least-squares H on the whole consensus set."""
    row1, row2 = _h_rows(uv1n[:, 0], uv1n[:, 1], uv2n[:, 0], uv2n[:, 1])
    A = torch.cat([row1, row2], dim=0) * torch.cat([mask, mask])[:, None].to(uv1n.dtype)
    return _null_vector(A).reshape(3, 3)


def _homogeneous(uv: torch.Tensor) -> torch.Tensor:
    return torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)


def _transfer(H: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[S, 3, 3] x [M, 3] -> [S, M, 2] dehomogenized."""
    q = torch.einsum("sij,mj->smi", H, p)
    return q[..., :2] / torch.where(q[..., 2:].abs() > 1e-12, q[..., 2:], 1e-12)


def _score_h(H, H_inv, uv1, uv2, valid):
    """Symmetric transfer score (Initializer::CheckHomography). Returns
    (score [S], inliers [S, M])."""
    p1, p2 = _homogeneous(uv1), _homogeneous(uv2)
    d2 = ((uv2[None] - _transfer(H, p1)) ** 2).sum(-1) / (SIGMA * SIGMA)
    d1 = ((uv1[None] - _transfer(H_inv, p2)) ** 2).sum(-1) / (SIGMA * SIGMA)
    in1 = (d1 < TH_H) & valid[None]
    in2 = (d2 < TH_H) & valid[None]
    score = (torch.where(in1, TH_H - d1, 0.0) + torch.where(in2, TH_H - d2, 0.0)).sum(-1)
    return score, in1 & in2


def _score_f(F, uv1, uv2, valid):
    """Epipolar-distance score (Initializer::CheckFundamental)."""
    p1, p2 = _homogeneous(uv1), _homogeneous(uv2)
    l2 = torch.einsum("sij,mj->smi", F, p1)  # epipolar lines in image 2
    num2 = torch.einsum("mi,smi->sm", p2, l2) ** 2
    d2 = num2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12) / (SIGMA * SIGMA)
    l1 = torch.einsum("sji,mj->smi", F, p2)  # epipolar lines in image 1
    num1 = torch.einsum("mi,smi->sm", p1, l1) ** 2
    d1 = num1 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12) / (SIGMA * SIGMA)
    in1 = (d1 < TH_F) & valid[None]
    in2 = (d2 < TH_F) & valid[None]
    score = (torch.where(in1, TH_SCORE - d1, 0.0)
             + torch.where(in2, TH_SCORE - d2, 0.0)).sum(-1)
    return score, in1 & in2


def _decompose_E(E: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """E [3, 3] -> (R [4, 3, 3], t [4, 3]) candidate motions."""
    U, _, Vt = svd(E)
    U = U * torch.sign(torch.linalg.det(U))  # proper rotations
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W, _ = _constants(E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_H(H: torch.Tensor, K: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Faugeras's SVD decomposition of a homography into 8 (R, t)
    candidates (reference Initializer::ReconstructH)."""
    A = _inv(K) @ H @ K
    U, d, Vt = svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    dev = H.device
    signs = torch.tensor([1.0, -1.0, -1.0, 1.0], device=dev)

    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0) / denom)
    aux3 = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0) / denom)
    x1s = torch.tensor([1.0, 1.0, -1.0, -1.0], device=dev) * aux1
    x3s = torch.tensor([1.0, -1.0, 1.0, -1.0], device=dev) * aux3
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    z4, o4 = torch.zeros(4, device=dev), torch.ones(4, device=dev)

    def rows(a, b, c):  # [4, 3] from three [4] columns
        return torch.stack([a, b, c], dim=-1)

    # case d' = +d2
    aux_st = root / torch.clamp((d1 + d3) * d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    st = signs * aux_st
    ct4 = ct.expand(4)
    Rp_pos = torch.stack([rows(ct4, z4, -st), rows(z4, o4, z4), rows(st, z4, ct4)], dim=1)
    tp_pos = rows(x1s, z4, -x3s) * (d1 - d3)
    # case d' = -d2
    aux_sp = root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cp = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    sp = signs * aux_sp
    cp4 = cp.expand(4)
    Rp_neg = torch.stack([rows(cp4, z4, sp), rows(z4, -o4, z4), rows(sp, z4, -cp4)], dim=1)
    tp_neg = rows(x1s, z4, x3s) * (d1 + d3)

    Rs = s * U @ torch.cat([Rp_pos, Rp_neg]) @ Vt
    ts = torch.cat([tp_pos, tp_neg]) @ U.T
    ts = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True), min=1e-12)
    return Rs, ts


def _check_rt(Rs, ts, K, uv1, uv2, inliers):
    """Initializer::CheckRT for a batch of B hypotheses: triangulate all
    inlier matches under each (R, t) and count the good points. Returns
    (n_good [B], parallax_deg [B], points [B, M, 3], good [B, M])."""
    B, M = Rs.shape[0], uv1.shape[0]
    _, I3 = _constants(K.device)
    P1 = K @ torch.cat([I3, torch.zeros_like(I3[:, :1])], dim=1)
    P2 = K @ rt_to_mat(Rs, ts)[:, :3, :]  # [B, 3, 4]
    pts = triangulate_dlt(
        P1.expand(B, M, 3, 4), P2[:, None].expand(B, M, 3, 4),
        uv1.expand(B, M, 2), uv2.expand(B, M, 2),
    )
    finite = torch.isfinite(pts).all(-1)
    pts = torch.where(finite[..., None], pts, 0.0)

    z1 = pts[..., 2]
    pc2 = pts @ Rs.transpose(-1, -2) + ts[:, None, :]
    z2 = pc2[..., 2]
    O2 = -(Rs.transpose(-1, -2) @ ts[..., None])[..., 0]
    r2 = pts - O2[:, None, :]
    cos_par = (pts * r2).sum(-1) / torch.clamp(
        torch.linalg.norm(pts, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-12
    )

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def reproj2(pc, uv):
        z = pc[..., 2]
        z = torch.where(z.abs() > 1e-9, z, 1e-9)
        return (fx * pc[..., 0] / z + cx - uv[..., 0]) ** 2 + (fy * pc[..., 1] / z + cy - uv[..., 1]) ** 2

    th2 = 4.0 * SIGMA * SIGMA
    good = (
        inliers & finite & (z1 > 0.0) & (z2 > 0.0) & (cos_par < 0.99998)
        & (reproj2(pts, uv1) < th2) & (reproj2(pc2, uv2) < th2)
    )
    n_good = good.sum(-1, dtype=torch.int32)
    # the parallax statistic: the 50th largest parallax angle (the
    # reference takes the min(50, n)-th)
    ang = torch.where(good, torch.arccos(torch.clamp(cos_par, -1.0, 1.0)), 0.0)
    top50 = torch.topk(ang, min(50, M), dim=-1).values
    nth = torch.clamp(torch.clamp(n_good, max=50) - 1, 0, top50.shape[-1] - 1).to(torch.int64)
    parallax_deg = torch.rad2deg(top50.gather(-1, nth[:, None])[:, 0])
    return n_good, parallax_deg, pts, good


def initialize_mono(
    cam: PinholeCamera,
    uv1: torch.Tensor,  # [M, 2] undistorted keypoints in frame 1
    uv2: torch.Tensor,  # [M, 2] matched keypoints in frame 2
    valid: torch.Tensor,  # [M] bool: the match exists
    generator: torch.Generator | None = None,
    n_iters: int = RANSAC_ITERS,
    min_triangulated: int = MIN_TRIANGULATED,
    samples: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> InitResult:
    """Monocular initialization (Initializer::Initialize). `samples`
    gives the RANSAC draws (idx_h, idx_f), each [n_iters, 8] indices
    into the matches; without it they are drawn from `generator`
    (seed 0 if None)."""
    f32_matmuls()
    dev = uv1.device
    if samples is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        samples = tuple(sample_indices(valid, n_iters, SAMPLE, generator) for _ in range(2))
    idx_h, idx_f = (torch.as_tensor(i, device=dev).to(torch.int64) for i in samples)
    K = camera_matrix(cam, dev)

    uv1n, T1 = _normalize(uv1, valid)
    uv2n, T2 = _normalize(uv2, valid)
    T2inv = _inv(T2)

    # homography hypotheses, denormalized and scaled to H[2, 2] = 1
    H = T2inv[None] @ _solve_h_dlt(uv1n[idx_h], uv2n[idx_h]) @ T1[None]
    H = H / torch.where(H[:, 2:3, 2:3].abs() > 1e-12, H[:, 2:3, 2:3], 1e-12)
    score_h, in_h = _score_h(H, _inv(H), uv1, uv2, valid)
    best_h = torch.argmax(score_h)
    # refit on the consensus set, then rescore the refined model
    H_best = T2inv @ _refit_h(uv1n, uv2n, in_h[best_h]) @ T1
    H_best = H_best / torch.where(H_best[2, 2].abs() > 1e-12, H_best[2, 2], 1e-12)
    score_hr, in_hr = _score_h(H_best[None], _inv(H_best)[None], uv1, uv2, valid)
    SH, in_h_best = score_hr[0], in_hr[0]

    # fundamental hypotheses
    F = T2.T[None] @ _solve_f_8pt(uv1n[idx_f], uv2n[idx_f]) @ T1[None]
    score_f, in_f = _score_f(F, uv1, uv2, valid)
    best_f = torch.argmax(score_f)
    F_best = T2.T @ _refit_f(uv1n, uv2n, in_f[best_f]) @ T1
    score_fr, in_fr = _score_f(F_best[None], uv1, uv2, valid)
    SF, in_f_best = score_fr[0], in_fr[0]

    use_h = SH / torch.clamp(SH + SF, min=1e-12) > 0.40  # reference threshold

    # reconstruct both and select: F's 4 candidates are padded to 8 with
    # (identity, zero t), which has no parallax and so no good point
    Rs_h, ts_h = _decompose_H(H_best, K)
    Rs_f, ts_f = _decompose_E(K.T @ F_best @ K)
    _, I3 = _constants(dev)
    Rs_f = torch.cat([Rs_f, I3.expand(4, 3, 3)])
    ts_f = torch.cat([ts_f, torch.zeros_like(ts_f)])
    Rs = torch.where(use_h, Rs_h, Rs_f)
    ts = torch.where(use_h, ts_h, ts_f)
    inl = torch.where(use_h, in_h_best, in_f_best)

    n_good, par, pts, good = _check_rt(Rs, ts, K, uv1, uv2, inl)
    order = torch.argsort(-n_good, stable=True)
    b0, b1 = order[0], order[1]
    n_best, n_second = n_good[b0], n_good[b1]
    n_inl = inl.sum(dtype=torch.int32)
    min_good = torch.clamp((0.9 * n_inl.to(torch.float32)).to(torch.int32), min=min_triangulated)
    ok = (
        (n_best >= min_good)
        & (n_second.to(torch.float32) < 0.75 * n_best.to(torch.float32))
        & (par[b0] > MIN_PARALLAX_DEG)
    )
    return InitResult(
        success=ok,
        used_homography=use_h,
        Tcw2=rt_to_mat(Rs[b0], ts[b0]),
        points=pts[b0],
        good=good[b0],
        n_good=n_best,
    )

