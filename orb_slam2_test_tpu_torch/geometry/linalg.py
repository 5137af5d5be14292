"""Closed-form inverses of small batched blocks, and the SVD of the
ill-conditioned monocular solves.

Port of orb_slam2_test_tpu/geometry/linalg.py. The local BA inverts
one 3x3 point block per point in every iteration; the adjugate form is
a handful of elementwise ops with no solver call, no pivoting and no
error check that would read a status back to the host.

`svd` is torch.linalg.svd with cuSOLVER's QR-based `gesvd` driver on
the card, where PyTorch's default is the Jacobi `gesvdj`. The monocular
initialization's 3x3 SVDs call it (rank-2 F, the E and Faugeras H
decompositions): on the monocular commands' own inputs the default lands
2.3-2.8 times as far from a float64 SVD as the CPU's float32 one there,
gesvd 0.9-1.3 times, and only frames before the map exists pay gesvd's
time (chip_smoke.py [19f]). The other SVDs keep torch.linalg.svd: the
default is as close as the CPU's at the null vectors and the PnP DLT,
and 1.6-1.7 times at the relocalization's `_extract_rt` and the loop's
Horn alignment, where gesvd would add 24-84 ms a call.
"""

from __future__ import annotations

import torch


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / determinant). A
    determinant of magnitude <= 1e-12 is replaced by 1e-12, as in the
    JAX package, so a singular block gives large finite values."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(det.abs() > 1e-12, det, 1e-12)
    adj = torch.stack([
        torch.stack([A11, A12, A13], dim=-1),
        torch.stack([A21, A22, A23], dim=-1),
        torch.stack([A31, A32, A33], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def inv6x6_spd(A: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Batched 6x6 inverse of symmetric positive-definite blocks by the
    3x3-blockwise Schur formula:

        A = [[P, B], [B^T, D]],  S = D - B^T P^-1 B,
        A^-1 = [[P^-1 + P^-1 B S^-1 B^T P^-1, -P^-1 B S^-1],
                [-S^-1 B^T P^-1,               S^-1        ]]
    """
    Pb = A[..., :3, :3]
    B = A[..., :3, 3:]
    D = A[..., 3:, 3:]
    eye3 = torch.eye(3, dtype=A.dtype, device=A.device)
    Pinv = inv3x3(Pb + eps * eye3)
    PB = Pinv @ B
    S = D - B.transpose(-1, -2) @ PB
    Sinv = inv3x3(S + eps * eye3)
    TL = Pinv + PB @ Sinv @ PB.transpose(-1, -2)
    TR = -PB @ Sinv
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([TR.transpose(-1, -2), Sinv], dim=-1)
    return torch.cat([top, bot], dim=-2)


def svd(A: torch.Tensor, full_matrices: bool = True):
    """torch.linalg.svd(A, full_matrices), with the `gesvd` driver for a
    CUDA tensor; on any other device the call is unchanged."""
    if A.is_cuda:
        return torch.linalg.svd(A, full_matrices=full_matrices, driver="gesvd")
    return torch.linalg.svd(A, full_matrices=full_matrices)
