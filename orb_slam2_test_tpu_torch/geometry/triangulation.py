"""Linear triangulation and its acceptance checks, batched.

Port of orb_slam2_test_tpu/geometry/triangulation.py (reference:
Initializer::Triangulate and the acceptance block of
LocalMapping::CreateNewMapPoints). The SVD null-vector form
(`triangulate_dlt_svd`) is a validation oracle of the JAX package and
is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera, project
from orb_slam2_test_tpu_torch.geometry.linalg import inv3x3
from orb_slam2_test_tpu_torch.geometry.se3 import se3_apply


def _dlt_system(P1, P2, uv1, uv2) -> torch.Tensor:
    """The 4x4 homogeneous DLT system A X_h = 0, [..., 4, 4]."""
    return torch.stack(
        [
            uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ],
        dim=-2,
    )


def triangulate_dlt(
    P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor
) -> torch.Tensor:
    """DLT triangulation in closed form: P1, P2 [..., 3, 4] projection
    matrices K [R|t], uv1, uv2 [..., 2] pixels -> world points [..., 3].

    Solves the inhomogeneous form (w = 1) of A X_h = 0 by its 3x3
    normal equations and the adjugate inverse. Near-infinite points
    (w ~ 0) come out huge or non-finite, and the parallax, reprojection
    and cheirality gates reject them."""
    A = _dlt_system(P1, P2, uv1, uv2)
    B = A[..., :, :3]
    c = A[..., :, 3]
    M = torch.einsum("...ki,...kj->...ij", B, B)
    rhs = -torch.einsum("...ki,...k->...i", B, c)
    return torch.einsum("...ij,...j->...i", inv3x3(M), rhs)


class TriangulationCheck(NamedTuple):
    ok: torch.Tensor  # [...] bool, passes all gates
    parallax_cos: torch.Tensor  # [...] cosine of the parallax angle
    z1: torch.Tensor
    z2: torch.Tensor


def triangulation_checks(
    cam: PinholeCamera,
    Tcw1: torch.Tensor,
    Tcw2: torch.Tensor,
    x_world: torch.Tensor,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    reproj_chi2: float = 5.991,
    sigma2_1: torch.Tensor | float = 1.0,
    sigma2_2: torch.Tensor | float = 1.0,
    min_parallax_cos: float = 0.9998,
) -> TriangulationCheck:
    """Positive depth in both views, parallax cosine below
    min_parallax_cos, and squared reprojection error below
    reproj_chi2 * sigma^2 in both views."""
    c1 = se3_apply(Tcw1, x_world)
    c2 = se3_apply(Tcw2, x_world)
    z1, z2 = c1[..., 2], c2[..., 2]

    O1 = -torch.einsum("...ji,...j->...i", Tcw1[..., :3, :3], Tcw1[..., :3, 3])
    O2 = -torch.einsum("...ji,...j->...i", Tcw2[..., :3, :3], Tcw2[..., :3, 3])
    r1 = x_world - O1
    r2 = x_world - O2
    cos_par = (r1 * r2).sum(-1) / (
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1) + 1e-12
    )

    p1, _ = project(cam, c1)
    p2, _ = project(cam, c2)
    e1 = ((p1 - uv1) ** 2).sum(-1)
    e2 = ((p2 - uv2) ** 2).sum(-1)

    ok = (
        (z1 > 0.0)
        & (z2 > 0.0)
        & (cos_par < min_parallax_cos)
        & (e1 < reproj_chi2 * sigma2_1)
        & (e2 < reproj_chi2 * sigma2_2)
    )
    return TriangulationCheck(ok=ok, parallax_cos=cos_par, z1=z1, z2=z2)
