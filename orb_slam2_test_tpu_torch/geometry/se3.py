"""SE(3) / SO(3) operations, batched over leading dimensions.

Port of orb_slam2_test_tpu/geometry/se3.py. Poses are 4x4 homogeneous
matrices T = [[R, t], [0, 1]]; tangent vectors are xi = (upsilon,
omega) with translation first (g2o's SE3Quat::exp convention).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(omega: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [omega]_x, batched over leading dims."""
    o0, o1, o2 = omega[..., 0], omega[..., 1], omega[..., 2]
    z = torch.zeros_like(o0)
    return torch.stack(
        [
            torch.stack([z, -o2, o1], dim=-1),
            torch.stack([o2, z, -o0], dim=-1),
            torch.stack([-o1, o0, z], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues: omega [..., 3] -> R [..., 3, 3], series-safe at 0."""
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    a = torch.where(theta2 > _EPS, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(
        theta2 > _EPS, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0
    )
    K = hat(omega)
    KK = K @ K
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * KK


def _left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(omega), the translation part of se3_exp."""
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    b = torch.where(
        theta2 > _EPS, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0
    )
    c = torch.where(
        theta2 > _EPS,
        (theta - torch.sin(theta)) / (theta2 * theta),
        1.0 / 6.0 - theta2 / 120.0,
    )
    K = hat(omega)
    KK = K @ K
    return _eye_like(K) + b[..., None, None] * K + c[..., None, None] * KK


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """xi [..., 6] = (upsilon, omega) -> T [..., 4, 4]."""
    upsilon, omega = xi[..., :3], xi[..., 3:]
    R = so3_exp(omega)
    t = (_left_jacobian(omega) @ upsilon[..., None])[..., 0]
    return rt_to_mat(R, t)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R [..., 3, 3], t [..., 3]) -> T [..., 4, 4]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)), t.expand(batch + (3,))[..., None]], dim=-1)
    # the row (0, 0, 0, 1) made on the device: no host-to-device copy
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def so3_project(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation onto SO(3) (Gram-Schmidt on columns).

    Composing updates in float32 lets scale and skew creep into R;
    optimizers re-project after composing (see the JAX module)."""
    x = R[..., :, 0]
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    y = R[..., :, 1]
    y = y - (x * y).sum(-1, keepdim=True) * x
    y = y / torch.linalg.norm(y, dim=-1, keepdim=True)
    z = torch.linalg.cross(x, y, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def se3_project(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block of a rigid transform."""
    return rt_to_mat(so3_project(T[..., :3, :3]), T[..., :3, 3])


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform without generic matrix inversion."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rt_to_mat(Rt, -(Rt @ T[..., :3, 3:])[..., 0])


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for homogeneous transforms (broadcasting matmul)."""
    return A @ B


def se3_apply(T: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply T [..., 4, 4] to points x [..., 3]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return (R @ x[..., None])[..., 0] + t
