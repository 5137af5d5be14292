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


def _left_jacobian_inv(omega: torch.Tensor) -> torch.Tensor:
    """Inverse SO(3) left Jacobian, the translation part of se3_log: I -
    K / 2 + c K^2 with c = (1 - (theta / 2) cot(theta / 2)) / theta^2,
    and its series 1/12 + theta^2 / 720 at theta^2 <= 1e-8 (the JAX
    module's switch and guards)."""
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    half = 0.5 * theta
    c = torch.where(
        theta2 > _EPS,
        (1.0 - half * torch.cos(half) / (torch.sin(half) + _EPS)) / (theta2 + _EPS),
        1.0 / 12.0 + theta2 / 720.0,
    )
    K = hat(omega)
    KK = K @ K
    return _eye_like(K) - 0.5 * K + c[..., None, None] * KK


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """xi [..., 6] = (upsilon, omega) -> T [..., 4, 4]."""
    upsilon, omega = xi[..., :3], xi[..., 3:]
    R = so3_exp(omega)
    t = (_left_jacobian(omega) @ upsilon[..., None])[..., 0]
    return rt_to_mat(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """T [..., 4, 4] -> xi [..., 6] = (upsilon, omega)."""
    omega = so3_log(T[..., :3, :3])
    upsilon = (_left_jacobian_inv(omega) @ T[..., :3, 3:])[..., 0]
    return torch.cat([upsilon, omega], dim=-1)


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


def quat_from_rotmat(R: torch.Tensor) -> torch.Tensor:
    """R [..., 3, 3] -> unit quaternion [..., 4] as (x, y, z, w), by
    Shepperd's four candidate constructions and a select of the best
    conditioned one (no branch)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(diag, a, b, c, pos):
        h = torch.sqrt(torch.clamp(diag, min=_EPS)) * 0.5
        parts = [a, b, c]
        parts.insert(pos, 4.0 * h * h)
        return torch.stack(parts, dim=-1) / (4.0 * h[..., None])

    q_w = cand(1.0 + tr, m21 - m12, m02 - m20, m10 - m01, 3)
    q_x = cand(1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12, 0)
    q_y = cand(1.0 - m00 + m11 - m22, m01 + m10, m12 + m21, m02 - m20, 1)
    q_z = cand(1.0 - m00 - m11 + m22, m02 + m20, m12 + m21, m10 - m01, 2)
    cond_w = (tr > 0.0)[..., None]
    cond_x = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond_y = (m11 >= m22)[..., None]
    q = torch.where(cond_w, q_w, torch.where(cond_x, q_x, torch.where(cond_y, q_y, q_z)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues through the quaternion, R [..., 3, 3] -> omega
    [..., 3]: omega = 2 atan2(|v|, w) v / |v| on the w >= 0 hemisphere,
    stable up to theta = pi."""
    q = quat_from_rotmat(R)
    v, w = q[..., :3], q[..., 3]
    sgn = torch.where(w < 0.0, -1.0, 1.0)
    v = v * sgn[..., None]
    w = w * sgn
    n = torch.sqrt((v * v).sum(-1) + _EPS * _EPS)
    return (2.0 * torch.atan2(n, w) / n)[..., None] * v


def rotmat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] as (x, y, z, w), normalized first -> R [...,
    3, 3] (the TUM trajectory order of quat_from_rotmat)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )
