"""Pinhole camera: projection and undistortion.

Port of orb_slam2_test_tpu/geometry/camera.py (reference: src/Frame.cc
UndistortKeyPoints). Conventions are the same: Tcw maps world to
camera, pixels are (u, v) with u along the width, and a stereo
observation has u_right = u - bf / depth.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PinholeCamera(NamedTuple):
    """Static camera intrinsics; a plain hashable tuple of Python numbers."""

    fx: float
    fy: float
    cx: float
    cy: float
    # distortion: k1, k2, p1, p2, k3 (OpenCV ordering, as in the YAML files)
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0  # baseline * fx, 0 for pure monocular
    width: int = 640
    height: int = 480

    @property
    def has_distortion(self) -> bool:
        return any(
            abs(float(d)) > 0.0
            for d in (self.k1, self.k2, self.p1, self.p2, self.k3)
        )


def project(
    cam: PinholeCamera, x_cam: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame points [..., 3] -> (uv [..., 2], depth [...])."""
    z = x_cam[..., 2]
    inv_z = 1.0 / torch.where(z.abs() > 1e-9, z, 1e-9)
    u = cam.fx * x_cam[..., 0] * inv_z + cam.cx
    v = cam.fy * x_cam[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1), z


def undistort_points(
    cam: PinholeCamera, uv: torch.Tensor, num_iters: int = 5
) -> torch.Tensor:
    """Distorted (raw) pixels [..., 2] -> undistorted pixels [..., 2].

    The same fixed-point iteration as the JAX package (in spirit
    cv::undistortPoints), with a fixed iteration count.
    """
    x_dist = torch.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy],
        dim=-1,
    )
    x = x_dist
    for _ in range(num_iters):
        xx, yy = x[..., 0], x[..., 1]
        r2 = xx * xx + yy * yy
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * xx * yy + cam.p2 * (r2 + 2.0 * xx * xx)
        dy = cam.p1 * (r2 + 2.0 * yy * yy) + 2.0 * cam.p2 * xx * yy
        x = (x_dist - torch.stack([dx, dy], dim=-1)) / radial[..., None]
    return torch.stack(
        [x[..., 0] * cam.fx + cam.cx, x[..., 1] * cam.fy + cam.cy], dim=-1
    )
