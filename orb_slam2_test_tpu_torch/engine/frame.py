"""Frame construction: ORB extraction + undistortion.

Port of the monocular part of orb_slam2_test_tpu/engine/frame.py
(reference: src/Frame.cc mono ctor, ExtractORB + UndistortKeyPoints).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera, undistort_points
from orb_slam2_test_tpu_torch.ops.extractor import extract_orb
from orb_slam2_test_tpu_torch.utils.precision import f32_matmuls


class FrameData(NamedTuple):
    """Per-frame data bundle (reference Frame members, arrays only).

    uv       [N, 2]  undistorted keypoint coords (mvKeysUn)
    uv_raw   [N, 2]  raw (distorted) coords (mvKeys)
    level    [N]     pyramid level
    angle    [N]     orientation (radians)
    desc     [N, 8]  packed descriptors, int32 bit patterns
    valid    [N]
    ur       [N]     right-image u (stereo/RGB-D), -1 if unavailable
    depth    [N]     keypoint depth, -1 if unavailable
    timestamp []
    """

    uv: torch.Tensor
    uv_raw: torch.Tensor
    level: torch.Tensor
    angle: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor
    ur: torch.Tensor
    depth: torch.Tensor
    timestamp: torch.Tensor


def build_frame_mono(
    img: torch.Tensor,
    timestamp: float,
    cam: PinholeCamera,
    n_features: int = 1000,
    n_levels: int = 8,
    scale_factor: float = 1.2,
) -> FrameData:
    """Monocular frame: extract ORB + undistort keypoints.

    `img` [H, W] may be uint8 or float; the float32 cast happens on the
    image's device, so a caller moves 1 byte per pixel to the card."""
    f32_matmuls()
    img = img.to(torch.float32)
    f = extract_orb(
        img, n_features=n_features, n_levels=n_levels, scale_factor=scale_factor
    )
    uv_un = undistort_points(cam, f.uv) if cam.has_distortion else f.uv
    n = f.uv.shape[0]
    minus_one = torch.full((n,), -1.0, device=img.device)
    return FrameData(
        uv=uv_un,
        uv_raw=f.uv,
        level=f.level,
        angle=f.angle,
        desc=f.desc,
        valid=f.valid,
        ur=minus_one,
        depth=minus_one.clone(),
        timestamp=torch.tensor(timestamp, dtype=torch.float32, device=img.device),
    )
