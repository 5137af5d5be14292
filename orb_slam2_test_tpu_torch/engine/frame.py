"""Frame construction: ORB extraction + undistortion (+ stereo depth).

Port of orb_slam2_test_tpu/engine/frame.py (reference: src/Frame.cc, the
mono, stereo and RGB-D constructors). The three `build_frame_*`
functions accept a uint8 image and cast it on the image's device, so a
caller moves 1 byte per pixel to the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera, undistort_points
from orb_slam2_test_tpu_torch.ops.extractor import Features, extract_orb
from orb_slam2_test_tpu_torch.ops.pyramid import build_pyramid
from orb_slam2_test_tpu_torch.ops.stereo import stereo_match
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


def _frame(
    cam: PinholeCamera, f: Features, ur: torch.Tensor, depth: torch.Tensor,
    timestamp: float,
) -> FrameData:
    uv_un = undistort_points(cam, f.uv) if cam.has_distortion else f.uv
    return FrameData(
        uv=uv_un,
        uv_raw=f.uv,
        level=f.level,
        angle=f.angle,
        desc=f.desc,
        valid=f.valid,
        ur=ur,
        depth=depth,
        timestamp=torch.tensor(timestamp, dtype=torch.float32, device=f.uv.device),
    )


def build_frame_mono(
    img: torch.Tensor,
    timestamp: float,
    cam: PinholeCamera,
    n_features: int = 1000,
    n_levels: int = 8,
    scale_factor: float = 1.2,
) -> FrameData:
    """Monocular frame: extract ORB + undistort keypoints."""
    f32_matmuls()
    f = extract_orb(
        img.to(torch.float32).contiguous(), n_features=n_features, n_levels=n_levels,
        scale_factor=scale_factor,
    )
    minus_one = torch.full((f.uv.shape[0],), -1.0, device=img.device)
    return _frame(cam, f, minus_one, minus_one.clone(), timestamp)


def build_frame_stereo(
    img_left: torch.Tensor,
    img_right: torch.Tensor,
    timestamp: float,
    cam: PinholeCamera,
    n_features: int = 1000,
    n_levels: int = 8,
    scale_factor: float = 1.2,
) -> FrameData:
    """Stereo frame: ORB on both images, scanline association and SAD
    subpixel disparity (reference Frame stereo ctor +
    ComputeStereoMatches). Each pyramid is built once and serves both
    the extractor and the SAD refinement."""
    f32_matmuls()
    kw = dict(n_features=n_features, n_levels=n_levels, scale_factor=scale_factor)
    img_left = img_left.to(torch.float32).contiguous()
    img_right = img_right.to(torch.float32).contiguous()
    lp = build_pyramid(img_left, n_levels, scale_factor)
    rp = build_pyramid(img_right, n_levels, scale_factor)
    fl = extract_orb(img_left, pyramid=lp, **kw)
    fr = extract_orb(img_right, pyramid=rp, **kw)
    ur, depth = stereo_match(fl, fr, lp, rp, float(cam.bf), **kw)
    return _frame(cam, fl, ur, depth, timestamp)


def build_frame_rgbd(
    img: torch.Tensor,
    depth_map: torch.Tensor,  # [H, W] metric depth (0 / negative = invalid)
    timestamp: float,
    cam: PinholeCamera,
    n_features: int = 1000,
    n_levels: int = 8,
    scale_factor: float = 1.2,
) -> FrameData:
    """RGB-D frame: depth lookup at the keypoints and the virtual right
    coordinate ur = u - bf / d (reference Frame::ComputeStereoFromRGBD).

    A keypoint on a depth edge is dropped: its 3x3 neighbourhood's depth
    spread must stay below 5% of its depth. The neighbourhood min/max
    are 3x3 max-pools, which pad with -inf as reduce_window "SAME" does
    in the JAX package."""
    frame = build_frame_mono(img, timestamp, cam, n_features, n_levels, scale_factor)
    depth_map = depth_map.to(torch.float32)
    h, w = depth_map.shape
    xi = torch.round(frame.uv_raw[:, 0]).to(torch.int64).clamp(0, w - 1)
    yi = torch.round(frame.uv_raw[:, 1]).to(torch.int64).clamp(0, h - 1)
    d = depth_map[yi, xi]
    pos = depth_map > 0.0

    def pool_max(x):
        return F.max_pool2d(x[None, None], 3, stride=1, padding=1)[0, 0]

    dmin = -pool_max(-torch.where(pos, depth_map, torch.inf))
    dmax = pool_max(torch.where(pos, depth_map, -torch.inf))
    d_safe = torch.clamp(d, min=1e-6)
    has_d = (d > 0.0) & ((dmax[yi, xi] - dmin[yi, xi]) < 0.05 * d_safe)
    return frame._replace(
        ur=torch.where(has_d, frame.uv[:, 0] - cam.bf / d_safe, -1.0),
        depth=torch.where(has_d, d, -1.0),
    )
