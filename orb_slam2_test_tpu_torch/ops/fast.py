"""FAST-9/16 corner detection, vectorized over the image.

Port of orb_slam2_test_tpu/ops/fast.py (reference: the per-cell
cv::FAST calls in ORBextractor::ComputeKeyPointsOctTree). One dense
pass at a threshold gives the corner mask and score; contiguity of the
9-pixel arc is tested with shifts of a packed 16-bit int32 mask.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 as (dy, dx), clockwise from 12 o'clock.
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LENGTH = 9  # FAST-9: minimum contiguous run


def _ring_diffs(img: torch.Tensor) -> torch.Tensor:
    """[16, H, W] neighbor minus center for each ring position. The
    roll wraps at the border; callers mask the border out."""
    return torch.stack(
        [torch.roll(img, (-dy, -dx), dims=(0, 1)) - img
         for dy, dx in CIRCLE_OFFSETS]
    )


def _contiguous_mask(bits: torch.Tensor) -> torch.Tensor:
    """bits [H, W] int32 with 16 flag bits -> bool: any circular run of
    at least ARC_LENGTH set bits. The int32 wrap of `bits << 16` and the
    arithmetic right shifts are the same in JAX and torch."""
    doubled = bits | (bits << 16)
    m = doubled
    for k in range(1, ARC_LENGTH):
        m = m & (doubled >> k)
    return (m & 0xFFFF) != 0


def _pack_ring(flags: torch.Tensor) -> torch.Tensor:
    weight = 1 << torch.arange(16, dtype=torch.int32, device=flags.device)
    return (flags.to(torch.int32) * weight[:, None, None]).sum(0, dtype=torch.int32)


def fast_response(
    img: torch.Tensor, threshold: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense FAST-9/16 pass: (is_corner [H, W] bool, score [H, W] f32).

    The score is the sum of |diff| - t over ring pixels past the
    threshold on the dominant side, as in the JAX package."""
    d = _ring_diffs(img)
    bright = d > threshold
    dark = d < -threshold
    is_corner = _contiguous_mask(_pack_ring(bright)) | _contiguous_mask(
        _pack_ring(dark)
    )
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    bright_score = torch.where(bright, d - threshold, zero).sum(0)
    dark_score = torch.where(dark, -d - threshold, zero).sum(0)
    score = torch.maximum(bright_score, dark_score)
    return is_corner, torch.where(is_corner, score, zero)


def nms_3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression: keep a score iff it is >= every
    neighbor. max_pool2d pads with -inf, as reduce_window does."""
    neigh_max = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= neigh_max, score, torch.zeros_like(score))


def border_mask(h: int, w: int, margin: int, device=None) -> torch.Tensor:
    """[H, W] bool, True at least `margin` pixels from every edge."""
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)
