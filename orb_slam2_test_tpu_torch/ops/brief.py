"""Oriented BRIEF: sampling pattern, binned taps and bit packing.

Port of the parts of orb_slam2_test_tpu/ops/brief.py that the patch
pipeline uses (reference: computeOrbDescriptor). The seeded pattern
and its per-bin indices are copied, not imported, because the JAX
module imports jax at its top; tests/test_torch_frontend.py holds the
copies equal to the originals.

Packed descriptors are int32 bit patterns [..., 8] (the JAX package
uses uint32): torch has no right shift on uint32. A test views them
as uint32 with `.view(np.uint32)`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PATCH_RADIUS = 15  # 31x31 patch, as reference HALF_PATCH_SIZE
PATTERN_RADIUS = 13  # sampling points stay in-patch under any rotation
N_BITS = 256
EDGE_MARGIN = 19  # reference EDGE_THRESHOLD
N_ANGLE_BINS = 30  # 12-degree rotation quantization (original ORB paper)
PATCH = 32  # aligned patch size for descriptor sampling


@functools.lru_cache()
def brief_pattern() -> np.ndarray:
    """[256, 2, 2] int32 — (point a, point b) as (dx, dy) offsets.

    Seeded Gaussian pairs (sigma = patch/5, BRIEF's G-II construction),
    rejection-clipped to radius PATTERN_RADIUS."""
    rng = np.random.default_rng(31)
    pts = []
    while len(pts) < N_BITS * 2:
        cand = rng.normal(0.0, 31.0 / 5.0, size=(N_BITS * 4, 2))
        cand = np.round(cand).astype(np.int32)
        r2 = (cand**2).sum(axis=1)
        cand = cand[r2 <= PATTERN_RADIUS**2]
        pts.extend(cand.tolist())
    pts = np.asarray(pts[: N_BITS * 2], dtype=np.int32)
    return pts.reshape(N_BITS, 2, 2)


@functools.lru_cache()
def _binned_pattern_indices() -> np.ndarray:
    """[N_ANGLE_BINS, 256, 2] int32 — linear indices into a flattened
    PATCH x PATCH patch (center (PATCH//2, PATCH//2)) of each bit's two
    sampling points, pre-rotated for each angle bin."""
    pat = brief_pattern().astype(np.float32)  # [256, 2, 2] (dx, dy)
    half = PATCH // 2
    out = np.zeros((N_ANGLE_BINS, N_BITS, 2), np.int32)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        rx = np.round(c * pat[..., 0] - s * pat[..., 1]).astype(np.int64)
        ry = np.round(s * pat[..., 0] + c * pat[..., 1]).astype(np.int64)
        px = np.clip(rx + half, 0, PATCH - 1)
        py = np.clip(ry + half, 0, PATCH - 1)
        out[b] = (py * PATCH + px).astype(np.int32)
    return out


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 256] bool -> [..., 8] int32 bit patterns (little-endian
    within words, the JAX package's uint32 words reinterpreted)."""
    shape = bits.shape[:-1]
    b = bits.reshape(shape + (8, 32)).to(torch.int64)
    weights = 1 << torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (b * weights).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
