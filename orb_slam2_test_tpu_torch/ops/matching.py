"""Binary descriptor matching — Hamming distance as a matrix product.

Port of orb_slam2_test_tpu/ops/matching.py (reference: ORBmatcher
DescriptorDistance, the brute-force loops of SearchByProjection and
SearchForInitialization, the ratio and cross checks, and the rotation
histogram of ComputeThreeMaxima). Descriptors unpack to
bipolar {-1, +1} vectors, so dot(a, b) = 256 - 2 hamming(a, b) and an
[N, M] distance matrix is one 256-deep product. The inputs are +-1 and
every sum is an integer of at most 256, so the float32 product is
exact in any summation order. The popcount form of the JAX module is a
cross-check there and is not ported.
"""

from __future__ import annotations

import math

import torch

from orb_slam2_test_tpu_torch.ops.extractor import top_k_stable

TH_HIGH = 100  # ORBmatcher.h
TH_LOW = 50
HISTO_LENGTH = 30


def unpack_bipolar(desc: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[..., 8] int32 bit patterns -> [..., 256] bipolar (-1/+1) vectors.
    The arithmetic shift of a negative word still leaves bit k in bit 0."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = ((desc[..., :, None] >> shifts) & 1).to(dtype)
    bits = bits.reshape(desc.shape[:-1] + (256,))
    return bits * 2.0 - 1.0


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """[N, 8] x [M, 8] int32 -> [N, M] int32 Hamming distances."""
    a = unpack_bipolar(desc_a)
    b = unpack_bipolar(desc_b)
    dot = a @ b.transpose(-1, -2)
    return ((256.0 - dot) * 0.5).to(torch.int32)


def masked_hamming_matrix(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
    fill: int = 512,
) -> torch.Tensor:
    """[N, M] Hamming with invalid rows/cols set to `fill` (> max 256)."""
    d = hamming_matrix(desc_a, desc_b)
    mask = valid_a[:, None] & valid_b[None, :]
    return torch.where(mask, d, torch.full_like(d, fill))


def best_two(
    dist: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-wise best + second best over the last axis.

    Returns (best_idx [N], best [N], second [N]). torch.argmin returns
    the first minimum, as jnp.argmin does."""
    if dist.dtype.is_floating_point:
        fill = torch.inf
    else:
        fill = torch.iinfo(dist.dtype).max
    best_idx = dist.argmin(dim=-1).to(torch.int32)
    best = dist.min(dim=-1).values
    cols = torch.arange(dist.shape[-1], device=dist.device)
    d2 = torch.where(cols == best_idx[..., None], torch.full_like(dist, fill), dist)
    second = d2.min(dim=-1).values
    return best_idx, best, second


def match_nn_ratio(
    dist: torch.Tensor,
    max_dist: int = TH_LOW,
    ratio: float = 0.9,
    check_ratio: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise nearest neighbour with a distance gate and Lowe's ratio
    test (the accept rule of SearchForInitialization / SearchByBoW:
    best < max_dist and best < ratio * second). Returns (match_idx [N]
    int32, -1 for no match, best_dist [N])."""
    best_idx, best, second = best_two(dist)
    ok = best < max_dist
    if check_ratio:
        ok = ok & (best.to(torch.float32) < ratio * second.to(torch.float32))
    return torch.where(ok, best_idx, -1), best


def mutual_filter(match_ab: torch.Tensor, match_ba: torch.Tensor) -> torch.Tensor:
    """Keep a -> b matches whose b -> a match agrees (cross check).
    match_ab [N] int32 (index into B or -1), match_ba [M] int32."""
    back = match_ba[match_ab.clamp(min=0).to(torch.int64)]
    rows = torch.arange(match_ab.shape[0], dtype=match_ab.dtype, device=match_ab.device)
    return torch.where((match_ab >= 0) & (back == rows), match_ab, -1)


def rotation_consistency(
    match_idx: torch.Tensor,  # [N] int32, -1 = no match
    angle_a: torch.Tensor,  # [N] radians
    angle_b: torch.Tensor,  # [M] radians
) -> torch.Tensor:
    """Rotation-histogram filter (HISTO_LENGTH = 30 bins and
    ComputeThreeMaxima): keep the matches whose angle difference falls in
    one of the three fullest bins; the second and third count only with
    at least a tenth of the first's votes. Tied bins are taken lowest
    first, as jax.lax.top_k takes them."""
    matched = match_idx >= 0
    rot = angle_a - angle_b[match_idx.clamp(min=0).to(torch.int64)]
    two_pi = 2.0 * math.pi
    rot = torch.remainder(rot, two_pi)  # floor modulo, as jnp.mod
    bins = torch.clamp((rot * (HISTO_LENGTH / two_pi)).to(torch.int32), 0, HISTO_LENGTH - 1)
    tgt = torch.where(matched, bins, HISTO_LENGTH).to(torch.int64)
    hist = torch.zeros(HISTO_LENGTH + 1, dtype=torch.int32, device=bins.device)
    hist.index_add_(0, tgt, torch.ones_like(bins))
    top_vals, top_bins = top_k_stable(hist[:HISTO_LENGTH], 3)
    keep_bin = top_vals.to(torch.float32) >= 0.1 * top_vals[0].to(torch.float32)
    in_top = ((bins[:, None] == top_bins[None, :]) & keep_bin[None, :]).any(-1)
    return torch.where(matched & in_top, match_idx, -1)


def match_descriptors(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
    max_dist: int = TH_LOW,
    ratio: float = 0.9,
    mutual: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Brute-force matcher A -> B: nearest neighbour, the gates and an
    optional cross check. Returns (match_idx [N] into B or -1, dist [N])."""
    d = masked_hamming_matrix(desc_a, desc_b, valid_a, valid_b)
    idx_ab, dist_ab = match_nn_ratio(d, max_dist, ratio)
    if mutual:
        idx_ba, _ = match_nn_ratio(d.transpose(0, 1), max_dist, ratio, check_ratio=False)
        idx_ab = mutual_filter(idx_ab, idx_ba)
    return idx_ab, dist_ab
