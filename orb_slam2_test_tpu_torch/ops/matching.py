"""Binary descriptor matching — Hamming distance as a matrix product.

Port of the parts of orb_slam2_test_tpu/ops/matching.py on the
tracking path (reference: ORBmatcher DescriptorDistance and the
brute-force loops of SearchByProjection). Descriptors unpack to
bipolar {-1, +1} vectors, so dot(a, b) = 256 - 2 hamming(a, b) and an
[N, M] distance matrix is one 256-deep product. The inputs are +-1 and
every sum is an integer of at most 256, so the float32 product is
exact in any summation order.
"""

from __future__ import annotations

import torch

TH_HIGH = 100  # ORBmatcher.h
TH_LOW = 50


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
