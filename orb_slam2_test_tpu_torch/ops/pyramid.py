"""Image pyramid as static matrix products.

Port of orb_slam2_test_tpu/ops/pyramid.py (reference:
ORBextractor::ComputePyramid). A bilinear resize is out = Rh @ img @
Rw^T with operators built in NumPy. The builders are copied here, not
imported, because the JAX module imports jax at its top;
tests/test_torch_frontend.py holds the copies equal to the originals.
The products keep the JAX package's association order, (Rh @ img) @
Rw^T, so the two differ only by float rounding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def level_shape(h: int, w: int, level: int, scale_factor: float) -> tuple[int, int]:
    """Rounded level size, matching cv::resize (round, not floor)."""
    inv = 1.0 / (scale_factor**level)
    return (int(round(h * inv)), int(round(w * inv)))


@functools.lru_cache(maxsize=None)
def _resize_operator(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] bilinear interpolation matrix (align_corners=False,
    cv::INTER_LINEAR convention)."""
    op = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        i0 = int(np.floor(src))
        f = src - i0
        i0c = min(max(i0, 0), n_in - 1)
        i1c = min(max(i0 + 1, 0), n_in - 1)
        op[i, i0c] += 1.0 - f
        op[i, i1c] += f
    return op


@functools.lru_cache(maxsize=None)
def _blur_operator(n: int, sigma: float, ksize: int) -> np.ndarray:
    """[n, n] banded Gaussian operator with edge-replicated taps."""
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    op = np.zeros((n, n), np.float32)
    for i in range(n):
        for dj, kv in zip(range(-r, r + 1), k):
            j = min(max(i + dj, 0), n - 1)
            op[i, j] += kv
    return op


@functools.lru_cache(maxsize=None)
def _resize_operators(
    h1: int, w1: int, h2: int, w2: int, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Rh [h2, h1], Rw^T [w1, w2]) on `device`, uploaded once."""
    Rh = torch.from_numpy(_resize_operator(h1, h2)).to(device)
    RwT = torch.from_numpy(_resize_operator(w1, w2).T.copy()).to(device)
    return Rh, RwT


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [H, W] float32 via two matrix products."""
    h1, w1 = img.shape
    Rh, RwT = _resize_operators(h1, w1, *out_hw, img.device)
    return torch.matmul(torch.matmul(Rh, img), RwT)


def build_pyramid(
    img: torch.Tensor, n_levels: int, scale_factor: float
) -> list[torch.Tensor]:
    """Per-level images, level 0 = input, each resized from the previous
    one as ORBextractor::ComputePyramid does."""
    h, w = img.shape
    levels = [img]
    for l in range(1, n_levels):
        levels.append(
            resize_bilinear(levels[-1], level_shape(h, w, l, scale_factor))
        )
    return levels
