"""Per-keypoint patch pipeline: the raw-patch gather kernel, then
orientation, patch-space blur and BRIEF as matrix products.

Port of orb_slam2_test_tpu/ops/patches.py (reference: GaussianBlur,
IC_Angle and computeOrbDescriptor in src/ORBextractor.cc):

1. `extract_raw_patches_levels` — a 38x38 raw window per keypoint, the
   keypoints of up to 32 images (every pyramid level of an image, or
   both sides of the stereo SAD) in one call. On CUDA tensors it makes
   one launch of the hand-written kernel csrc/patches.cu (kernel 1,
   replacing the Pallas `_patch_kernel`); on CPU tensors it runs the
   plain version, `extract_raw_patches_levels_plain`.
   `extract_raw_patches` is its one-image case.
2. `orb_from_patches` — IC_Angle moments as one [N, 1444] x [1444, 2]
   product, the 7-tap Gaussian as two banded products in patch space,
   mean-centering, and the BRIEF bits of each keypoint's own rotation
   bin as a gather of its 256 tap pairs, a - b < 0 in float32.

The JAX package reads the bits from one signed selection product
[N, 1024] x [1024, 7680] over all 30 bins, one bf16 pass on a TPU. Each
column of that matrix holds one +1 and one -1 (none where a pair's two
taps fall on one pixel), so in float32 its entries are exactly a - b:
the gather gives the JAX package's float32 bits, ties included, on
every device.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math

import numpy as np
import torch

from orb_slam2_test_tpu_torch.ops.brief import (
    N_ANGLE_BINS,
    PATCH,
    PATCH_RADIUS,
    _binned_pattern_indices,
    pack_bits,
)
from orb_slam2_test_tpu_torch.utils.cuda_build import CudaKernel, stream_ptr

PATCH_EX = 38  # 32-px descriptor core + 3-px blur margin each side
CORE_OFF = 3  # core starts at (3, 3); core center = raw center (19, 19)
BLUR_SIGMA = 2.0
BLUR_K = 7

MAX_IMAGES = 32  # images one kernel-1 launch takes (csrc/patches.cu)

_P = ctypes.c_void_p


class PatchLevels(ctypes.Structure):
    """The image table of csrc/patches.cu, passed to the kernel by value:
    per image a pointer, h and w, and the segment offsets seg[0..n_img]
    (keypoint k belongs to image i where seg[i] <= k < seg[i+1]). Slots
    past n_img are null images of size 0 whose segments end at the
    total."""

    _fields_ = [
        ("img", ctypes.c_void_p * MAX_IMAGES),
        ("h", ctypes.c_int * MAX_IMAGES),
        ("w", ctypes.c_int * MAX_IMAGES),
        ("seg", ctypes.c_int * (MAX_IMAGES + 1)),
        ("n_img", ctypes.c_int),
    ]


PATCH_GATHER = CudaKernel(
    "patch_gather_levels",
    [ctypes.POINTER(PatchLevels), _P, ctypes.c_int, _P, _P],  # levels, xy, n, out, stream
)


def _check_levels(images, xy: torch.Tensor, counts) -> None:
    """Raise ValueError unless `images` are 1..32 contiguous float32
    [H, W] tensors of at least 38x38 on xy's device, xy is a contiguous
    [N, 2] float32 tensor, and `counts` gives each image's number of
    keypoints (non-negative ints summing to N)."""
    if not 1 <= len(images) <= MAX_IMAGES:
        raise ValueError(f"need 1 to {MAX_IMAGES} images, got {len(images)}")
    if xy.dim() != 2 or xy.shape[1] != 2 or xy.dtype != torch.float32:
        raise ValueError(f"xy must be [N, 2] float32, got {xy.dtype} {tuple(xy.shape)}")
    if not xy.is_contiguous():
        raise ValueError("xy must be contiguous")
    for img in images:
        if img.dim() != 2 or img.dtype != torch.float32:
            raise ValueError(f"img must be [H, W] float32, got {img.dtype} {tuple(img.shape)}")
        if img.device != xy.device:
            raise ValueError(f"img on {img.device} but xy on {xy.device}")
        if not img.is_contiguous():
            raise ValueError("images must be contiguous")
        h, w = img.shape
        if h < PATCH_EX or w < PATCH_EX:
            raise ValueError(f"image {h}x{w} smaller than a {PATCH_EX}x{PATCH_EX} patch")
    if len(counts) != len(images) or any(int(c) != c or c < 0 for c in counts):
        raise ValueError(f"counts must be one int >= 0 per image, got {list(counts)}")
    if sum(counts) != xy.shape[0]:
        raise ValueError(f"counts sum to {sum(counts)}, xy has {xy.shape[0]} rows")


def pack_levels(images, counts) -> PatchLevels:
    """The kernel's image table for `images` and their keypoint counts."""
    seg = list(itertools.accumulate(counts, initial=0))
    seg += [seg[-1]] * (MAX_IMAGES + 1 - len(seg))
    return PatchLevels(
        (ctypes.c_void_p * MAX_IMAGES)(*[img.data_ptr() for img in images]),
        (ctypes.c_int * MAX_IMAGES)(*[img.shape[0] for img in images]),
        (ctypes.c_int * MAX_IMAGES)(*[img.shape[1] for img in images]),
        (ctypes.c_int * (MAX_IMAGES + 1))(*seg),
        len(images),
    )


def _gather_plain(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    half = PATCH_EX // 2
    x0 = (torch.round(xy[:, 0]).to(torch.int64) - half).clamp(0, w - PATCH_EX)
    y0 = (torch.round(xy[:, 1]).to(torch.int64) - half).clamp(0, h - PATCH_EX)
    r = torch.arange(PATCH_EX, device=img.device)
    rows = (y0[:, None] + r)[:, :, None]
    cols = (x0[:, None] + r)[:, None, :]
    return img[rows, cols]


def extract_raw_patches_levels_plain(images, xy: torch.Tensor, counts) -> torch.Tensor:
    """[N, 38, 38] windows at rounded keypoint coords (top-left clipped
    into bounds), the first counts[0] rows of xy on images[0], the next
    counts[1] on images[1], ...; by advanced indexing, segment by
    segment. torch.round rounds half to even, as jnp.round does."""
    _check_levels(images, xy, counts)
    out, start = [], 0
    for img, n in zip(images, counts):
        out.append(_gather_plain(img, xy[start : start + n]))
        start += n
    return torch.cat(out, dim=0)


def gather_launch_args(images, xy: torch.Tensor, counts) -> tuple[tuple, torch.Tensor]:
    """Kernel 1's checked arguments on CUDA tensors: (the C entry
    point's arguments, the output buffer [N, 38, 38] they write)."""
    _check_levels(images, xy, counts)
    if not xy.is_cuda:
        raise ValueError(f"patch_gather needs CUDA tensors, got {xy.device}")
    n = xy.shape[0]
    out = torch.empty((n, PATCH_EX, PATCH_EX), dtype=torch.float32, device=xy.device)
    args = (ctypes.byref(pack_levels(images, counts)), _P(xy.data_ptr()), n,
            _P(out.data_ptr()), stream_ptr(xy.device))
    return args, out


def extract_raw_patches_levels_cuda(images, xy: torch.Tensor, counts) -> torch.Tensor:
    """Kernel 1 (csrc/patches.cu) on CUDA tensors, one launch for all
    images; the same result as the plain version. Counts each launch in
    PATCH_GATHER.launches."""
    args, out = gather_launch_args(images, xy, counts)
    if out.shape[0] > 0:
        PATCH_GATHER.launch(xy.device, *args)
    return out


def extract_raw_patches_levels(images, xy: torch.Tensor, counts) -> torch.Tensor:
    """[N, 38, 38] raw patches of keypoints on several images (see
    `extract_raw_patches_levels_plain`): one launch of the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors; any other
    device raises."""
    if xy.is_cuda:
        return extract_raw_patches_levels_cuda(images, xy, counts)
    if xy.device.type == "cpu":
        return extract_raw_patches_levels_plain(images, xy, counts)
    raise ValueError(f"extract_raw_patches_levels: unsupported device {xy.device}")


def extract_raw_patches_plain(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """The plain gather on one image."""
    return extract_raw_patches_levels_plain([img], xy, [xy.shape[0]])


def extract_raw_patches_cuda(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Kernel 1 on one image (CUDA tensors)."""
    return extract_raw_patches_levels_cuda([img], xy, [xy.shape[0]])


def extract_raw_patches(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """[N, 38, 38] raw patches on one image: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; any other device
    raises."""
    return extract_raw_patches_levels([img], xy, [xy.shape[0]])


@functools.lru_cache()
def _moment_operator_38() -> np.ndarray:
    """[PATCH_EX*PATCH_EX, 2] (m10, m01) circular-mask coordinate
    kernels, center (19, 19), radius PATCH_RADIUS (IC_Angle support)."""
    c = PATCH_EX // 2
    ys, xs = np.mgrid[0:PATCH_EX, 0:PATCH_EX]
    dx = (xs - c).astype(np.float32)
    dy = (ys - c).astype(np.float32)
    mask = (dx ** 2 + dy ** 2) <= PATCH_RADIUS * PATCH_RADIUS
    return np.stack([(dx * mask).reshape(-1), (dy * mask).reshape(-1)], 1)


@functools.lru_cache()
def _blur_band() -> np.ndarray:
    """[PATCH, PATCH_EX] banded Gaussian: core row o = taps over raw
    rows o..o+6 (the 3-px margin supplies the context)."""
    r = BLUR_K // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / BLUR_SIGMA) ** 2)
    k = (k / k.sum()).astype(np.float32)
    A = np.zeros((PATCH, PATCH_EX), np.float32)
    for o in range(PATCH):
        A[o, o : o + BLUR_K] = k
    return A


@functools.lru_cache(maxsize=None)
def _operators(device: torch.device):
    """The constant operators on `device`, uploaded once: the moment
    kernels, the blur band and its transpose, and the BRIEF tap table
    [N_ANGLE_BINS, 256, 2] (int64 indices into a flattened 32x32
    patch)."""
    mom = torch.from_numpy(_moment_operator_38()).to(device)
    A = torch.from_numpy(_blur_band()).to(device)
    taps = torch.from_numpy(_binned_pattern_indices().astype(np.int64)).to(device)
    return mom, A, A.T.contiguous(), taps


def brief_bits(blurred: torch.Tensor, bin_id: torch.Tensor) -> torch.Tensor:
    """Blurred, mean-centered patches [N, 1024] and each one's angle bin
    [N] -> its 256 BRIEF bits [N, 256] bool: bit k is a_k - b_k < 0 over
    the bin's k-th tap pair, in float32."""
    pair = _operators(blurred.device)[3][bin_id]  # [N, 256, 2]
    return blurred.gather(1, pair[..., 0]) - blurred.gather(1, pair[..., 1]) < 0.0


def orb_from_patches(raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw patches [N, 38, 38] -> (angle [N], desc [N, 8] int32), the
    same float32 computation on every device."""
    n = raw.shape[0]
    mom_op, A, AT, _ = _operators(raw.device)

    # IC_Angle moments
    mom = raw.reshape(n, PATCH_EX * PATCH_EX) @ mom_op
    angle = torch.atan2(mom[:, 1], mom[:, 0])

    # patch-space separable blur -> [N, 32, 32]
    blurred = ((A @ raw) @ AT).reshape(n, PATCH * PATCH)
    blurred = blurred - blurred.mean(dim=1, keepdim=True)

    # the BRIEF taps of each keypoint's own rotation bin
    two_pi = 2.0 * math.pi
    bin_id = (
        torch.round(torch.remainder(angle, two_pi) * (N_ANGLE_BINS / two_pi))
        .to(torch.int64) % N_ANGLE_BINS
    )
    return angle, pack_bits(brief_bits(blurred, bin_id))
