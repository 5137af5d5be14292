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
   mean-centering, and all 30 rotation bins' BRIEF taps as one signed
   selection product [N, 1024] x [1024, 7680]; each keypoint keeps its
   own bin's 256 columns.
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
    N_BITS,
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


@functools.lru_cache()
def _selection_matrix() -> np.ndarray:
    """[PATCH*PATCH, N_ANGLE_BINS*N_BITS] float32 in {-1, 0, +1}: column
    (b*256+k) has +1 at bin-b tap a_k and -1 at tap b_k."""
    idx = _binned_pattern_indices()  # [B, 256, 2]
    D = np.zeros((N_ANGLE_BINS * N_BITS, PATCH * PATCH), np.float32)
    rows = np.arange(N_ANGLE_BINS * N_BITS)
    np.add.at(D, (rows, idx[..., 0].reshape(-1)), 1.0)
    np.add.at(D, (rows, idx[..., 1].reshape(-1)), -1.0)
    return D.T  # [1024, 7680]


@functools.lru_cache(maxsize=None)
def _operators(device: torch.device, select_dtype: torch.dtype):
    """The constant operators on `device`, uploaded once."""
    mom = torch.from_numpy(_moment_operator_38()).to(device)
    A = torch.from_numpy(_blur_band()).to(device)
    D = torch.from_numpy(_selection_matrix()).to(device=device, dtype=select_dtype)
    return mom, A, A.T.contiguous(), D


def orb_from_patches(raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw patches [N, 38, 38] -> (angle [N], desc [N, 8] int32).

    The selection product mirrors the JAX package's Precision.DEFAULT:
    on CUDA one bf16 pass with float32 accumulation, as the TPU runs
    it; on the CPU float32, as JAX on the CPU runs it. Mean-centered
    patches keep bf16 rounding below sign-decision noise."""
    n = raw.shape[0]
    select_dtype = torch.bfloat16 if raw.is_cuda else torch.float32
    mom_op, A, AT, D = _operators(raw.device, select_dtype)

    # IC_Angle moments
    mom = raw.reshape(n, PATCH_EX * PATCH_EX) @ mom_op
    angle = torch.atan2(mom[:, 1], mom[:, 0])

    # patch-space separable blur -> [N, 32, 32]
    blurred = ((A @ raw) @ AT).reshape(n, PATCH * PATCH)
    blurred = blurred - blurred.mean(dim=1, keepdim=True)

    # all-bin signed taps in one product, then each keypoint's own bin;
    # only the sign is read, so a bf16-rounded output is exact enough
    vals = (blurred.to(select_dtype) @ D).reshape(n, N_ANGLE_BINS, N_BITS)
    two_pi = 2.0 * math.pi
    bin_id = (
        torch.round(torch.remainder(angle, two_pi) * (N_ANGLE_BINS / two_pi))
        .to(torch.int64) % N_ANGLE_BINS
    )
    sel = vals[torch.arange(n, device=raw.device), bin_id]
    return angle, pack_bits(sel < 0.0)
