"""Per-keypoint patch pipeline: the raw-patch gather kernel, then
orientation, patch-space blur and BRIEF as matrix products.

Port of orb_slam2_test_tpu/ops/patches.py (reference: GaussianBlur,
IC_Angle and computeOrbDescriptor in src/ORBextractor.cc):

1. `extract_raw_patches` — a 38x38 raw window per keypoint. On a CUDA
   tensor it launches the hand-written kernel csrc/patches.cu (kernel 1,
   replacing the Pallas `_patch_kernel`); on a CPU tensor it runs the
   plain version, `extract_raw_patches_plain`.
2. `orb_from_patches` — IC_Angle moments as one [N, 1444] x [1444, 2]
   product, the 7-tap Gaussian as two banded products in patch space,
   mean-centering, and all 30 rotation bins' BRIEF taps as one signed
   selection product [N, 1024] x [1024, 7680]; each keypoint keeps its
   own bin's 256 columns.
"""

from __future__ import annotations

import ctypes
import functools
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
BLUR_SIGMA = 2.0
BLUR_K = 7

_P = ctypes.c_void_p
PATCH_GATHER = CudaKernel(
    "patch_gather", [_P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P, _P]
)


def _check_patch_inputs(img: torch.Tensor, xy: torch.Tensor) -> None:
    if img.dim() != 2 or img.dtype != torch.float32:
        raise ValueError(f"img must be [H, W] float32, got {img.dtype} {tuple(img.shape)}")
    if xy.dim() != 2 or xy.shape[1] != 2 or xy.dtype != torch.float32:
        raise ValueError(f"xy must be [N, 2] float32, got {xy.dtype} {tuple(xy.shape)}")
    if xy.device != img.device:
        raise ValueError(f"img on {img.device} but xy on {xy.device}")
    if not (img.is_contiguous() and xy.is_contiguous()):
        raise ValueError("img and xy must be contiguous")
    h, w = img.shape
    if h < PATCH_EX or w < PATCH_EX:
        raise ValueError(f"image {h}x{w} smaller than a {PATCH_EX}x{PATCH_EX} patch")


def extract_raw_patches_plain(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """[N, 38, 38] windows at rounded keypoint coords (top-left clipped
    into bounds), by advanced indexing. torch.round rounds half to
    even, as jnp.round does."""
    _check_patch_inputs(img, xy)
    h, w = img.shape
    half = PATCH_EX // 2
    x0 = (torch.round(xy[:, 0]).to(torch.int64) - half).clamp(0, w - PATCH_EX)
    y0 = (torch.round(xy[:, 1]).to(torch.int64) - half).clamp(0, h - PATCH_EX)
    r = torch.arange(PATCH_EX, device=img.device)
    rows = (y0[:, None] + r)[:, :, None]
    cols = (x0[:, None] + r)[:, None, :]
    return img[rows, cols]


def extract_raw_patches_cuda(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Kernel 1 (csrc/patches.cu) on CUDA tensors; same result as the
    plain version. Counts each launch in PATCH_GATHER.launches."""
    _check_patch_inputs(img, xy)
    if not img.is_cuda:
        raise ValueError(f"patch_gather needs CUDA tensors, got {img.device}")
    h, w = img.shape
    n = xy.shape[0]
    out = torch.empty((n, PATCH_EX, PATCH_EX), dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        PATCH_GATHER(
            _P(img.data_ptr()), h, w, _P(xy.data_ptr()), n,
            _P(out.data_ptr()), stream_ptr(img.device),
        )
    return out


def extract_raw_patches(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """[N, 38, 38] raw patches: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; any other device raises."""
    if img.is_cuda:
        return extract_raw_patches_cuda(img, xy)
    if img.device.type == "cpu":
        return extract_raw_patches_plain(img, xy)
    raise ValueError(f"extract_raw_patches: unsupported device {img.device}")


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
