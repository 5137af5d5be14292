"""Motion-only BA as one CUDA kernel (kernel 2, csrc/pose_opt.cu).

The counterpart of orb_slam2_test_tpu/solvers/pose_opt_pallas.py: the
whole rounds x iterations Gauss-Newton schedule runs in one launch, so
the 40 dependent iterations cost no host round trips. The wrapper
keeps the JAX wrapper's `se3_project` on the input and output pose;
`pose_opt.pose_optimization` ANDs the inliers with `valid`.
"""

from __future__ import annotations

import ctypes

import torch

from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.geometry.robust import (
    CHI2_MONO,
    CHI2_STEREO,
    HUBER_MONO,
    HUBER_STEREO,
)
from orb_slam2_test_tpu_torch.geometry.se3 import se3_project
from orb_slam2_test_tpu_torch.utils.cuda_build import CudaKernel, stream_ptr

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int
POSE_OPT = CudaKernel(
    "pose_opt",
    [_P, _P, _P, _P, _P, _I,  # T0, X, obs, isig, valid, n
     _F, _F, _F, _F, _F,  # fx, fy, cx, cy, bf
     _F, _F, _F, _F, _F,  # chi2 gates, huber deltas, damping
     _I, _I,  # rounds, iters_per_round
     _P, _P, _P, _P],  # T_out, inl, chi2, stream
)


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pose_optimization_cuda(
    cam: PinholeCamera,
    Tcw0: torch.Tensor,  # [4, 4] float32
    X: torch.Tensor,  # [O, 3] float32 world points
    obs: torch.Tensor,  # [O, 3] float32 (u, v, u_r); u_r < 0 = mono
    inv_sigma2: torch.Tensor,  # [O] float32
    valid: torch.Tensor,  # [O] bool
    rounds: int = 4,
    iters_per_round: int = 10,
    damping: float = 1e-3,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (Tcw [4, 4], inliers [O] bool, chi2 [O]) with the
    semantics of pose_opt_pallas.pose_optimization_tpu. Counts each
    launch in POSE_OPT.launches."""
    dev = X.device
    if not X.is_cuda:
        raise ValueError(f"pose_opt needs CUDA tensors, got {dev}")
    O = X.shape[0]
    _check("Tcw0", Tcw0, (4, 4), torch.float32, dev)
    _check("X", X, (O, 3), torch.float32, dev)
    _check("obs", obs, (O, 3), torch.float32, dev)
    _check("inv_sigma2", inv_sigma2, (O,), torch.float32, dev)
    _check("valid", valid, (O,), torch.bool, dev)
    if rounds < 0 or iters_per_round < 1:
        raise ValueError(f"bad schedule: rounds={rounds}, iters={iters_per_round}")

    T0 = se3_project(Tcw0).reshape(16).contiguous()
    valid_f = valid.to(torch.float32)
    T_out = torch.empty(16, dtype=torch.float32, device=dev)
    inl = torch.empty(O, dtype=torch.float32, device=dev)
    chi2 = torch.empty(O, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        POSE_OPT(
            _P(T0.data_ptr()), _P(X.data_ptr()), _P(obs.data_ptr()),
            _P(inv_sigma2.data_ptr()), _P(valid_f.data_ptr()), O,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
            CHI2_MONO, CHI2_STEREO, HUBER_MONO, HUBER_STEREO, damping,
            rounds, iters_per_round,
            _P(T_out.data_ptr()), _P(inl.data_ptr()), _P(chi2.data_ptr()),
            stream_ptr(dev),
        )
    return se3_project(T_out.reshape(4, 4)), inl > 0.5, chi2
