"""MapState: the SLAM map as a struct of tensors.

Port of the container part of orb_slam2_test_tpu/slam_map/mapstate.py
(reference: the registries of src/Map.cc and the KeyFrame / MapPoint
objects). Capacities are fixed (keyframes K, features per keyframe N,
points P) and slots carry validity masks, so the port's state can be
compared with the JAX package's slot by slot. Descriptors are int32
bit patterns (the JAX package stores uint32).

The mutating operations (`add_keyframe`, `add_points`, erase, grow)
belong to keyframe insertion and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MapCapacity:
    """Static capacities. Hashable."""

    max_keyframes: int = 512
    max_features: int = 1000  # per keyframe (YAML ORBextractor.nFeatures)
    max_points: int = 65536
    n_levels: int = 8  # pyramid levels (YAML ORBextractor.nLevels)
    scale_factor: float = 1.2  # YAML ORBextractor.scaleFactor

    @property
    def level_scales(self) -> np.ndarray:
        """scale_factor**level, float32 (ORBextractor::mvScaleFactor)."""
        return np.power(self.scale_factor, np.arange(self.n_levels)).astype(
            "float32"
        )

    @property
    def level_sigma2(self) -> np.ndarray:
        return self.level_scales**2


class MapState(NamedTuple):
    """All tensors, on one device; leading dims are the capacities.
    Field meanings are those of the JAX package's MapState.

    Keyframes: kf_Tcw [K, 4, 4], kf_valid [K], kf_timestamp [K],
    kf_frame_id [K], kf_uv [K, N, 2], kf_level [K, N], kf_angle [K, N],
    kf_ur [K, N], kf_depth [K, N], kf_desc [K, N, 8] int32,
    kf_kp_valid [K, N], kf_pt_idx [K, N] (-1 none), kf_parent [K],
    kf_loop_edge [K], kf_Tcp [K, 4, 4].
    Points: pt_xyz [P, 3], pt_valid [P], pt_desc [P, 8] int32,
    pt_normal [P, 3], pt_min_dist [P], pt_max_dist [P], pt_ref_kf [P],
    pt_first_kf [P], pt_visible [P], pt_found [P].
    Scalars: n_kf, n_pt (int32).
    """

    kf_Tcw: torch.Tensor
    kf_valid: torch.Tensor
    kf_timestamp: torch.Tensor
    kf_frame_id: torch.Tensor
    kf_uv: torch.Tensor
    kf_level: torch.Tensor
    kf_angle: torch.Tensor
    kf_ur: torch.Tensor
    kf_depth: torch.Tensor
    kf_desc: torch.Tensor
    kf_kp_valid: torch.Tensor
    kf_pt_idx: torch.Tensor
    kf_parent: torch.Tensor
    kf_loop_edge: torch.Tensor
    kf_Tcp: torch.Tensor
    pt_xyz: torch.Tensor
    pt_valid: torch.Tensor
    pt_desc: torch.Tensor
    pt_normal: torch.Tensor
    pt_min_dist: torch.Tensor
    pt_max_dist: torch.Tensor
    pt_ref_kf: torch.Tensor
    pt_first_kf: torch.Tensor
    pt_visible: torch.Tensor
    pt_found: torch.Tensor
    n_kf: torch.Tensor
    n_pt: torch.Tensor


def make_empty_map(
    cap: MapCapacity, device: torch.device | str = "cpu"
) -> MapState:
    K, N, P = cap.max_keyframes, cap.max_features, cap.max_points
    f32, i32 = torch.float32, torch.int32

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    def eyes():
        return torch.eye(4, dtype=f32, device=device).repeat(K, 1, 1)

    return MapState(
        kf_Tcw=eyes(),
        kf_valid=full((K,), False, torch.bool),
        kf_timestamp=full((K,), 0.0, f32),
        kf_frame_id=full((K,), -1, i32),
        kf_uv=full((K, N, 2), 0.0, f32),
        kf_level=full((K, N), 0, i32),
        kf_angle=full((K, N), 0.0, f32),
        kf_ur=full((K, N), -1.0, f32),
        kf_depth=full((K, N), -1.0, f32),
        kf_desc=full((K, N, 8), 0, i32),
        kf_kp_valid=full((K, N), False, torch.bool),
        kf_pt_idx=full((K, N), -1, i32),
        kf_parent=full((K,), -1, i32),
        kf_loop_edge=full((K,), -1, i32),
        kf_Tcp=eyes(),
        pt_xyz=full((P, 3), 0.0, f32),
        pt_valid=full((P,), False, torch.bool),
        pt_desc=full((P, 8), 0, i32),
        pt_normal=full((P, 3), 0.0, f32),
        pt_min_dist=full((P,), 0.0, f32),
        pt_max_dist=full((P,), 0.0, f32),
        pt_ref_kf=full((P,), -1, i32),
        pt_first_kf=full((P,), -1, i32),
        pt_visible=full((P,), 0.0, f32),
        pt_found=full((P,), 0.0, f32),
        n_kf=full((), 0, i32),
        n_pt=full((), 0, i32),
    )
