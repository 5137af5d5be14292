"""MapState: the SLAM map as a struct of tensors.

Port of the container part of orb_slam2_test_tpu/slam_map/mapstate.py
(reference: the registries of src/Map.cc and the KeyFrame / MapPoint
objects). Capacities are fixed (keyframes K, features per keyframe N,
points P) and slots carry validity masks, so the port's state can be
compared with the JAX package's slot by slot. Descriptors are int32
bit patterns (the JAX package stores uint32).

The mutating operations are functional, as in the JAX package: each
returns a new MapState and leaves its argument as it was; fields it
does not change are shared. `grow_map` re-buckets a map into larger
capacities for the host tracker.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_test_tpu_torch.geometry.se3 import se3_inverse
from orb_slam2_test_tpu_torch.ops.extractor import top_k_stable
from orb_slam2_test_tpu_torch.utils.scatter import put, take


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
    cap: MapCapacity, device: torch.device | str = "cuda"
) -> MapState:
    """An empty map of capacity `cap` on `device` (the card unless the
    caller asks for another, such as "cpu")."""
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


def grow_map(m: MapState, old_cap: MapCapacity, new_cap: MapCapacity) -> MapState:
    """Re-bucket a map into larger keyframe and point capacities, on the
    map's device. The reference's map is unbounded (heap-allocated
    keyframes and points, Map.cc); here capacities are fixed shapes, so
    growth pads every field into an empty map of the new capacity.
    Slots keep their positions, so every index stays valid."""
    if (
        new_cap.max_features != old_cap.max_features
        or new_cap.n_levels != old_cap.n_levels
        or new_cap.scale_factor != old_cap.scale_factor
    ):
        raise ValueError("grow_map can only grow keyframe/point capacity")
    if (
        new_cap.max_keyframes < old_cap.max_keyframes
        or new_cap.max_points < old_cap.max_points
    ):
        raise ValueError("grow_map cannot shrink capacities")
    K0, P0 = old_cap.max_keyframes, old_cap.max_points
    empty = make_empty_map(new_cap, m.kf_Tcw.device)
    out = {}
    for f in MapState._fields:
        v = getattr(m, f)
        if f.startswith(("kf_", "pt_")):
            out[f] = getattr(empty, f)
            out[f][: K0 if f.startswith("kf_") else P0] = v
        else:  # the scalars n_kf, n_pt
            out[f] = v
    return MapState(**out)


@functools.lru_cache(maxsize=None)
def level_tables(
    cap: MapCapacity, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """(level_scales [L], level_sigma2 [L]) on `device`, uploaded once."""
    return (torch.from_numpy(cap.level_scales).to(device),
            torch.from_numpy(cap.level_sigma2).to(device))


# ---------------------------------------------------------------------------
# Slot allocation and mutation (functional `new KeyFrame` / `new MapPoint`)
# ---------------------------------------------------------------------------


def alloc_keyframe_slot(m: MapState) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot, ok): the first free keyframe slot and whether one exists.
    When every slot is live the slot is 0, the gauge anchor; callers
    gate on `ok`."""
    k = torch.argmin(m.kf_valid.to(torch.int32))
    return k, ~take(m.kf_valid, k)


def alloc_point_slots(m: MapState, count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(slots [count] int64, ok [count]): the lowest `count` free point
    slots in ascending order (a stable sort of the free flags, the order
    of jax.lax.top_k). Past the free slots the indices point at used
    slots with ok = False."""
    free = ~m.pt_valid
    k = min(count, free.shape[0])
    vals, slots = top_k_stable(free.to(torch.int32), k)
    if k < count:  # request larger than capacity: overflow rows fail
        slots = torch.cat([slots, slots.new_zeros(count - k)])
        vals = torch.cat([vals, vals.new_zeros(count - k)])
    return slots, vals > 0


def add_keyframe(
    m: MapState,
    Tcw: torch.Tensor,
    timestamp,
    frame_id,
    uv: torch.Tensor,
    level: torch.Tensor,
    angle: torch.Tensor,
    ur: torch.Tensor,
    depth: torch.Tensor,
    desc: torch.Tensor,
    kp_valid: torch.Tensor,
    pt_idx: torch.Tensor,
) -> tuple[MapState, torch.Tensor]:
    """Insert a keyframe into the first free slot (Tracking::
    CreateNewKeyFrame + Map::AddKeyFrame); returns (map, kf_id int32).
    With every slot live the insert writes nothing and kf_id = -1: the
    device-side backstop that protects keyframe 0."""
    k, ok = alloc_keyframe_slot(m)
    K = m.kf_valid.shape[0]
    t = torch.where(ok, k, K).reshape(1)  # K drops every write when full

    def w(x, v):
        if torch.is_tensor(v):
            v = v.to(x.dtype).expand(x.shape[1:]).unsqueeze(0)
        return put(x, t, v)

    m = m._replace(
        kf_Tcw=w(m.kf_Tcw, Tcw),
        kf_valid=w(m.kf_valid, True),
        kf_timestamp=w(m.kf_timestamp, timestamp),
        kf_frame_id=w(m.kf_frame_id, frame_id),
        kf_uv=w(m.kf_uv, uv),
        kf_level=w(m.kf_level, level),
        kf_angle=w(m.kf_angle, angle),
        kf_ur=w(m.kf_ur, ur),
        kf_depth=w(m.kf_depth, depth),
        kf_desc=w(m.kf_desc, desc),
        kf_kp_valid=w(m.kf_kp_valid, kp_valid),
        kf_pt_idx=w(m.kf_pt_idx, pt_idx),
        # a fresh slot has no tree or loop links yet (slots are recycled)
        kf_parent=w(m.kf_parent, -1),
        kf_loop_edge=w(m.kf_loop_edge, -1),
        kf_Tcp=w(m.kf_Tcp, torch.eye(4, device=m.kf_Tcp.device)),
        n_kf=m.n_kf + ok.to(torch.int32),
    )
    return m, torch.where(ok, k, -1).to(torch.int32)


def add_points(
    m: MapState,
    xyz: torch.Tensor,  # [B, 3]
    desc: torch.Tensor,  # [B, 8] int32
    normal: torch.Tensor,  # [B, 3]
    min_dist: torch.Tensor,  # [B]
    max_dist: torch.Tensor,  # [B]
    ref_kf: torch.Tensor,  # [] or [B]
    ok: torch.Tensor,  # [B] rows to insert
) -> tuple[MapState, torch.Tensor]:
    """Batch-insert points into free slots; returns (map, slots [B]
    int32), -1 where a row was not inserted (ok False or no free slot).
    A point's creation stamp is its reference keyframe's frame id."""
    B = xyz.shape[0]
    P = m.pt_valid.shape[0]
    slots, free_ok = alloc_point_slots(m, B)
    ins = ok & free_ok
    tgt = torch.where(ins, slots, P)
    ref = ref_kf.to(torch.int32).expand(B)
    first_stamp = m.kf_frame_id[ref.clamp(min=0).to(torch.int64)]
    m = m._replace(
        pt_xyz=put(m.pt_xyz, tgt, xyz),
        pt_valid=put(m.pt_valid, tgt, True),
        pt_desc=put(m.pt_desc, tgt, desc),
        pt_normal=put(m.pt_normal, tgt, normal),
        pt_min_dist=put(m.pt_min_dist, tgt, min_dist),
        pt_max_dist=put(m.pt_max_dist, tgt, max_dist),
        pt_ref_kf=put(m.pt_ref_kf, tgt, ref),
        pt_first_kf=put(m.pt_first_kf, tgt, first_stamp),
        pt_visible=put(m.pt_visible, tgt, 1.0),
        pt_found=put(m.pt_found, tgt, 1.0),
        n_pt=m.n_pt + ins.sum(dtype=torch.int32),
    )
    return m, torch.where(ins, slots, -1).to(torch.int32)


def erase_points(m: MapState, pt_ids: torch.Tensor) -> MapState:
    """MapPoint::SetBadFlag for a batch: clear the points' validity and
    detach every feature link to them. An id equal to P is ignored."""
    P = m.pt_valid.shape[0]
    bad = put(torch.zeros(P, dtype=torch.bool, device=pt_ids.device), pt_ids, True)
    linked = m.kf_pt_idx >= 0
    obs_bad = linked & bad[m.kf_pt_idx.clamp(min=0).to(torch.int64)]
    return m._replace(
        pt_valid=m.pt_valid & ~bad,
        kf_pt_idx=torch.where(obs_bad, -1, m.kf_pt_idx),
        n_pt=m.n_pt - (bad & m.pt_valid).sum(dtype=torch.int32),
    )


def erase_keyframe(m: MapState, kf_id: torch.Tensor) -> MapState:
    """KeyFrame::SetBadFlag: invalidate the keyframe and its links and
    repair the spanning tree. Live children adopt the victim's parent;
    the victim keeps its parent pointer and records its pose relative
    to it (kf_Tcp), so trajectory export can climb through it."""
    K, N = m.kf_pt_idx.shape
    dev = m.kf_Tcw.device
    kf1 = kf_id.reshape(1).to(torch.int64)
    grandparent = take(m.kf_parent, kf_id)
    # only live children re-parent: an erased child's kf_Tcp is relative
    # to this victim, so its chain must keep pointing here
    children = (m.kf_parent == kf_id) & m.kf_valid
    new_parent = torch.where(children, grandparent, m.kf_parent)
    new_parent[kf1] = grandparent
    new_loop = torch.where(m.kf_loop_edge == kf_id, -1, m.kf_loop_edge)
    new_loop.index_fill_(0, kf1, -1)
    # pose relative to the parent at erase time (identity for a root)
    Tp_inv = se3_inverse(take(m.kf_Tcw, grandparent.clamp(min=0)))
    Tcp = torch.where(
        grandparent >= 0, take(m.kf_Tcw, kf_id) @ Tp_inv, torch.eye(4, device=dev)
    )
    return m._replace(
        kf_valid=m.kf_valid.index_fill(0, kf1, False),
        kf_kp_valid=m.kf_kp_valid.index_fill(0, kf1, False),
        kf_pt_idx=m.kf_pt_idx.index_fill(0, kf1, -1),
        kf_parent=new_parent,
        kf_loop_edge=new_loop,
        kf_Tcp=m.kf_Tcp.index_copy(0, kf1, Tcp.unsqueeze(0)),
        n_kf=m.n_kf - 1,
    )
