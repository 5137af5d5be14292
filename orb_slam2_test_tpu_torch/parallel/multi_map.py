"""Concurrent multi-sequence mapping: one joint distributed BA over the
maps of several independently tracked sequences (BASELINE config 5,
"KITTI 00+02+05 concurrent multi-sequence mapping").

Port of orb_slam2_test_tpu/parallel/multi_map.py. The reference is one
System with one Map (src/System.cc). Here N sequences are tracked by
their own Systems, each with its map and calibration, and their
camera-point graphs are merged into one block-diagonal problem that is
point-sharded over the BA mesh (parallel/dist_ba.py): every shard
linearizes and Schur-reduces its block of points from all sequences,
the reduced camera system is all-reduced, and the camera solve is
replicated. Each sequence's calibration rides along as per-camera
intrinsic tensors (dist_ba._cam_for_obs).

The compaction is numpy on the host: only live keyframes, points and
observations enter the merged problem, so the joint solve's cost
follows the maps' size, not their capacity.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Sequence as Seq

import numpy as np
import torch
import torch.distributed as dist

from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.parallel.dist_ba import (
    dist_bundle_adjust,
    distributed,
    make_ba_mesh,
    shard_problem,
)
from orb_slam2_test_tpu_torch.parallel.multihost import make_global_problem
from orb_slam2_test_tpu_torch.slam_map.mapstate import MapState
from orb_slam2_test_tpu_torch.solvers.ba_core import BAProblem
from orb_slam2_test_tpu_torch.utils.scatter import put


class CompactProblem(NamedTuple):
    """A BAProblem of the live entries of one MapState, and the slots to
    write the solution back to."""

    prob: BAProblem
    kf_ids: np.ndarray  # [C] map slot of camera c
    pt_ids: np.ndarray  # [Q] map slot of point q


def compact_problem(
    m: MapState,
    scale_factor: float = 1.2,
    max_cams: int | None = None,
) -> CompactProblem | None:
    """The dense, minimal BAProblem of a map (host-side), or None for a
    map of fewer than 2 keyframes or 8 points.

    The reference's GlobalBundleAdjustemnt set-up (src/Optimizer.cc
    BundleAdjustment: every live keyframe, point and observation),
    compacted: padding and dead slots are dropped. Cameras are in age
    order (kf_frame_id; slots are recycled). The oldest keyframe is
    fixed, and the second too for a purely monocular map (its scale
    gauge). max_cams: only the newest max_cams keyframes stay free; the
    older ones keep their observations and are fixed."""

    def host(x):
        return x.detach().cpu().numpy()

    kf_valid = host(m.kf_valid)
    pt_valid = host(m.pt_valid)
    kf_ids = np.where(kf_valid)[0]
    pt_ids = np.where(pt_valid)[0]
    if len(kf_ids) < 2 or len(pt_ids) < 8:
        return None
    kf_ids = kf_ids[np.argsort(host(m.kf_frame_id)[kf_ids])]

    P_cap = pt_valid.shape[0]
    inv_pt = np.full(P_cap, -1, np.int64)
    inv_pt[pt_ids] = np.arange(len(pt_ids))

    kf_pt_idx = host(m.kf_pt_idx)[kf_ids]  # [C, N]
    obs_mask = (kf_pt_idx >= 0) & host(m.kf_kp_valid)[kf_ids]
    obs_mask &= np.where(obs_mask, pt_valid[np.clip(kf_pt_idx, 0, P_cap - 1)], False)
    oc, of = np.nonzero(obs_mask)  # camera row, feature column

    uv = host(m.kf_uv)[kf_ids][oc, of]
    ur = host(m.kf_ur)[kf_ids][oc, of]
    lvl = host(m.kf_level)[kf_ids][oc, of].astype(np.float32)
    isig2 = 1.0 / scale_factor ** (2.0 * lvl)
    obs_pt = inv_pt[kf_pt_idx[oc, of]]

    cam_fixed = np.zeros(len(kf_ids), bool)
    cam_fixed[0] = True
    if not np.any(ur >= 0.0) and len(kf_ids) > 1:
        cam_fixed[1] = True
    if max_cams is not None and len(kf_ids) > max_cams:
        cam_fixed[: len(kf_ids) - max_cams] = True

    dev = m.kf_Tcw.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    prob = BAProblem(
        cam_Tcw=t(host(m.kf_Tcw)[kf_ids]),
        cam_fixed=t(cam_fixed),
        pt_xyz=t(host(m.pt_xyz)[pt_ids]),
        pt_valid=t(np.ones(len(pt_ids), bool)),
        obs_cam=t(oc.astype(np.int32)),
        obs_pt=t(obs_pt.astype(np.int32)),
        obs_uvr=t(np.concatenate([uv, ur[:, None]], axis=1).astype(np.float32)),
        obs_isig2=t(isig2.astype(np.float32)),
        obs_valid=t(np.ones(len(oc), bool)),
    )
    return CompactProblem(prob, kf_ids, pt_ids)


class MergedProblem(NamedTuple):
    prob: BAProblem
    cam: PinholeCamera  # per-camera intrinsics, fields [C_total]
    cam_offsets: list  # camera index offset per sequence
    pt_offsets: list  # point index offset per sequence
    parts: list  # list[CompactProblem]


def merge_problems(parts: Seq[CompactProblem], cams: Seq[PinholeCamera]) -> MergedProblem:
    """Concatenate per-sequence problems into one block-diagonal joint
    problem with per-camera intrinsic tensors. The sequences share no
    point and no camera, so the reduced camera system is block-diagonal
    and the joint solve is each sequence's own; point sharding mixes the
    sequences' points across shards."""
    cam_off, pt_off = [], []
    co = po = 0
    for p in parts:
        cam_off.append(co)
        pt_off.append(po)
        co += p.prob.cam_Tcw.shape[0]
        po += p.prob.pt_xyz.shape[0]

    def cat(name):
        return torch.cat([getattr(p.prob, name) for p in parts])

    prob = BAProblem(
        cam_Tcw=cat("cam_Tcw"),
        cam_fixed=cat("cam_fixed"),
        pt_xyz=cat("pt_xyz"),
        pt_valid=cat("pt_valid"),
        obs_cam=torch.cat([p.prob.obs_cam + cam_off[i] for i, p in enumerate(parts)]),
        obs_pt=torch.cat([p.prob.obs_pt + pt_off[i] for i, p in enumerate(parts)]),
        obs_uvr=cat("obs_uvr"),
        obs_isig2=cat("obs_isig2"),
        obs_valid=cat("obs_valid"),
    )
    dev = prob.cam_Tcw.device

    def field(name):
        return torch.cat([
            torch.full((p.prob.cam_Tcw.shape[0],), float(getattr(c, name)),
                       dtype=torch.float32, device=dev)
            for p, c in zip(parts, cams)])

    joint_cam = cams[0]._replace(fx=field("fx"), fy=field("fy"), cx=field("cx"),
                                 cy=field("cy"), bf=field("bf"))
    return MergedProblem(prob, joint_cam, cam_off, pt_off, list(parts))


def scatter_back(m: MapState, part: CompactProblem, cam_Tcw: torch.Tensor,
                 pt_xyz: torch.Tensor) -> MapState:
    """A sequence's solved poses and points written back into its map."""
    dev = m.kf_Tcw.device
    return m._replace(
        kf_Tcw=put(m.kf_Tcw, torch.from_numpy(part.kf_ids).to(dev), cam_Tcw.to(dev)),
        pt_xyz=put(m.pt_xyz, torch.from_numpy(part.pt_ids).to(dev), pt_xyz.to(dev)),
    )


def _scale_factors(scale_factor, n: int) -> list:
    return list(scale_factor) if isinstance(scale_factor, (list, tuple)) else [scale_factor] * n


def _merged(maps, cams, max_cams, scale_factor):
    """(compact parts, live sequence indices, merged problem or None)."""
    parts = [compact_problem(m, scale_factor=sf, max_cams=max_cams)
             for m, sf in zip(maps, _scale_factors(scale_factor, len(maps)))]
    live = [i for i, p in enumerate(parts) if p is not None]
    if not live:
        return parts, live, None
    return parts, live, merge_problems([parts[i] for i in live], [cams[i] for i in live])


def _gather_points(pt_xyz: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's point block, in rank order (one all-gather); the
    one-process form already holds them all."""
    if not mesh.distributed:
        return pt_xyz
    out = pt_xyz.new_empty((mesh.size * pt_xyz.shape[0], 3))
    dist.all_gather_into_tensor(out, pt_xyz.contiguous())
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def joint_bundle_adjust(
    maps: Seq[MapState],
    cams: Seq[PinholeCamera],
    mesh=None,
    iters: int = 10,
    max_cams: int | None = None,
    scale_factor: float | Seq[float] = 1.2,
):
    """Joint distributed global BA over N sequence maps.

    scale_factor: each sequence's ORB pyramid scale (a number: shared),
    which sets each observation's information 1 / sigma^2. mesh: default
    `make_ba_mesh` on the first map's device. Returns (new_maps, info):
    info has the joint cost, the solve's wall seconds (device
    synchronized), the merged problem's cams / points / observations and
    the mesh size. A map too small to adjust comes back as it was (the
    same object)."""
    if mesh is None:
        mesh = make_ba_mesh(None, maps[0].kf_Tcw.device)
    parts, live, merged = _merged(maps, cams, max_cams, scale_factor)
    if merged is None:
        return list(maps), {"cost": float("nan"), "solve_s": 0.0, "n_cams": 0}
    sprob = shard_problem(merged.prob, mesh.size)
    if mesh.distributed:
        sprob = make_global_problem(sprob, mesh)

    _sync(mesh.device)
    t0 = time.perf_counter()
    cam_Tcw, pt_xyz, cost = dist_bundle_adjust(sprob, merged.cam, mesh, iters=iters)
    pt_xyz = _gather_points(pt_xyz, mesh)
    cost = float(cost)
    solve_s = time.perf_counter() - t0

    out = list(maps)
    for j, i in enumerate(live):
        p = parts[i]
        c0, q0 = merged.cam_offsets[j], merged.pt_offsets[j]
        nc, nq = p.prob.cam_Tcw.shape[0], p.prob.pt_xyz.shape[0]
        out[i] = scatter_back(maps[i], p, cam_Tcw[c0 : c0 + nc], pt_xyz[q0 : q0 + nq])
    info = {
        "cost": cost,
        "solve_s": solve_s,
        "n_cams": int(merged.prob.cam_Tcw.shape[0]),
        "n_pts": int(merged.prob.pt_xyz.shape[0]),
        "n_obs": int(merged.prob.obs_cam.shape[0]),
        "n_devices": mesh.size,
    }
    return out, info


def measure_scaling(
    maps: Seq[MapState],
    cams: Seq[PinholeCamera],
    iters: int = 8,
    max_cams: int | None = None,
    device_counts: Seq[int] | None = None,
    repeats: int = 3,
    scale_factor: float | Seq[float] = 1.2,
) -> dict:
    """Strong scaling of the joint distributed BA: the same merged
    problem solved on meshes of increasing size, efficiency = t(1) /
    (n t(n)), the minimum of `repeats` solves each."""
    _, _, merged = _merged(maps, cams, max_cams, scale_factor)
    if merged is None:
        return {"error": "maps too small to measure"}
    return measure_scaling_problem(merged.prob, merged.cam, iters=iters,
                                   device_counts=device_counts, repeats=repeats)


def measure_scaling_problem(
    prob: BAProblem,
    cam: PinholeCamera,
    iters: int = 8,
    device_counts: Seq[int] | None = None,
    repeats: int = 3,
) -> dict:
    """The timing core of measure_scaling, on a built problem.

    device_counts: the mesh sizes (default 1, 2, 4, 8 shards in one
    process; the world size in a distributed run). Each solve is timed
    on the host clock with the device synchronized before and after, and
    on the process's CPU clock. With one card the shards run one after
    another, so the wall time cannot scale: the per-device signal is
    partition_efficiency = t_shard(1) / (n t_shard(n)), the time of one
    1/n shard's own program on a one-shard mesh, as on n devices whose
    collectives cost nothing."""
    dev = prob.cam_Tcw.device
    if device_counts is None:
        device_counts = [dist.get_world_size()] if distributed() else [1, 2, 4, 8]

    def timed(p, mesh):
        _sync(dev)
        t0, c0 = time.perf_counter(), time.process_time()
        dist_bundle_adjust(p, cam, mesh, iters=iters)
        _sync(dev)
        return time.perf_counter() - t0, time.process_time() - c0

    results, cpu_results, shard_results = {}, {}, {}
    mesh1 = None if distributed() else make_ba_mesh(1, dev)
    for n in device_counts:
        mesh = make_ba_mesh(n, dev)
        sprob = shard_problem(prob, n)
        if mesh.distributed:
            sprob = make_global_problem(sprob, mesh)
        runs = [timed(sprob, mesh) for _ in range(repeats)]
        results[n] = min(t for t, _ in runs)
        cpu_results[n] = min(c for _, c in runs)

        Qs = sprob.pt_xyz.shape[0] // mesh.local_shards
        Os = sprob.obs_cam.shape[0] // mesh.local_shards
        local = sprob._replace(
            pt_xyz=sprob.pt_xyz[:Qs], pt_valid=sprob.pt_valid[:Qs],
            obs_cam=sprob.obs_cam[:Os], obs_pt=sprob.obs_pt[:Os],
            obs_uvr=sprob.obs_uvr[:Os], obs_isig2=sprob.obs_isig2[:Os],
            obs_valid=sprob.obs_valid[:Os],
        )
        shard_results[n] = min(timed(local, mesh1 or mesh)[0] for _ in range(repeats))
    t1 = results[min(results)]
    ts1 = shard_results[min(shard_results)]
    c1 = cpu_results[min(cpu_results)]
    return {
        "metric": "dist_ba_strong_scaling",
        "n_cams": int(prob.cam_Tcw.shape[0]),
        "n_pts": int(prob.pt_xyz.shape[0]),
        "n_obs": int(prob.obs_cam.shape[0]),
        "iters": iters,
        "device": str(dev),
        "solve_s": {str(n): t for n, t in results.items()},
        "efficiency": {str(n): t1 / (n * t) for n, t in results.items()},
        "shard_solve_s": {str(n): t for n, t in shard_results.items()},
        "partition_efficiency": {str(n): ts1 / (n * t) for n, t in shard_results.items()},
        "host_cores": len(os.sched_getaffinity(0)),
        "cpu_s": {str(n): c for n, c in cpu_results.items()},
        "work_efficiency": {str(n): c1 / c for n, c in cpu_results.items()},
    }
