"""Map-point attribute maintenance.

Port of orb_slam2_test_tpu/slam_map/maintenance.py (reference:
MapPoint::UpdateNormalAndDepth and ComputeDistinctiveDescriptors), one
segment reduction over the observation array each. The distinctive
descriptor is the member with the smallest MEAN Hamming distance to the
others (the reference takes the median), in closed form from per-point
bit counts:

    sum_j ham(d_i, d_j) = sum_b c_b + popcount(d_i) * n - 2 <bits(d_i), c>
"""

from __future__ import annotations

import torch

from orb_slam2_test_tpu_torch.slam_map.mapstate import MapState
from orb_slam2_test_tpu_torch.utils.scatter import put, put_add


def _unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 bit patterns -> [..., 256] float32 in {0, 1}."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., None] >> shifts) & 1
    return bits.reshape(desc.shape[:-1] + (256,)).to(torch.float32)


def update_normals_and_depth(
    m: MapState,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    kf_window: torch.Tensor | None = None,
) -> MapState:
    """pt_normal = mean unit vector from the observing keyframes to the
    point; pt_max_dist = the reference keyframe's viewing distance x
    scale^level, pt_min_dist = max / scale^(L-1).

    `kf_window` ([W], -1 padding) restricts the pass to those
    keyframes' observations; None runs over the whole map.

    The optical centre is computed as the JAX package computes it,
    einsum("kij,ki->kj", R^T, t), which is -R t and not the centre
    -R^T t; the two agree for rotation-free poses. It is copied, not
    corrected, so that both packages keep the same map."""
    K, N = m.kf_pt_idx.shape
    P = m.pt_valid.shape[0]
    if kf_window is None:
        rows, kp_ok, lvl = m.kf_pt_idx, m.kf_kp_valid, m.kf_level
        row_ok = m.kf_valid
        kf_of_row = torch.arange(K, device=rows.device)
    else:
        kfs = kf_window.clamp(min=0).to(torch.int64)
        rows, kp_ok, lvl = m.kf_pt_idx[kfs], m.kf_kp_valid[kfs], m.kf_level[kfs]
        row_ok = m.kf_valid[kfs] & (kf_window >= 0)
        kf_of_row = kfs
    linked = (rows >= 0) & kp_ok & row_ok[:, None]
    pid = torch.where(linked, rows, P).reshape(-1)  # P: write nowhere

    Tcw = m.kf_Tcw[kf_of_row]
    R, t = Tcw[:, :3, :3], Tcw[:, :3, 3]
    Ow = -torch.einsum("kij,ki->kj", R.transpose(1, 2), t)  # [W, 3]

    rows_c = rows.clamp(min=0).to(torch.int64)
    view = m.pt_xyz[rows_c] - Ow[:, None, :]  # [W, N, 3]
    dist = torch.clamp(torch.linalg.norm(view, dim=-1), min=1e-9)
    unit = view / dist[..., None]

    zeros = torch.zeros(P, device=pid.device)
    nsum = put_add(torch.zeros(P, 3, device=pid.device), pid, unit.reshape(-1, 3))
    nobs = put_add(zeros, pid, 1.0)
    normal = nsum / torch.clamp(nobs, min=1.0)[:, None]
    normal = normal / torch.clamp(torch.linalg.norm(normal, dim=-1), min=1e-9)[:, None]

    # distance range from the reference keyframe's observation; a
    # reference keyframe that links two features to one point writes
    # twice, and the later feature wins (utils.scatter.last_wins)
    is_ref = linked & (kf_of_row[:, None] == m.pt_ref_kf[rows_c])
    ref_pid = torch.where(is_ref, rows, P).reshape(-1)
    scales = scale_factor ** lvl.to(torch.float32)
    max_d = put(zeros, ref_pid, (dist * scales).reshape(-1))
    has_ref = put(torch.zeros(P, dtype=torch.bool, device=pid.device), ref_pid, True)

    upd = m.pt_valid & (nobs > 0)
    upd_rng = upd & has_ref
    return m._replace(
        pt_normal=torch.where(upd[:, None], normal, m.pt_normal),
        pt_max_dist=torch.where(upd_rng, max_d, m.pt_max_dist),
        pt_min_dist=torch.where(
            upd_rng, max_d / scale_factor ** (n_levels - 1), m.pt_min_dist
        ),
    )


def update_distinctive_descriptors(
    m: MapState, kf_ids: torch.Tensor, window: int
) -> MapState:
    """ComputeDistinctiveDescriptors for every point observed by the
    keyframes kf_ids ([window], -1 padding): the point adopts the
    observer descriptor, among those keyframes' observations, with the
    smallest mean Hamming distance to the others; ties go to the lowest
    observation index. Points with fewer than 2 such observations keep
    their descriptor."""
    P = m.pt_valid.shape[0]
    kfs = kf_ids.clamp(min=0).to(torch.int64)
    rows = m.kf_pt_idx[kfs]
    linked = (
        (rows >= 0) & m.kf_kp_valid[kfs] & m.kf_valid[kfs][:, None]
        & (kf_ids >= 0)[:, None]
    )
    pid = torch.where(linked, rows, P).reshape(-1).to(torch.int64)  # [O]
    desc = m.kf_desc[kfs].reshape(-1, 8)
    bits = _unpack_bits(desc)  # [O, 256]
    O = bits.shape[0]
    dev = bits.device

    cnt = put_add(torch.zeros(P, 256, device=dev), pid, bits)
    nobs = put_add(torch.zeros(P, device=dev), pid, 1.0)
    pid_safe = pid.clamp(max=P - 1)
    c_rows = cnt[pid_safe]
    score = c_rows.sum(-1) + bits.sum(-1) * nobs[pid_safe] - 2.0 * (bits * c_rows).sum(-1)
    score = torch.where(pid < P, score, torch.inf)

    # scatter-argmin in two passes: the least score per point, then the
    # lowest observation index within 0.5 of it (scores are integers)
    best = torch.full((P + 1,), torch.inf, device=dev)
    best.scatter_reduce_(0, pid, score, "amin")
    is_best = (pid < P) & (score <= best[pid_safe] + 0.5)
    win = torch.full((P + 1,), O, dtype=torch.int64, device=dev)
    win.scatter_reduce_(
        0, torch.where(is_best, pid, P), torch.arange(O, device=dev), "amin"
    )
    win = win[:P]
    new_desc = desc[win.clamp(max=O - 1)]
    upd = m.pt_valid & (nobs >= 2) & (win < O)
    return m._replace(pt_desc=torch.where(upd[:, None], new_desc, m.pt_desc))
