"""Projection matching of map points to frame features.

Port of `search_by_projection` and `_resolve_conflicts` from
orb_slam2_test_tpu/engine/matchers.py (reference: ORBmatcher.cc
SearchByProjection). Every map point is projected, gated (validity,
frustum, distance range, predicted octave, window radius) and matched
through one masked [P, N] Hamming matrix; conflicts where several
points pick one feature go to the smallest (distance, point row).

The port carries the settings the tracking step uses: no view-angle
gate (`check_view_cos=False` in the JAX package), no ratio test
(`ratio=1.0`) and every point in the matrix (`max_candidates=None`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_test_tpu_torch.engine.frame import FrameData
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.ops.matching import (
    TH_HIGH,
    best_two,
    masked_hamming_matrix,
)

_INT32_MAX = torch.iinfo(torch.int32).max


class ProjectionMatch(NamedTuple):
    feat_pt: torch.Tensor  # [N] int32 — point id matched to each feature (-1)
    pt_feat: torch.Tensor  # [P] int32 — feature id matched to each point (-1)
    n_matches: torch.Tensor  # [] int32


def _resolve_conflicts(
    best_feat: torch.Tensor,  # [P] best feature per point (-1 none)
    best_dist: torch.Tensor,  # [P] int32
    n_features: int,
    pt_ids: torch.Tensor | None = None,  # [P] global point ids
) -> tuple[torch.Tensor, torch.Tensor]:
    """Many points may select one feature; the smallest distance wins,
    ties to the lowest point row.

    Returns (feat_pt [N] winning point id per feature, pt_feat [P]
    feature per point after losing points are dropped). The scatter-min
    writes into an [N + 1] buffer whose last slot takes the points with
    no match, as `mode="drop"` does in the JAX package."""
    dev = best_feat.device
    P = best_feat.shape[0]
    rows = torch.arange(P, dtype=torch.int32, device=dev)
    if pt_ids is None:
        pt_ids = rows
    has = best_feat >= 0
    tgt = torch.where(has, best_feat, n_features).to(torch.int64)
    enc = torch.where(
        has, best_dist.to(torch.int32) * (P + 1) + rows, _INT32_MAX
    ).to(torch.int32)
    buf = torch.full((n_features + 1,), _INT32_MAX, dtype=torch.int32, device=dev)
    buf.scatter_reduce_(0, tgt, enc, "amin", include_self=True)
    feat_best = buf[:n_features]
    win_row = torch.where(feat_best < _INT32_MAX, feat_best % (P + 1), -1)
    feat_pt = torch.where(
        win_row >= 0, pt_ids[win_row.clamp(min=0).to(torch.int64)], -1
    ).to(torch.int32)
    # a point keeps its match only if it won the feature
    won = has & (win_row[best_feat.clamp(min=0).to(torch.int64)] == rows)
    pt_feat = torch.where(won, best_feat, -1).to(torch.int32)
    return feat_pt, pt_feat


def search_by_projection(
    cam: PinholeCamera,
    Tcw: torch.Tensor,  # [4, 4] predicted pose
    pts_xyz: torch.Tensor,  # [P, 3]
    pts_desc: torch.Tensor,  # [P, 8] int32
    pts_valid: torch.Tensor,  # [P] bool
    pts_normal: torch.Tensor,  # [P, 3] (unused: no view-angle gate)
    pts_mindist: torch.Tensor,  # [P]
    pts_maxdist: torch.Tensor,  # [P]
    pt_ids: torch.Tensor,  # [P] global map ids (for output labeling)
    frame: FrameData,
    radius: float = 15.0,
    max_hamming: int = TH_HIGH,
    scale_factor: float = 1.2,
    n_levels: int = 8,
) -> ProjectionMatch:
    """Project map points into the frame and match to nearby features
    (reference SearchByProjection(Frame&, vector<MapPoint*>))."""
    N = frame.uv.shape[0]
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    Ow = -R.T @ t

    pc = pts_xyz @ R.T + t
    z = pc[:, 2]
    z_safe = torch.where(z.abs() > 1e-6, z, 1e-6)
    u = cam.fx * pc[:, 0] / z_safe + cam.cx
    v = cam.fy * pc[:, 1] / z_safe + cam.cy

    in_img = (z > 0.0) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    dist = torch.linalg.norm(pts_xyz - Ow, dim=-1)
    dist_ok = (dist >= pts_mindist * 0.8) & (dist <= pts_maxdist * 1.2)

    # predicted octave from distance (MapPoint::PredictScale); the log
    # is taken in float32 as jnp.log(scale_factor) is
    log_scale = float(np.log(np.float32(scale_factor)))
    pred_level = torch.clamp(
        torch.ceil(
            torch.log(pts_maxdist.clamp(min=1e-9) / dist.clamp(min=1e-9))
            / log_scale
        ).to(torch.int32),
        0,
        n_levels - 1,
    )
    level_scale = scale_factor ** pred_level.to(torch.float32)

    usable = pts_valid & in_img & dist_ok

    # geometric masks on the [P, N] matrix
    du = u[:, None] - frame.uv[None, :, 0]
    dv = v[:, None] - frame.uv[None, :, 1]
    r_eff = radius * level_scale
    win = (du * du + dv * dv) <= (r_eff * r_eff)[:, None]
    lvl_ok = (frame.level[None, :] >= pred_level[:, None] - 1) & (
        frame.level[None, :] <= pred_level[:, None] + 1
    )
    mask = win & lvl_ok & usable[:, None] & frame.valid[None, :]

    d = masked_hamming_matrix(
        pts_desc, frame.desc, torch.ones_like(usable), frame.valid
    )
    d = torch.where(mask, d, 512)

    best_idx, best, _ = best_two(d)
    ok = (best <= max_hamming) & usable
    best_feat = torch.where(ok, best_idx, -1)

    feat_pt, pt_feat = _resolve_conflicts(best_feat, best, N, pt_ids)
    return ProjectionMatch(
        feat_pt=feat_pt,
        pt_feat=pt_feat,
        n_matches=(feat_pt >= 0).sum(dtype=torch.int32),
    )
