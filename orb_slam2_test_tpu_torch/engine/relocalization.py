"""Relocalization: recover the camera pose after tracking loss.

Port of orb_slam2_test_tpu/engine/relocalization.py (reference:
Tracking::Relocalization). For each place candidate from the keyframe
database: match the frame's descriptors to the candidate keyframe's map
points, solve adaptive PnP RANSAC, and run motion-only BA (kernel 2 on
the card) from the PnP pose; with fewer than `min_inliers` inliers,
widen the matches by a projection search around that pose and run
motion-only BA again. Accept at `min_inliers`.
"""

from __future__ import annotations

from typing import Callable

import torch

from orb_slam2_test_tpu_torch.engine.frame import FrameData
from orb_slam2_test_tpu_torch.engine.matchers import (
    match_by_descriptor_to_map,
    search_by_projection,
)
from orb_slam2_test_tpu_torch.slam_map.mapstate import MapState
from orb_slam2_test_tpu_torch.solvers.pnp import pnp_ransac_adaptive
from orb_slam2_test_tpu_torch.solvers.pose_opt import pose_optimization


def relocalize(
    frame: FrameData,
    m: MapState,
    cam,
    candidates: list[int],
    pnp_sampler: Callable[[], Callable[[torch.Tensor, int], torch.Tensor]],
    level_sigma2: torch.Tensor,  # [n_levels] on the map's device
    min_matches: int = 15,
    min_inliers: int = 50,
    max_candidates: int = 5,
):
    """Try the first `max_candidates` candidate keyframes in order.
    `pnp_sampler()` is called once per candidate that reaches PnP and
    returns that candidate's draw function (`pnp_ransac_adaptive`).

    Returns (ok, Tcw [4, 4] numpy or None, feat_pt [N] or None, info):
    info counts the candidates that reached PnP ("tried"), the PnP
    rounds and hypotheses, and the hypotheses whose DLT P had a
    negative det."""
    info = {"tried": 0, "pnp_rounds": 0, "hypotheses": 0, "negative_det": 0}
    uvr = torch.cat([frame.uv, frame.ur[:, None]], dim=-1)
    isig2 = 1.0 / level_sigma2[frame.level.to(torch.int64)]
    P = m.pt_valid.shape[0]
    for kf in candidates[:max_candidates]:
        row = m.kf_pt_idx[kf]
        has = row >= 0
        pm = match_by_descriptor_to_map(
            frame, m.pt_desc[row.clamp(min=0).to(torch.int64)],
            has & m.kf_kp_valid[kf], torch.where(has, row, -1),
        )
        if int(pm.n_matches) < min_matches:
            continue
        info["tried"] += 1
        feat_pt = pm.feat_pt
        sel = feat_pt >= 0
        X = m.pt_xyz[feat_pt.clamp(min=0).to(torch.int64)]
        # adaptive iteration count (reference SetRansacParameters): one
        # round at healthy inlier ratios, more at the 20-30% of hard
        # relocalizations
        res, stats = pnp_ransac_adaptive(
            cam, X, frame.uv, sel & frame.valid, pnp_sampler(), min_inliers=10)
        info["pnp_rounds"] += stats.rounds
        info["hypotheses"] += stats.hypotheses
        info["negative_det"] += stats.negative_det
        if not bool(res.success):
            continue
        # motion-only BA on the PnP pose
        po = pose_optimization(cam, res.Tcw, X, uvr, isig2, sel & frame.valid & res.inliers)
        n = int(po.n_inliers)
        if n < min_inliers:
            # widen with a projection search around the estimated pose
            # (the reference's SearchByProjection widening)
            pm2 = search_by_projection(
                cam, po.Tcw, m.pt_xyz, m.pt_desc, m.pt_valid, m.pt_normal,
                m.pt_min_dist, m.pt_max_dist,
                torch.arange(P, dtype=torch.int32, device=X.device),
                frame, radius=10.0, check_view_cos=False, max_candidates=min(P, 8192),
            )
            feat_pt = torch.where(feat_pt >= 0, feat_pt, pm2.feat_pt)
            sel = feat_pt >= 0
            X = m.pt_xyz[feat_pt.clamp(min=0).to(torch.int64)]
            po = pose_optimization(cam, po.Tcw, X, uvr, isig2, sel & frame.valid)
            n = int(po.n_inliers)
        if n >= min_inliers:
            return True, po.Tcw.cpu().numpy(), torch.where(po.inliers, feat_pt, -1), info
    return False, None, None, info
