"""Projection and triangulation matching.

Port of `search_by_projection`, `_resolve_conflicts`,
`search_for_initialization`, `search_for_triangulation` and
`match_by_descriptor_to_map` from orb_slam2_test_tpu/engine/matchers.py
(reference: ORBmatcher.cc SearchByProjection, SearchForInitialization,
SearchForTriangulation, and SearchByBoW for reference-keyframe
tracking). Every map point is projected, gated (validity, frustum,
distance range, view angle, predicted octave, window radius) and
matched through one masked [P, N] Hamming matrix; conflicts where
several points pick one feature go to the smallest (distance, point
row). Loop closing's keyframe-to-keyframe searches, `search_by_bow`
(SearchByBoW: the vocabulary node constraint as a mask on the Hamming
matrix) and `search_by_sim3` (SearchBySim3: mutual projection through a
relative Sim3), use the same ±1 matmul for their pair matrices.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_test_tpu_torch.engine.frame import FrameData
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera, camera_matrix
from orb_slam2_test_tpu_torch.ops.extractor import top_k_stable
from orb_slam2_test_tpu_torch.ops.matching import (
    TH_HIGH,
    TH_LOW,
    best_two,
    masked_hamming_matrix,
    rotation_consistency,
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
    pts_normal: torch.Tensor,  # [P, 3]
    pts_mindist: torch.Tensor,  # [P]
    pts_maxdist: torch.Tensor,  # [P]
    pt_ids: torch.Tensor,  # [P] global map ids (for output labeling)
    frame: FrameData,
    radius: float = 15.0,
    max_hamming: int = TH_HIGH,
    ratio: float = 1.0,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    check_view_cos: bool = True,
    max_candidates: int | None = None,
) -> ProjectionMatch:
    """Project map points into the frame and match to nearby features
    (reference SearchByProjection(Frame&, Frame&) for the motion model
    and SearchByProjection(Frame&, vector<MapPoint*>) for the local map).

    max_candidates: when set and smaller than P, the per-point gates run
    over all P points, then only the first max_candidates usable points,
    in ascending index order, enter the [C, N] descriptor matrix. A
    stable descending sort of the usable flags picks them, as
    jax.lax.top_k does."""
    N = frame.uv.shape[0]
    P = pts_xyz.shape[0]
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    Ow = -R.T @ t

    pc = pts_xyz @ R.T + t
    z = pc[:, 2]
    z_safe = torch.where(z.abs() > 1e-6, z, 1e-6)
    u = cam.fx * pc[:, 0] / z_safe + cam.cx
    v = cam.fy * pc[:, 1] / z_safe + cam.cy

    in_img = (z > 0.0) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    view = pts_xyz - Ow
    dist = torch.linalg.norm(view, dim=-1)
    dist_ok = (dist >= pts_mindist * 0.8) & (dist <= pts_maxdist * 1.2)
    usable = pts_valid & in_img & dist_ok
    if check_view_cos:
        ncos = (view * pts_normal).sum(-1) / torch.clamp(dist, min=1e-9)
        usable = usable & (ncos > 0.5)  # reference: viewCos > 0.5 (60 deg)

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

    sel = None
    if max_candidates is not None and max_candidates < P:
        # compact the usable points so the dense matrix is [C, N]
        score, sel = top_k_stable(usable.to(torch.int32), max_candidates)
        usable = score > 0
        u, v = u[sel], v[sel]
        level_scale = level_scale[sel]
        pred_level = pred_level[sel]
        pts_desc = pts_desc[sel]
        pt_ids = pt_ids[sel]

    # geometric masks on the [C, N] matrix
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

    best_idx, best, second = best_two(d)
    ok = (best <= max_hamming) & usable
    if ratio < 1.0:
        ok = ok & (best.to(torch.float32) < ratio * second.to(torch.float32))
    best_feat = torch.where(ok, best_idx, -1)

    feat_pt, pt_feat = _resolve_conflicts(best_feat, best, N, pt_ids)
    if sel is not None:
        # scatter the per-candidate assignment back to [P] through a
        # sentinel slot P that takes the unusable rows
        buf = torch.full((P + 1,), -1, dtype=torch.int32, device=pt_feat.device)
        buf[torch.where(usable, sel, P)] = pt_feat
        pt_feat = buf[:P]
    return ProjectionMatch(
        feat_pt=feat_pt,
        pt_feat=pt_feat,
        n_matches=(feat_pt >= 0).sum(dtype=torch.int32),
    )


def search_for_initialization(
    f1: FrameData,
    f2: FrameData,
    window: int = 100,
    max_hamming: int = TH_LOW,
    ratio: float = 0.9,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Window-constrained matching between the two frames of monocular
    initialization (ORBmatcher::SearchForInitialization: level-0
    features, window 100, ratio 0.9, rotation histogram, cross check).
    Returns (match12 [N1] int32 -> index in f2 or -1, n_matches).
    argmin takes the first minimum, as jnp.argmax of the negation does."""
    lvl0_1 = (f1.level == 0) & f1.valid
    lvl0_2 = (f2.level == 0) & f2.valid
    d = masked_hamming_matrix(f1.desc, f2.desc, lvl0_1, lvl0_2)
    du = f1.uv[:, None, 0] - f2.uv[None, :, 0]
    dv = f1.uv[:, None, 1] - f2.uv[None, :, 1]
    d = torch.where((du.abs() <= window) & (dv.abs() <= window), d, 512)

    best_idx, best, second = best_two(d)
    ok = (best <= max_hamming) & (best.to(torch.float32) < ratio * second.to(torch.float32))
    m12 = rotation_consistency(torch.where(ok, best_idx, -1), f1.angle, f2.angle)

    # cross check: the chosen f2 feature's best f1 feature is this one
    best21 = d.argmin(dim=0)
    rows = torch.arange(m12.shape[0], device=d.device)
    agree = best21[m12.clamp(min=0).to(torch.int64)] == rows
    m12 = torch.where((m12 >= 0) & agree, m12, -1).to(torch.int32)
    return m12, (m12 >= 0).sum(dtype=torch.int32)


def match_by_descriptor_to_map(
    frame: FrameData,
    pts_desc: torch.Tensor,  # [P, 8] int32
    pts_valid: torch.Tensor,  # [P]
    pt_ids: torch.Tensor,  # [P]
    max_hamming: int = TH_LOW,
    ratio: float = 0.7,
) -> ProjectionMatch:
    """Brute-force descriptor match of a point set to the frame, no
    geometry: the counterpart of SearchByBoW(KeyFrame*, Frame&) in
    TrackReferenceKeyFrame (the BoW feature vector only narrows the
    candidates of a descriptor nearest neighbour with ratio 0.7)."""
    d = masked_hamming_matrix(pts_desc, frame.desc, pts_valid, frame.valid)
    best_idx, best, second = best_two(d)
    ok = (best <= max_hamming) & (best.to(torch.float32) < ratio * second.to(torch.float32))
    feat_pt, pt_feat = _resolve_conflicts(
        torch.where(ok, best_idx, -1), best, frame.uv.shape[0], pt_ids.to(torch.int32)
    )
    return ProjectionMatch(
        feat_pt=feat_pt,
        pt_feat=pt_feat,
        n_matches=(feat_pt >= 0).sum(dtype=torch.int32),
    )


def search_for_triangulation(
    cam: PinholeCamera,
    kf1_uv: torch.Tensor, kf1_desc: torch.Tensor, kf1_level: torch.Tensor,
    kf1_free: torch.Tensor,  # [N1] bool: feature has no map point yet
    kf2_uv: torch.Tensor, kf2_desc: torch.Tensor, kf2_level: torch.Tensor,
    kf2_free: torch.Tensor,
    Tcw1: torch.Tensor, Tcw2: torch.Tensor,
    max_hamming: int = TH_LOW,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Epipolar-gated matching of unlinked features between two
    keyframes (ORBmatcher::SearchForTriangulation): all [N1, N2] pairs,
    the epipolar distance in the second image gated at 3.84 sigma^2 of
    its octave (with the literal 1.2 of the JAX package, whatever the
    scale factor), the nearest descriptor within max_hamming, and a
    mutual check. Returns (match12 [N1] int32 -> index in kf2 or -1,
    n_matches).

    The inverses are LU inverses as jnp.linalg.inv computes them, taken
    with `inv_ex`, which reports a singular matrix on the device instead
    of reading a status back to the host."""
    dev = kf1_uv.device
    T21 = Tcw2 @ torch.linalg.inv_ex(Tcw1).inverse
    R21, t21 = T21[:3, :3], T21[:3, 3]
    z = torch.zeros_like(t21[0])
    tx = torch.stack([
        torch.stack([z, -t21[2], t21[1]]),
        torch.stack([t21[2], z, -t21[0]]),
        torch.stack([-t21[1], t21[0], z]),
    ])
    K = camera_matrix(cam, dev)
    Kinv = torch.linalg.inv_ex(K).inverse
    F12 = Kinv.T @ tx @ R21 @ Kinv

    p1 = torch.cat([kf1_uv, torch.ones_like(kf1_uv[:, :1])], dim=-1)
    lines = p1 @ F12.T  # epipolar lines in image 2 [N1, 3]
    p2 = torch.cat([kf2_uv, torch.ones_like(kf2_uv[:, :1])], dim=-1)
    num = lines @ p2.T  # [N1, N2]
    den = lines[:, 0] ** 2 + lines[:, 1] ** 2
    d_epi2 = (num * num) / torch.clamp(den, min=1e-12)[:, None]
    sigma2_2 = (1.2 ** kf2_level.to(torch.float32)) ** 2
    epi_ok = d_epi2 < 3.84 * sigma2_2[None, :]

    d = masked_hamming_matrix(kf1_desc, kf2_desc, kf1_free, kf2_free)
    d = torch.where(epi_ok, d, 512)
    m12 = torch.where(d.min(dim=-1).values <= max_hamming, d.argmin(dim=-1), -1)
    # mutual check (argmin returns the first minimum, as in jnp)
    best21 = d.argmin(dim=0)
    rows = torch.arange(m12.shape[0], device=dev)
    agree = best21[m12.clamp(min=0)] == rows
    m12 = torch.where((m12 >= 0) & agree, m12, -1).to(torch.int32)
    return m12, (m12 >= 0).sum(dtype=torch.int32)


def search_by_bow(
    frame: FrameData,
    frame_nodes: torch.Tensor,  # [N] vocabulary node ids (-1 invalid)
    pts_desc: torch.Tensor,  # [P, 8] candidate map-point descriptors
    pts_valid: torch.Tensor,  # [P]
    pt_ids: torch.Tensor,  # [P] global map ids
    pts_nodes: torch.Tensor,  # [P] vocabulary node ids of the candidates
    pts_angle: torch.Tensor,  # [P] keypoint angle in the source keyframe
    max_hamming: int = TH_LOW,
    ratio: float = 0.7,
) -> ProjectionMatch:
    """Keyframe <-> keyframe matching restricted to features in the same
    vocabulary node (ORBmatcher::SearchByBoW): the node equality is a
    mask on the full Hamming matrix; then TH_LOW, the 0.7 ratio, the
    rotation histogram and the conflict resolution."""
    d = masked_hamming_matrix(pts_desc, frame.desc, pts_valid, frame.valid)
    node_ok = ((pts_nodes[:, None] == frame_nodes[None, :])
               & (pts_nodes[:, None] >= 0) & (frame_nodes[None, :] >= 0))
    d = torch.where(node_ok, d, 512)
    best_idx, best, second = best_two(d)
    ok = (best <= max_hamming) & (best.to(torch.float32) < ratio * second.to(torch.float32))
    pt_feat_raw = torch.where(ok & pts_valid, best_idx, -1)
    pt_feat_raw = rotation_consistency(pt_feat_raw, pts_angle, frame.angle)
    feat_pt, pt_feat = _resolve_conflicts(pt_feat_raw, best, frame.uv.shape[0],
                                          pt_ids.to(torch.int32))
    return ProjectionMatch(feat_pt=feat_pt, pt_feat=pt_feat,
                           n_matches=(feat_pt >= 0).sum(dtype=torch.int32))


def search_by_sim3(
    cam: PinholeCamera,
    f1: FrameData,
    pc1: torch.Tensor,  # [N1, 3] camera-1-frame positions of f1's map points
    has1: torch.Tensor,  # [N1] the feature has a map point
    f2: FrameData,
    pc2: torch.Tensor,  # [N2, 3]
    has2: torch.Tensor,
    S12: torch.Tensor,  # [4, 4] Sim3: pc1 ~ S12 pc2
    radius: float = 7.5,
    max_hamming: int = TH_HIGH,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Widen keyframe <-> keyframe matches with a known relative Sim3
    (ORBmatcher::SearchBySim3): each side's points are projected into
    the other image, matched inside a window of radius x 1.2^level, and
    mutually agreeing pairs kept (argmin takes the first minimum).
    Returns (match12 [N1] -> feature index in f2 or -1, n_matches)."""
    def proj(p3):
        z = torch.where(p3[..., 2].abs() > 1e-6, p3[..., 2], 1e-6)
        return torch.stack([cam.fx * p3[..., 0] / z + cam.cx,
                            cam.fy * p3[..., 1] / z + cam.cy], dim=-1), p3[..., 2]

    sR = S12[:3, :3]
    t12 = S12[:3, 3]
    s = torch.clamp(torch.linalg.norm(sR[:, 0]), min=1e-12)
    R = sR / s
    sR21 = (1.0 / s) * R.T
    t21 = -(R.T @ t12) / s

    p2_in1, z1 = proj(pc2 @ sR.T + t12)  # [N2, 2]
    p1_in2, z2 = proj(pc1 @ sR21.T + t21)  # [N1, 2]
    r1 = radius * (1.2 ** f1.level.to(torch.float32))
    r2 = radius * (1.2 ** f2.level.to(torch.float32))
    d = masked_hamming_matrix(f1.desc, f2.desc, has1 & f1.valid, has2 & f2.valid)

    # direction A: point j of f2 lands near feature i of f1
    duA = p2_in1[None, :, 0] - f1.uv[:, None, 0]
    dvA = p2_in1[None, :, 1] - f1.uv[:, None, 1]
    winA = ((duA * duA + dvA * dvA) <= (r1[:, None] ** 2)) & (z1[None, :] > 0)
    dA = torch.where(winA, d, 512)
    m21 = dA.argmin(dim=0)  # [N2] best f1 feature per f2 point
    okA = dA.min(dim=0).values <= max_hamming

    # direction B: point i of f1 lands near feature j of f2
    duB = p1_in2[:, None, 0] - f2.uv[None, :, 0]
    dvB = p1_in2[:, None, 1] - f2.uv[None, :, 1]
    winB = ((duB * duB + dvB * dvB) <= (r2[None, :] ** 2)) & (z2[:, None] > 0)
    dB = torch.where(winB, d, 512)
    m12 = dB.argmin(dim=1)  # [N1] best f2 feature per f1 point
    okB = dB.min(dim=1).values <= max_hamming

    rows = torch.arange(m12.shape[0], device=d.device)
    agree = okB & (m21[m12] == rows) & okA[m12]
    out = torch.where(agree, m12, -1).to(torch.int32)
    return out, (out >= 0).sum(dtype=torch.int32)
