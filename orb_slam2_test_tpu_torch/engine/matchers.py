"""Projection and triangulation matching.

Port of `search_by_projection`, `_resolve_conflicts` and
`search_for_triangulation` from orb_slam2_test_tpu/engine/matchers.py
(reference: ORBmatcher.cc SearchByProjection, SearchForTriangulation).
Every map point is projected, gated (validity, frustum, distance range,
view angle, predicted octave, window radius) and matched through one
masked [P, N] Hamming matrix; conflicts where several points pick one
feature go to the smallest (distance, point row). Not ported yet:
`search_for_initialization`, `match_by_descriptor_to_map`,
`search_by_bow` and `search_by_sim3` (the host tracker and loop
closing).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_test_tpu_torch.engine.frame import FrameData
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.ops.extractor import top_k_stable
from orb_slam2_test_tpu_torch.ops.matching import (
    TH_HIGH,
    TH_LOW,
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


@functools.lru_cache(maxsize=None)
def camera_matrix(cam: PinholeCamera, device: torch.device) -> torch.Tensor:
    """The float32 intrinsic matrix K on `device`, uploaded once."""
    return torch.tensor(
        [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device,
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
