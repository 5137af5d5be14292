"""Local mapping: triangulation, duplicate fusion, local BA and culling.

Port of the keyframe-insertion stages of
orb_slam2_test_tpu/engine/local_mapping.py (reference: LocalMapping.cc
CreateNewMapPoints, SearchInNeighbors, LocalBundleAdjustment,
MapPointCulling, KeyFrameCulling). Each stage maps a MapState to a new
one and leaves its argument unchanged. Data-dependent branches of the
JAX package (`lax.cond`) are computed unconditionally and selected with
`torch.where`, so no stage reads a value back to the host.

Not ported yet: the single-neighbor forms `triangulate_with_neighbor`
and `fuse_with_neighbor(_counted)`, which only the JAX package's tests
call.
"""

from __future__ import annotations

import dataclasses

import torch

from orb_slam2_test_tpu_torch.engine.frame import FrameData
from orb_slam2_test_tpu_torch.engine.matchers import (
    camera_matrix,
    search_by_projection,
    search_for_triangulation,
)
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.geometry.triangulation import (
    triangulate_dlt,
    triangulation_checks,
)
from orb_slam2_test_tpu_torch.ops.extractor import top_k_stable
from orb_slam2_test_tpu_torch.ops.matching import TH_LOW
from orb_slam2_test_tpu_torch.slam_map.covisibility import (
    best_covisible,
    covisibility_weights,
    observation_counts,
)
from orb_slam2_test_tpu_torch.slam_map.mapstate import (
    MapCapacity,
    MapState,
    add_points,
    erase_keyframe,
    level_tables,
)
from orb_slam2_test_tpu_torch.solvers.ba_grid import GridBAProblem, grid_bundle_adjust
from orb_slam2_test_tpu_torch.utils.scatter import put, put_add, select, take


@dataclasses.dataclass(frozen=True)
class LocalBACaps:
    """Static capacities of the local BA window."""

    n_local: int = 16  # optimizable keyframes (reference: all covisible)
    n_fixed: int = 8  # boundary keyframes held fixed
    n_points: int = 4096  # optimizable points
    # LM schedule: the reference's 5 + 10 is cut short by mbAbortBA when
    # keyframes arrive at real cadence; 4 + 6 matches its effective one
    iters1: int = 4
    iters2: int = 6


def _centre(Tcw: torch.Tensor) -> torch.Tensor:
    """Optical centre -R^T t of a [4, 4] pose."""
    return -Tcw[:3, :3].T @ Tcw[:3, 3]


def triangulate_with_neighbors(
    m: MapState,
    cam: PinholeCamera,
    kf_new: torch.Tensor,  # [] keyframe slot
    nbr_ids: torch.Tensor,  # [B] covisible neighbor slots (-1 padding)
    cap: MapCapacity,
    n_nbrs: int,
) -> tuple[MapState, torch.Tensor]:
    """Create map points between kf_new and all its covisible neighbors
    (LocalMapping::CreateNewMapPoints): per neighbor, the epipolar match
    of unlinked features, DLT triangulation and the cheirality,
    parallax, reprojection and scale-consistency gates. Each free
    feature of kf_new adopts the FIRST neighbor, in covisibility order,
    whose triangulation passes; one batched insertion allocates the
    slots. Returns (map, n_created)."""
    dev = m.kf_uv.device
    N = m.kf_uv.shape[1]
    uv1, Tcw1 = take(m.kf_uv, kf_new), take(m.kf_Tcw, kf_new)
    desc1, lvl1 = take(m.kf_desc, kf_new), take(m.kf_level, kf_new).to(torch.int64)
    free1 = (take(m.kf_pt_idx, kf_new) < 0) & take(m.kf_kp_valid, kf_new)
    O1 = _centre(Tcw1)
    scales, sig2 = level_tables(cap, dev)
    K = camera_matrix(cam, dev)
    P1 = (K @ Tcw1[:3, :]).expand(N, 3, 4)

    ok_b, pts_b, j_b = [], [], []
    for b in range(n_nbrs):
        nbr = nbr_ids[b]
        k2 = nbr.clamp(min=0)
        uv2, Tcw2 = take(m.kf_uv, k2), take(m.kf_Tcw, k2)
        lvl2 = take(m.kf_level, k2).to(torch.int64)
        free2 = (take(m.kf_pt_idx, k2) < 0) & take(m.kf_kp_valid, k2)
        O2 = _centre(Tcw2)
        m12, _ = search_for_triangulation(
            cam, uv1, desc1, lvl1, free1,
            uv2, take(m.kf_desc, k2), lvl2, free2, Tcw1, Tcw2,
        )
        j = m12.clamp(min=0).to(torch.int64)
        uv2j = uv2[j]
        pts = triangulate_dlt(P1, (K @ Tcw2[:3, :]).expand(N, 3, 4), uv1, uv2j)
        finite = torch.isfinite(pts).all(-1)
        pts = torch.where(finite[:, None], pts, 0.0)
        checks = triangulation_checks(
            cam, Tcw1.expand(N, 4, 4), Tcw2.expand(N, 4, 4), pts, uv1, uv2j,
            sigma2_1=sig2[lvl1], sigma2_2=sig2[lvl2][j],
        )
        # scale consistency: distance ratio vs octave ratio within 1.5
        d1 = torch.linalg.norm(pts - O1, dim=-1)
        d2 = torch.linalg.norm(pts - O2, dim=-1)
        ratio_dist = d2 / torch.clamp(d1, min=1e-9)
        ratio_oct = scales[lvl1] / scales[lvl2][j]
        scale_ok = (ratio_dist < ratio_oct * 1.5) & (ratio_dist > ratio_oct / 1.5)
        baseline = torch.linalg.norm(O1 - O2)
        ok_b.append((m12 >= 0) & finite & checks.ok & scale_ok
                    & (nbr >= 0) & (baseline > 1e-4))
        pts_b.append(pts)
        j_b.append(j)
    ok_b, pts_b, j_b = torch.stack(ok_b), torch.stack(pts_b), torch.stack(j_b)

    # the first passing neighbor per feature (argmax returns the first
    # maximum; bool input is not supported, hence the cast)
    bstar = torch.argmax(ok_b.to(torch.uint8), dim=0)  # [N]
    ok_any = ok_b.any(0)
    ar = torch.arange(N, device=dev)
    pts, j_sel = pts_b[bstar, ar], j_b[bstar, ar]

    # point attributes from kf_new's view
    view1 = pts - O1
    dist1 = torch.clamp(torch.linalg.norm(view1, dim=-1), min=1e-9)
    max_dist = dist1 * scales[lvl1]
    m2, slots = add_points(
        m, pts, desc1, view1 / dist1[:, None], max_dist / scales[-1], max_dist,
        kf_new, ok_any,
    )
    created = slots >= 0
    pt_idx = m2.kf_pt_idx.clone()
    k1 = kf_new.reshape(1).to(torch.int64)
    pt_idx[k1] = torch.where(created, slots, pt_idx[k1][0]).unsqueeze(0)
    for b in range(n_nbrs):  # link each neighbor's matched features
        k2 = nbr_ids[b].clamp(min=0).reshape(1).to(torch.int64)
        tgt = torch.where(created & (bstar == b) & (nbr_ids[b] >= 0), j_sel, N)
        pt_idx[k2] = put(pt_idx[k2][0], tgt, slots).unsqueeze(0)
    return m2._replace(kf_pt_idx=pt_idx), created.sum()


def run_local_ba(
    m: MapState,
    cam: PinholeCamera,
    kf_id: torch.Tensor,
    cap: MapCapacity,
    caps: LocalBACaps = LocalBACaps(),
    covis_row: torch.Tensor | None = None,
    obs_bm: torch.Tensor | None = None,
) -> MapState:
    """Covisibility-local bundle adjustment (LocalBundleAdjustment):
    kf_id and its best covisible keyframes are optimized; keyframes
    outside that set that observe the chosen points join fixed, and so
    does slot 0 (the gauge). Outlier observations are detached.

    The points are chosen by relevance: the most local-window
    observations, kf_id's own observations counting 100 each; a stable
    sort orders ties lowest slot first, as jax.lax.top_k does.
    `covis_row` passes kf_id's [K] covisibility row; `obs_bm` the
    observer bitmap, from which the window's observation counts and the
    fixed keyframes' votes are then read."""
    K_cap, N = m.kf_pt_idx.shape
    P = m.pt_valid.shape[0]
    dev = m.kf_Tcw.device

    if covis_row is None:
        ids, w = best_covisible(m, kf_id, caps.n_local - 1)
    else:
        w, ids = top_k_stable(covis_row, min(caps.n_local - 1, K_cap))
    local_ids = torch.cat([kf_id.reshape(1).to(torch.int64), torch.where(w > 0, ids, -1)])
    lvalid = local_ids >= 0
    lids_safe = local_ids.clamp(min=0)
    local_mask = put(torch.zeros(K_cap, dtype=torch.bool, device=dev),
                     torch.where(lvalid, lids_safe, K_cap), True)

    if obs_bm is None:
        lpts = torch.where(lvalid[:, None], m.kf_pt_idx[lids_safe], -1)
        obs_weight = put_add(torch.zeros(P, device=dev),
                             torch.where(lpts >= 0, lpts, P).reshape(-1), 1.0)
    else:
        obs_weight = ((obs_bm > 0) & local_mask[None, :]).sum(1).to(torch.float32)
    own = take(m.kf_pt_idx, kf_id)
    obs_weight = put_add(obs_weight, torch.where(own >= 0, own, P), 100.0)
    obs_weight = torch.where(m.pt_valid, obs_weight, 0.0)
    sel_score, sel_pts = top_k_stable(obs_weight, caps.n_points)
    sel_valid = sel_score > 0.0
    sel_safe = torch.where(sel_valid, sel_pts, 0)
    inv_map = put(torch.full((P,), -1, dtype=torch.int64, device=dev),
                  torch.where(sel_valid, sel_pts, P),
                  torch.arange(caps.n_points, device=dev))

    # fixed keyframes: the most votes = selected points they observe
    if obs_bm is None:
        obs_sel = (
            (m.kf_pt_idx >= 0) & (inv_map[m.kf_pt_idx.clamp(min=0).to(torch.int64)] >= 0)
            & m.kf_kp_valid & m.kf_valid[:, None]
        )
        votes = obs_sel.sum(1, dtype=torch.int32)
    else:
        votes = ((obs_bm[sel_safe] > 0) & sel_valid[:, None]).sum(0, dtype=torch.int32)
    fixed_votes = torch.where(local_mask | ~m.kf_valid, 0, votes)
    fw, fixed_ids = top_k_stable(fixed_votes, caps.n_fixed)
    fixed_ids = torch.where(fw > 0, fixed_ids, -1)

    cam_ids = torch.cat([local_ids, fixed_ids])  # [C]
    C = cam_ids.shape[0]
    cam_ok = cam_ids >= 0
    cam_safe = cam_ids.clamp(min=0)
    cam_fixed = (torch.arange(C, device=dev) >= local_ids.shape[0]) | (cam_ids == 0) | ~cam_ok

    # observations: the features of the C cameras linked to selected
    # points, written onto the [Q, C] grid with one scatter
    kf_rows = m.kf_pt_idx[cam_safe]  # [C, N]
    q_idx = inv_map[kf_rows.clamp(min=0).to(torch.int64)]
    obs_ok = (kf_rows >= 0) & (q_idx >= 0) & m.kf_kp_valid[cam_safe] & cam_ok[:, None]
    uvr = torch.cat([m.kf_uv[cam_safe], m.kf_ur[cam_safe][..., None]], dim=-1)
    isig2 = 1.0 / level_tables(cap, dev)[1][m.kf_level[cam_safe].to(torch.int64)]
    Qb = caps.n_points
    cam_rows = torch.arange(C, device=dev)[:, None].expand(C, N)
    # a camera linking two features to one point writes one cell twice:
    # the later feature wins (utils.scatter.last_wins)
    cell = torch.where(obs_ok, q_idx * C + cam_rows, Qb * C).reshape(-1)
    grid4 = put(torch.zeros((Qb * C, 4), device=dev), cell,
                torch.cat([uvr, isig2[..., None]], dim=-1).reshape(-1, 4)).view(Qb, C, 4)
    gvalid = put(torch.zeros(Qb * C, dtype=torch.bool, device=dev), cell, True).view(Qb, C)
    # empty cells read (0, 0, -1): monocular, so they cannot enter
    # stereo terms
    guvr = torch.cat([
        torch.where(gvalid[..., None], grid4[..., :2], 0.0),
        torch.where(gvalid, grid4[..., 2], -1.0)[..., None],
    ], dim=-1)
    prob = GridBAProblem(
        cam_Tcw=m.kf_Tcw[cam_safe],
        cam_fixed=cam_fixed,
        pt_xyz=m.pt_xyz[sel_safe],
        pt_valid=sel_valid,
        obs_uvr=guvr,
        obs_isig2=grid4[..., 3],
        obs_valid=gvalid,
    )
    res = grid_bundle_adjust(prob, cam, iters1=caps.iters1, iters2=caps.iters2)

    # write back the optimized poses and points, detach the outliers
    upd_cam = cam_ok & ~cam_fixed
    new_Tcw = put(m.kf_Tcw, torch.where(upd_cam, cam_safe, K_cap), res.cam_Tcw)
    new_xyz = put(m.pt_xyz, torch.where(sel_valid, sel_pts, P), res.pt_xyz)
    inl = res.obs_inlier[q_idx.clamp(min=0), cam_rows]  # [C, N]
    rows = torch.where(obs_ok & ~inl, -1, kf_rows)
    new_pt_idx = put(m.kf_pt_idx, torch.where(cam_ok, cam_safe, K_cap), rows)
    return m._replace(kf_Tcw=new_Tcw, pt_xyz=new_xyz, kf_pt_idx=new_pt_idx)


def _kf_view(m: MapState, kf: torch.Tensor) -> FrameData:
    """A keyframe's features viewed as a FrameData."""
    return FrameData(
        uv=take(m.kf_uv, kf), uv_raw=take(m.kf_uv, kf), level=take(m.kf_level, kf),
        angle=take(m.kf_angle, kf), desc=take(m.kf_desc, kf),
        valid=take(m.kf_kp_valid, kf), ur=take(m.kf_ur, kf),
        depth=take(m.kf_depth, kf), timestamp=take(m.kf_timestamp, kf),
    )


#: the JAX package's cap on the kill list of its dense link sweep; the
#: port always takes the gather (see fuse_round)
FUSE_SWEEP_CAP = 1024


def fuse_round(
    m: MapState,
    cam: PinholeCamera,
    kf_new: torch.Tensor,
    nbr_ids: torch.Tensor,  # [B] covisible neighbors (-1 padding)
    obs_counts: torch.Tensor,  # [P] int32
    n_nbrs: int,
) -> tuple[MapState, torch.Tensor, torch.Tensor]:
    """SearchInNeighbors in both directions for all neighbors, then one
    map-wide Replace (ORBmatcher::Fuse radius 3, TH_LOW; the point with
    more observations wins, the lower slot on ties, and every link to a
    loser follows its winner). Direction 1 projects the neighbors'
    points into kf_new, direction 2 kf_new's points into each neighbor.
    Returns (map, n_fused, obs_counts').

    The map-wide link sweep is the gather rep2[kf_pt_idx], which drops
    every link to a dead slot, whether a loser of this round or a point
    culled earlier in the insert, so no dead-point mask is passed. The
    JAX package instead sweeps a dense [K*N, 1024] membership test when
    at most FUSE_SWEEP_CAP slots died, a workaround for slow gathers on
    the TPU that would be 786 M compares on the card, and takes the
    same gather above the cap. Under the map's invariant (no live link
    points at an invalid slot outside this insert's kill set) the two
    give the same links."""
    K, N = m.kf_pt_idx.shape
    P = m.pt_valid.shape[0]
    dev = m.kf_Tcw.device
    nbr_ok = nbr_ids >= 0
    nb = nbr_ids.clamp(min=0).to(torch.int64)

    def live(rows):  # links to invalid points count as vacant
        return torch.where((rows >= 0) & m.pt_valid[rows.clamp(min=0).to(torch.int64)],
                           rows, -1)

    # ---- direction 1: the neighbors' points -> the new keyframe
    rows_b = live(m.kf_pt_idx[nb])  # [B, N]
    cand_ok = ((rows_b >= 0) & m.kf_kp_valid[nb] & nbr_ok[:, None]).reshape(-1)
    cid = rows_b.clamp(min=0).reshape(-1).to(torch.int64)
    pm_f = search_by_projection(
        cam, take(m.kf_Tcw, kf_new),
        m.pt_xyz[cid], m.pt_desc[cid], cand_ok,
        m.pt_normal[cid], m.pt_min_dist[cid], m.pt_max_dist[cid],
        torch.where(cand_ok, rows_b.reshape(-1), -1), _kf_view(m, kf_new),
        radius=3.0, max_hamming=TH_LOW, check_view_cos=True,
    )
    q_f = pm_f.feat_pt  # [N]
    row_new = live(take(m.kf_pt_idx, kf_new))
    kp_new = take(m.kf_kp_valid, kf_new)
    adopt_f = (q_f >= 0) & (row_new < 0) & kp_new
    conflict_f = (q_f >= 0) & (row_new >= 0) & (row_new != q_f)

    # ---- direction 2: the new keyframe's points -> each neighbor
    own_ok = (row_new >= 0) & kp_new
    oid = row_new.clamp(min=0).to(torch.int64)
    o_ids = torch.where(own_ok, row_new, -1)
    q_r = torch.stack([
        search_by_projection(
            cam, take(m.kf_Tcw, nb[b]),
            m.pt_xyz[oid], m.pt_desc[oid], own_ok & nbr_ok[b],
            m.pt_normal[oid], m.pt_min_dist[oid], m.pt_max_dist[oid],
            o_ids, _kf_view(m, nb[b]),
            radius=3.0, max_hamming=TH_LOW, check_view_cos=True,
        ).feat_pt
        for b in range(n_nbrs)
    ])  # [B, N]
    adopt_r = (q_r >= 0) & (rows_b < 0) & m.kf_kp_valid[nb] & nbr_ok[:, None]
    conflict_r = (q_r >= 0) & (rows_b >= 0) & (rows_b != q_r) & nbr_ok[:, None]

    # ---- one winner/loser pass over all conflicts; the winner relation
    # is a total order (count, then slot), so the two directions of one
    # duplicate pair never erase both points
    c_mask = torch.cat([conflict_f, conflict_r.reshape(-1)])
    qs = torch.cat([q_f, q_r.reshape(-1)]).clamp(min=0).to(torch.int64)
    rs = torch.cat([row_new, rows_b.reshape(-1)]).clamp(min=0).to(torch.int64)
    oq, orr = obs_counts[qs], obs_counts[rs]
    q_wins = (oq > orr) | ((oq == orr) & (qs < rs))
    winner = torch.where(q_wins, qs, rs)
    loser = torch.where(c_mask, torch.where(q_wins, rs, qs), P)

    # a loser with two winners is written twice: the later conflict
    # wins (utils.scatter.last_wins)
    rep = put(torch.arange(P, device=dev), loser, winner)
    lose_mask = put(torch.zeros(P, dtype=torch.bool, device=dev), loser, True)
    pt_valid = m.pt_valid & ~lose_mask
    # a replacement target that itself died maps to -1
    rep2 = torch.where(pt_valid[rep], rep, -1)

    linked = m.kf_pt_idx >= 0
    new_idx = torch.where(
        linked, rep2[m.kf_pt_idx.clamp(min=0).to(torch.int64)], -1
    ).to(torch.int32)
    # adopted links also follow the replacement table
    k1 = kf_new.reshape(1).to(torch.int64)
    new_idx[k1] = torch.where(adopt_f, rep2[q_f.clamp(min=0).to(torch.int64)],
                              new_idx[k1][0]).to(torch.int32).unsqueeze(0)
    for b in range(n_nbrs):
        r = new_idx[nb[b:b + 1]][0]
        adopt = adopt_r[b] & nbr_ok[b]
        new_idx[nb[b:b + 1]] = torch.where(
            adopt, rep2[q_r[b].clamp(min=0).to(torch.int64)], r
        ).to(torch.int32).unsqueeze(0)
    n_erased = (lose_mask & m.pt_valid).sum(dtype=torch.int32)
    m2 = m._replace(kf_pt_idx=new_idx, pt_valid=pt_valid, n_pt=m.n_pt - n_erased)

    # counts: winners absorb their (deduplicated) losers, losers go to
    # 0, adopted points gain one
    new_obs = put_add(obs_counts, torch.where(lose_mask, rep, P),
                      torch.where(lose_mask, obs_counts, 0))
    new_obs = torch.where(lose_mask, 0, new_obs)
    tgt_f = rep2[q_f.clamp(min=0).to(torch.int64)]
    new_obs = put_add(new_obs, torch.where(adopt_f & (tgt_f >= 0), tgt_f, P), 1)
    tgt_r = rep2[q_r.clamp(min=0).to(torch.int64)]
    new_obs = put_add(new_obs, torch.where(adopt_r & (tgt_r >= 0), tgt_r, P).reshape(-1), 1)
    n = c_mask.sum() + adopt_f.sum() + adopt_r.sum()
    return m2, n, new_obs


def cull_keyframes(
    m: MapState,
    kf_id: torch.Tensor,
    n_levels: int = 8,
    redundancy: float = 0.9,
    covis_row: torch.Tensor | None = None,
    lvl_bm: torch.Tensor | None = None,
    enable: torch.Tensor | None = None,
) -> tuple[MapState, torch.Tensor]:
    """Erase at most one redundant covisible keyframe of kf_id
    (KeyFrameCulling): one whose tracked points are >90% observed by
    >= 3 other keyframes at the same or a finer scale (level <= l + 1),
    never slot 0 or kf_id. Points whose reference keyframe it was move
    to their first surviving observer.

    `covis_row` passes kf_id's [K] covisibility row; `lvl_bm` a fresh
    [P, K] level bitmap (level + 1, 0 unobserved) from which the counts
    are dense reductions. The erase is computed whether or not a
    keyframe qualifies and selected field by field, where the JAX
    package branches. Returns (map, culled slot or -1)."""
    K, N = m.kf_pt_idx.shape
    P = m.pt_valid.shape[0]
    L = n_levels
    dev = m.kf_Tcw.device
    ar = torch.arange(K, device=dev)

    if lvl_bm is None:
        linked = (m.kf_pt_idx >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
        pt = m.kf_pt_idx.clamp(min=0).to(torch.int64)
        lvl = m.kf_level.clamp(0, L - 1).to(torch.int64)
        # per-(point, level) counts, then a prefix over the levels
        flat = torch.where(linked, pt, P) * L + lvl
        cnt = torch.zeros((P + 1) * L, dtype=torch.int32, device=dev)
        cnt.index_add_(0, flat.reshape(-1), torch.ones(K * N, dtype=torch.int32, device=dev))
        cum = cnt.view(P + 1, L).cumsum(1)
        n_sf = cum[pt, (lvl + 1).clamp(max=L - 1)]  # includes this observation
        n_tracked = linked.sum(1)
        n_red = (linked & (n_sf - 1 >= 3)).sum(1)
    else:
        masked = torch.where(m.kf_valid[None, :], lvl_bm, 0)  # [P, K]
        seen = masked > 0
        # cum[p, l] = observers of p at level <= l
        cum = torch.stack(
            [(seen & (masked <= l + 1)).sum(1, dtype=torch.int32) for l in range(L)], 1
        )
        gate = masked.to(torch.int64).clamp(max=L - 1)  # level + 1, capped
        n_sf = cum.gather(1, gate)
        n_tracked = seen.sum(0)
        n_red = (seen & (n_sf - 1 >= 3)).sum(0)
    kf_redundant = (
        (n_red.to(torch.float32) > redundancy * n_tracked.to(torch.float32))
        & (n_tracked > 0)
    )
    w = covisibility_weights(m, kf_id.reshape(1))[0] if covis_row is None else covis_row
    cand = kf_redundant & (w >= 15) & m.kf_valid & (ar != kf_id) & (ar != 0)
    score = torch.where(
        cand, n_red.to(torch.float32) / torch.clamp(n_tracked.to(torch.float32), min=1.0),
        -1.0,
    )
    victim = torch.argmax(score)
    any_cand = cand.any()
    if enable is not None:
        any_cand = any_cand & enable

    m_culled = erase_keyframe(m, victim)
    # the first surviving observer of each point
    if lvl_bm is None:
        linked2 = (m_culled.kf_pt_idx >= 0) & m_culled.kf_kp_valid
        flat2 = torch.where(linked2, m_culled.kf_pt_idx.clamp(min=0), P).reshape(-1)
        first_obs = torch.full((P + 1,), K, dtype=torch.int64, device=dev)
        first_obs.scatter_reduce_(0, flat2.to(torch.int64), ar.repeat_interleave(N), "amin")
        first_obs = first_obs[:P]
    else:
        surv = (lvl_bm > 0) & m_culled.kf_valid[None, :]  # [P, K]
        # argmax returns the first maximum; bool input is not supported
        first_obs = torch.where(surv.any(1), torch.argmax(surv.to(torch.uint8), 1), K)
    orphan = (m_culled.pt_ref_kf == victim) & m_culled.pt_valid
    new_ref = torch.where(orphan, torch.where(first_obs < K, first_obs, -1),
                          m_culled.pt_ref_kf).to(torch.int32)
    m_out = select(any_cand, m_culled._replace(pt_ref_kf=new_ref), m)
    return m_out, torch.where(any_cand, victim, -1).to(torch.int32)


def cull_points(
    m: MapState,
    current_kf: torch.Tensor,
    obs_counts: torch.Tensor | None = None,
    detach: bool = True,
):
    """MapPointCulling: drop points with a found ratio < 0.25, and points
    >= 2 keyframe insertions old with fewer than 2 observations. Age is
    the rank of the current keyframe's frame id among the live
    keyframes' minus that of the point's creating frame id (slots are
    recycled; frame ids are monotone).

    `obs_counts` passes [P] observation counts. detach=True returns the
    map with the culled points' links cleared; detach=False returns
    (map, obs_counts', culled [P]) with links left for a later sweep
    (fuse_round's)."""
    obs_n = observation_counts(m) if obs_counts is None else obs_counts
    found_ratio = m.pt_found / torch.clamp(m.pt_visible, min=1.0)
    now = take(m.kf_frame_id, current_kf.clamp(min=0))
    live_fid = torch.where(m.kf_valid, m.kf_frame_id, torch.iinfo(torch.int32).max)
    rank_now = (live_fid <= now).sum(dtype=torch.int32)
    rank_first = (live_fid[None, :] <= m.pt_first_kf[:, None]).sum(1, dtype=torch.int32)
    age = rank_now - rank_first
    bad = m.pt_valid & ((found_ratio < 0.25) | ((age >= 2) & (obs_n < 2)))
    n_pt = m.n_pt - bad.sum(dtype=torch.int32)
    if not detach:
        m2 = m._replace(pt_valid=m.pt_valid & ~bad, n_pt=n_pt)
        return m2, torch.where(bad, 0, obs_n), bad
    obs_bad = (m.kf_pt_idx >= 0) & bad[m.kf_pt_idx.clamp(min=0).to(torch.int64)]
    return m._replace(
        pt_valid=m.pt_valid & ~bad,
        kf_pt_idx=torch.where(obs_bad, -1, m.kf_pt_idx),
        n_pt=n_pt,
    )
