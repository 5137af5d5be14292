"""Covisibility as reductions over the observation array and the
point -> observer bitmap.

Port of orb_slam2_test_tpu/slam_map/covisibility.py (reference:
KeyFrame::UpdateConnections, MapPoint::GetObservations). Weights are
derived from `kf_pt_idx` or the bitmap on demand, never maintained
incrementally. The full [K, K] matrix (the essential graph's strong
edges) is one [K, P] x [P, K] product of the observation indicator.
"""

from __future__ import annotations

import torch

from orb_slam2_test_tpu_torch.ops.extractor import top_k_stable
from orb_slam2_test_tpu_torch.slam_map.mapstate import MapState
from orb_slam2_test_tpu_torch.utils.scatter import last_wins, put_add, put_row, take

# reference: KeyFrame::UpdateConnections threshold `th = 15`
COVIS_THRESHOLD = 15


def _linked(m: MapState) -> torch.Tensor:
    """[K, N] feature links that count: a live keyframe's valid feature
    with a point."""
    return (m.kf_pt_idx >= 0) & m.kf_kp_valid & m.kf_valid[:, None]


def observation_counts(m: MapState) -> torch.Tensor:
    """[P] int32, the number of keyframe observations of each point
    (MapPoint::Observations())."""
    P = m.pt_valid.shape[0]
    flat = torch.where(_linked(m), m.kf_pt_idx, P).reshape(-1)
    return put_add(torch.zeros(P, dtype=torch.int32, device=flat.device), flat, 1)


def observation_indicator(m: MapState, dtype=torch.float32) -> torch.Tensor:
    """[K, P] 0/1 matrix: keyframe k observes point p. Unlinked features
    write into a sentinel column P that is cut off."""
    K, N = m.kf_pt_idx.shape
    P = m.pt_valid.shape[0]
    col = torch.where(_linked(m), m.kf_pt_idx, P).to(torch.int64)
    flat = torch.arange(K, device=col.device)[:, None] * (P + 1) + col
    ind = torch.zeros(K * (P + 1), dtype=dtype, device=col.device)
    ind.index_fill_(0, flat.reshape(-1), 1.0)
    return ind.view(K, P + 1)[:, :P]


def covisibility_weights(m: MapState, query_kf: torch.Tensor | None = None) -> torch.Tensor:
    """Covisibility weights, int32: weight[q, j] = number of the query
    keyframe's observations whose point keyframe j also observes (0 at
    j = q).

    query_kf None: the full [K, K] matrix, one [K, P] x [P, K] product
    of the observation indicator. Its entries are counts <= N, exact in
    float32 with float32 accumulation (TF32 stays off,
    `utils.precision.f32_matmuls`).
    query_kf [Q]: [Q, K] rows, one [P] indicator per query and one
    [K, N] gather-sum."""
    K = m.kf_valid.shape[0]
    if query_kf is None:
        ind = observation_indicator(m)
        w = ind @ ind.T
        eye = torch.eye(K, dtype=torch.bool, device=w.device)
        return torch.where(eye, 0.0, w).to(torch.int32)
    P = m.pt_valid.shape[0]
    linked = _linked(m)
    q = query_kf.to(torch.int64)
    rows = torch.where(linked[q], m.kf_pt_idx[q], P).to(torch.int64)  # [Q, N]
    ind = torch.zeros((q.shape[0], P + 1), device=rows.device)
    ind.scatter_(1, rows, 1.0)
    pt = m.kf_pt_idx.clamp(min=0).to(torch.int64)
    votes = torch.where(linked, ind[:, pt], 0.0).sum(-1)  # [Q, K]
    votes = torch.where(torch.arange(K, device=q.device) == q[:, None], 0.0, votes)
    return votes.to(torch.int32)


def best_covisible(
    m: MapState, kf_id: torch.Tensor, top_n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The top_n most covisible keyframes of kf_id
    (KeyFrame::GetBestCovisibilityKeyFrames), tied weights lowest slot
    first. Returns (kf_ids [top_n] int64, -1 where the weight is 0,
    weights [top_n])."""
    w = covisibility_weights(m, kf_id.reshape(1))[0]
    weights, ids = top_k_stable(w, top_n)
    return torch.where(weights > 0, ids, -1), weights


def assign_parent(
    m: MapState, kf_id: torch.Tensor, covis_row: torch.Tensor | None = None
) -> MapState:
    """Set kf_id's spanning-tree parent to its most covisible live
    keyframe, the lowest slot on ties (UpdateConnections, first
    connection). No-op if it has a parent or shares no point."""
    if covis_row is None:
        covis_row = covisibility_weights(m, kf_id.reshape(1))[0]
    K = m.kf_valid.shape[0]
    eligible = m.kf_valid & (torch.arange(K, device=kf_id.device) != kf_id)
    w = torch.where(eligible, covis_row.to(torch.float32), -1.0)
    best = torch.argmax(w)
    parent = take(m.kf_parent, kf_id)
    assign = (parent < 0) & (take(w, best) > 0)
    new_parent = torch.where(assign, best.to(torch.int32), parent)
    return m._replace(kf_parent=put_row(m.kf_parent, kf_id, new_parent))


def add_loop_edge(m: MapState, kf_a: torch.Tensor, kf_b: torch.Tensor) -> MapState:
    """Record a loop-closure edge between two keyframes, both ways
    (KeyFrame::AddLoopEdge); 0-d index tensors, no host read."""
    le = put_row(m.kf_loop_edge, kf_a, kf_b.to(m.kf_loop_edge.dtype))
    return m._replace(kf_loop_edge=put_row(le, kf_b, kf_a.to(le.dtype)))


def build_observer_bitmap(m: MapState) -> torch.Tensor:
    """[P, K] uint8: the pyramid level + 1 of keyframe k's observation
    of point p, 0 where k does not observe p.

    When one keyframe links two of its features to one point, two
    writes hit one cell and the later feature's level wins
    (`utils.scatter.last_wins`). Unlinked features write into a sentinel
    row P that is cut off, as `mode="drop"` does in the JAX package."""
    K, N = m.kf_pt_idx.shape
    P = m.pt_valid.shape[0]
    pid = torch.where(_linked(m), m.kf_pt_idx, P).to(torch.int64)
    bm = torch.zeros((P + 1, K), dtype=torch.uint8, device=pid.device)
    write_levels(bm, pid, torch.arange(K, device=pid.device)[:, None].expand(K, N),
                 m.kf_level)
    return bm[:P]


def write_levels(bm: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                 level: torch.Tensor) -> None:
    """bm[rows, cols] = level + 1 in place on a [P + 1, K] uint8 bitmap;
    rows equal to P are dropped, and of repeated cells the last write
    wins."""
    P, K = bm.shape[0] - 1, bm.shape[1]
    rows = rows.to(torch.int64)
    flat = torch.where(rows < P, rows * K + cols, P * K).reshape(-1)
    bm.view(-1)[last_wins(flat, P * K)] = (
        (level.clamp(0, 254) + 1).to(torch.uint8).reshape(-1))


def covis_row_from_bitmap(
    m: MapState, bitmap: torch.Tensor, kf_id: torch.Tensor
) -> torch.Tensor:
    """kf_id's [K] int32 covisibility row from the observer bitmap: one
    [N, K] gather. Counts as covisibility_weights does."""
    row = take(m.kf_pt_idx, kf_id)
    ok = (row >= 0) & take(m.kf_kp_valid, kf_id)
    seen = bitmap[row.clamp(min=0).to(torch.int64)] > 0  # [N, K]
    w = (seen & ok[:, None]).sum(0, dtype=torch.int32)
    w = torch.where(m.kf_valid, w, 0)
    return put_row(w, kf_id, torch.zeros((), dtype=w.dtype, device=w.device))
