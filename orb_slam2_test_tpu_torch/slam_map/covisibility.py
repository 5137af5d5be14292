"""Point -> observer-keyframe incidence, as a dense bitmap.

Port of `build_observer_bitmap` from
orb_slam2_test_tpu/slam_map/covisibility.py (reference:
MapPoint::GetObservations, read by Tracking::UpdateLocalKeyFrames).
The rest of the module (covisibility weights, spanning-tree parents)
belongs to keyframe insertion and is not ported yet.
"""

from __future__ import annotations

import torch

from orb_slam2_test_tpu_torch.slam_map.mapstate import MapState


def build_observer_bitmap(m: MapState) -> torch.Tensor:
    """[P, K] uint8: the pyramid level + 1 of keyframe k's observation
    of point p, 0 where k does not observe p.

    Consumers read only `bitmap > 0`. When one keyframe links two of its
    features to one point, two writes hit one cell and which level wins
    is unspecified (in XLA as here); incidence is exact either way.
    Unlinked features write into a sentinel row P that is cut off, as
    `mode="drop"` does in the JAX package."""
    K, N = m.kf_pt_idx.shape
    P = m.pt_valid.shape[0]
    linked = (m.kf_pt_idx >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    pid = torch.where(linked, m.kf_pt_idx, P).to(torch.int64)
    kf_of = torch.arange(K, device=pid.device)[:, None].expand(K, N)
    lvl1 = (m.kf_level.clamp(0, 254) + 1).to(torch.uint8)
    bm = torch.zeros((P + 1) * K, dtype=torch.uint8, device=pid.device)
    bm[(pid * K + kf_of).reshape(-1)] = lvl1.reshape(-1)
    return bm.view(P + 1, K)[:P]
