"""Augmented-reality overlay (reference Examples/ROS/ORB_SLAM2/AR/
ViewerAR.cc + ros_mono_ar.cc: detect the dominant plane among tracked
map points, anchor a virtual cube on it, render it over the camera
frame).

A copy of orb_slam2_test_tpu/viz/ar.py (numpy; OpenCV only to draw),
plus `tracked_world_points`, which the JAX package keeps in its AR
example. The reference fits the plane with its own mini-RANSAC over the
currently tracked map points and draws the cube with Pangolin GL; here
the fit is a vectorized-hypothesis RANSAC (all hypotheses scored at
once) and the cube is line-rendered with OpenCV, headless.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from orb_slam2_test_tpu_torch.viz.frame_drawer import host_array


def tracked_world_points(tracker) -> torch.Tensor:
    """World positions [n, 3] of the live map points matched in the
    Tracker's current frame (what ViewerAR.cc collects through
    GetTrackedMapPoints), on the tracker's device."""
    if tracker.cur_feat_pt is None:
        return torch.zeros((0, 3), device=tracker.map.pt_xyz.device)
    ids = tracker.cur_feat_pt
    ids = ids[ids >= 0].to(torch.int64)
    return tracker.map.pt_xyz[ids][tracker.map.pt_valid[ids]]


class Plane(NamedTuple):
    normal: np.ndarray  # [3] unit
    d: float            # plane: n.x + d = 0
    origin: np.ndarray  # [3] anchor point on the plane (inlier centroid)
    R_wp: np.ndarray    # [3,3] plane->world rotation (z = normal)
    n_inliers: int


def fit_plane_ransac(
    pts: np.ndarray,
    iters: int = 200,
    thresh: float = 0.02,
    min_inliers: int = 20,
    rng: Optional[np.random.Generator] = None,
) -> Optional[Plane]:
    """Dominant-plane RANSAC over tracked map points.

    Mirrors ViewerAR.cc Plane::Recompute/DetectPlane: 3-point
    hypotheses, inlier threshold relative to scene scale, refit on
    inliers. Vectorized: all `iters` hypotheses are formed and scored
    in one shot. `pts` may be a tensor on any device (read back here).
    """
    pts = host_array(pts).astype(np.float64)
    n = len(pts)
    if n < max(3 * 3, min_inliers):
        return None
    rng = rng or np.random.default_rng(0)

    # scale-adaptive threshold like the reference (its th is relative
    # to the median point-to-centroid distance of the tracked set)
    c = pts.mean(axis=0)
    scale = np.median(np.linalg.norm(pts - c, axis=1)) + 1e-12
    th = thresh * scale

    idx = rng.integers(0, n, size=(iters, 3))
    p0, p1, p2 = pts[idx[:, 0]], pts[idx[:, 1]], pts[idx[:, 2]]
    nrm = np.cross(p1 - p0, p2 - p0)  # [iters, 3]
    ln = np.linalg.norm(nrm, axis=1, keepdims=True)
    ok = ln[:, 0] > 1e-12
    nrm = np.where(ok[:, None], nrm / np.maximum(ln, 1e-12), 0.0)
    d = -(nrm * p0).sum(axis=1)  # [iters]

    # distance of every point to every hypothesis: [iters, n]
    dist = np.abs(nrm @ pts.T + d[:, None])
    inl = (dist < th) & ok[:, None]
    scores = inl.sum(axis=1)
    best = int(np.argmax(scores))
    if scores[best] < min_inliers:
        return None

    # refit on inliers: plane normal = smallest singular vector
    P = pts[inl[best]]
    c = P.mean(axis=0)
    _, _, Vt = np.linalg.svd(P - c, full_matrices=False)
    normal = Vt[-1]
    # orient the normal toward the camera side (-z convention: points
    # in front of a camera at origin have positive depth; pick the
    # hemisphere facing the origin like the reference does vs twc)
    if normal @ c > 0:
        normal = -normal
    dd = -float(normal @ c)

    # plane->world frame: z along normal, x/y spanning the plane
    a = np.array([1.0, 0.0, 0.0])
    if abs(normal @ a) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    x = np.cross(a, normal)
    x /= np.linalg.norm(x)
    y = np.cross(normal, x)
    R_wp = np.stack([x, y, normal], axis=1)
    return Plane(normal=normal.astype(np.float64), d=dd, origin=c,
                 R_wp=R_wp, n_inliers=int(scores[best]))


def cube_vertices(plane: Plane, size: float) -> np.ndarray:
    """[8, 3] world-space corners of a cube of edge `size` sitting on
    the plane at its anchor point."""
    s = size / 2.0
    local = np.array(
        [
            [-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0],
            [-s, -s, 2 * s], [s, -s, 2 * s], [s, s, 2 * s],
            [-s, s, 2 * s],
        ],
        np.float64,
    )
    return plane.origin + local @ plane.R_wp.T


_CUBE_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def draw_ar_frame(
    img: np.ndarray,
    Tcw: np.ndarray,
    cam,
    plane: Optional[Plane],
    cube_size: float = 0.1,
    tracked_uv: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Overlay the virtual cube (and optionally tracked keypoints) on a
    grayscale frame; returns BGR uint8."""
    import cv2

    rgb = cv2.cvtColor(
        np.clip(img, 0, 255).astype(np.uint8), cv2.COLOR_GRAY2BGR
    )
    if tracked_uv is not None:
        for u, v in np.asarray(tracked_uv, int):
            cv2.circle(rgb, (u, v), 2, (80, 200, 80), -1)
    if plane is None:
        cv2.putText(rgb, "AR: looking for plane...", (8, 20),
                    cv2.FONT_HERSHEY_PLAIN, 1.0, (0, 200, 255), 1)
        return rgb

    V = cube_vertices(plane, cube_size)
    Tcw = np.asarray(Tcw, np.float64)
    Vc = V @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = Vc[:, 2]
    if np.any(z <= 1e-6):
        return rgb
    u = cam.fx * Vc[:, 0] / z + cam.cx
    v = cam.fy * Vc[:, 1] / z + cam.cy
    uv = np.stack([u, v], axis=1).astype(int)
    for i, j in _CUBE_EDGES:
        color = (0, 0, 230) if (i < 4 and j < 4) else (230, 120, 0)
        cv2.line(rgb, tuple(uv[i]), tuple(uv[j]), color, 2,
                 cv2.LINE_AA)
    return rgb
