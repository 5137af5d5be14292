"""The per-frame tracking step, and the scenes that drive it.

`tracking_step` is the port of `__graft_entry__.tracking_step`: ORB
extraction, projection matching of a local map, and motion-only BA,
the hot path that runs at frame rate. On CUDA tensors it goes through
both hand-written kernels (8 patch-gather launches for the 8 pyramid
levels, one pose-optimization launch); on CPU tensors through their
plain versions.

`state_from_numpy` carries a map and a pose given as the JAX package's
numpy arrays onto a device; `consistent_scene` builds a map that a
frame really observes, so that matches exist and the pose problem is
real; `example_scene` puts the two together on a seeded texture.
`pose_problem` is a standalone motion-only BA problem for kernel 2.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_test_tpu_torch.engine.frame import build_frame_mono
from orb_slam2_test_tpu_torch.engine.matchers import search_by_projection
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.geometry.se3 import se3_exp
from orb_slam2_test_tpu_torch.solvers.pose_opt import pose_optimization
from orb_slam2_test_tpu_torch.utils.precision import f32_matmuls

# TUM freiburg1 intrinsics at 640x480 (configs/TUM1.yaml, undistorted)
CAM = PinholeCamera(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480)
N_FEATURES = 1000
N_PTS = 2048
SCALE_FACTOR = 1.2
N_LEVELS = 8
# the map's true pose, and the prediction error of example_scene:
# about 3 cm and 0.27 degrees
XI_TRUE = (0.1, -0.05, 0.2, 0.02, -0.03, 0.01)
XI_PRED_ERROR = (0.02, -0.015, 0.015, 0.003, -0.003, 0.002)


def tracking_step(
    img: torch.Tensor,  # [H, W] uint8 or float
    pts_xyz: torch.Tensor,  # [P, 3] float32
    pts_desc: torch.Tensor,  # [P, 8] int32 bit patterns
    pts_valid: torch.Tensor,  # [P] bool
    pts_normal: torch.Tensor,  # [P, 3] float32
    pts_mind: torch.Tensor,  # [P] float32
    pts_maxd: torch.Tensor,  # [P] float32
    Tcw_pred: torch.Tensor,  # [4, 4] float32
    cam: PinholeCamera = CAM,
    n_features: int = N_FEATURES,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One tracking step: ORB extract -> project the local map -> match
    -> motion-only BA. Returns (Tcw [4, 4], n_inliers [] int32)."""
    f32_matmuls()
    frame = build_frame_mono(img, 0.0, cam, n_features=n_features)
    P = pts_xyz.shape[0]
    pm = search_by_projection(
        cam, Tcw_pred, pts_xyz, pts_desc, pts_valid, pts_normal,
        pts_mind, pts_maxd,
        torch.arange(P, dtype=torch.int32, device=pts_xyz.device), frame,
        radius=15.0,
    )
    has = pm.feat_pt >= 0
    X = pts_xyz[pm.feat_pt.clamp(min=0).to(torch.int64)]
    uvr = torch.cat([frame.uv, frame.ur[:, None]], dim=-1)
    isig2 = 1.0 / (SCALE_FACTOR ** frame.level.to(torch.float32)) ** 2
    res = pose_optimization(cam, Tcw_pred, X, uvr, isig2, has & frame.valid)
    return res.Tcw, res.n_inliers


def state_from_numpy(
    img, pts_xyz, pts_desc, pts_valid, pts_normal, pts_mind, pts_maxd, Tcw,
    device: torch.device | str = "cpu",
) -> tuple[torch.Tensor, ...]:
    """The arguments of `tracking_step`, from the JAX package's layouts
    as numpy (descriptors uint32 [P, 8]) to the port's tensors on
    `device` (descriptors viewed as int32). The image keeps its dtype."""
    def f32(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    desc = np.array(pts_desc, np.uint32).view(np.int32)
    return (
        torch.from_numpy(np.array(img)).to(device),
        f32(pts_xyz),
        torch.from_numpy(desc).to(device),
        torch.from_numpy(np.array(pts_valid, bool)).to(device),
        f32(pts_normal),
        f32(pts_mind),
        f32(pts_maxd),
        f32(Tcw),
    )


def consistent_scene(
    rng: np.random.Generator,
    frame_np,
    cam: PinholeCamera,
    n_pts: int,
    T_true: np.ndarray,
    scale_factor: float = SCALE_FACTOR,
    n_levels: int = N_LEVELS,
) -> tuple[np.ndarray, ...]:
    """A local map that the frame observes from pose T_true.

    `frame_np` has numpy fields uv, level, desc, valid (a frame moved
    to the host). Each valid keypoint is back-projected at a depth drawn
    from U(4, 10) m and carries the keypoint's own descriptor; the
    distance range follows MapPoint::UpdateNormalAndDepth (max = dist *
    scale^level, min = max / scale^(n_levels-1)), so PredictScale gives
    back the keypoint's level. Slots past the keypoints are padding with
    valid=False.

    Returns (pts_xyz, pts_desc uint32, pts_valid, pts_normal, pts_mind,
    pts_maxd) in the JAX package's layouts, for `state_from_numpy`.
    """
    uv = np.asarray(frame_np.uv, np.float64)
    level = np.asarray(frame_np.level)
    desc = np.ascontiguousarray(frame_np.desc).view(np.uint32)
    idx = np.flatnonzero(np.asarray(frame_np.valid))[:n_pts]
    k = idx.size

    d = rng.uniform(4.0, 10.0, k)
    pc = np.stack(
        [(uv[idx, 0] - cam.cx) / cam.fx * d, (uv[idx, 1] - cam.cy) / cam.fy * d, d],
        axis=1,
    )
    R = np.asarray(T_true, np.float64)[:3, :3]
    t = np.asarray(T_true, np.float64)[:3, 3]
    Xw = (pc - t) @ R  # R^T (pc - t), row-wise
    view = Xw + R.T @ t  # Xw - Ow with Ow = -R^T t
    dist = np.linalg.norm(view, axis=1)
    maxd = dist * scale_factor ** level[idx].astype(np.float64)

    xyz = np.zeros((n_pts, 3), np.float32)
    normal = np.zeros((n_pts, 3), np.float32)
    mind = np.zeros(n_pts, np.float32)
    maxd_out = np.zeros(n_pts, np.float32)
    desc_out = np.zeros((n_pts, 8), np.uint32)
    valid = np.zeros(n_pts, bool)
    xyz[:k] = Xw
    normal[:k] = view / dist[:, None]
    maxd_out[:k] = maxd
    mind[:k] = maxd / scale_factor ** (n_levels - 1)
    desc_out[:k] = desc[idx]
    valid[:k] = True
    return xyz, desc_out, valid, normal, mind, maxd_out


def texture_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Seeded uint8 [h, w] texture: uniform noise summed at 1, 4 and 16
    pixel scales, so every pyramid level has corners."""
    img = np.zeros((h, w), np.float64)
    for cell, amp in ((1, 0.5), (4, 0.3), (16, 0.2)):
        g = rng.uniform(0, 255, (h // cell + 1, w // cell + 1))
        img += amp * np.kron(g, np.ones((cell, cell)))[:h, :w]
    return np.clip(img, 0, 255).astype(np.uint8)


def example_scene(
    rng: np.random.Generator,
    device: torch.device | str = "cpu",
    cam: PinholeCamera = CAM,
    n_features: int = N_FEATURES,
    n_pts: int = N_PTS,
):
    """A seeded image, a local map its frame observes from T_true, and a
    prediction T_pred off by XI_PRED_ERROR. The frame that seeds the map
    is built on `device`. Returns (img uint8, scene, T_true, T_pred)
    with `scene` as `consistent_scene` returns it."""
    img = texture_image(rng, cam.height, cam.width)
    frame = build_frame_mono(
        torch.from_numpy(img).to(device), 0.0, cam, n_features=n_features
    )
    frame_np = type(frame)(*[x.cpu().numpy() for x in frame])
    T_true = se3_exp(torch.tensor(XI_TRUE)).numpy()
    T_pred = se3_exp(torch.tensor(XI_PRED_ERROR)).numpy() @ T_true
    scene = consistent_scene(rng, frame_np, cam, n_pts, T_true)
    return img, scene, T_true, T_pred


def pose_problem(
    rng: np.random.Generator,
    n_obs: int = 1000,
    stereo_frac: float = 0.5,
    outlier_frac: float = 0.1,
):
    """The motion-only BA problem of tests/test_pallas_kernels.py, with
    n_obs observations: points at depths 4-10 m seen from T_true with
    0.5 px noise, the first stereo_frac of them stereo, outlier_frac of
    them moved 20-60 px, and a start pose off by ~16 cm. Returns (cam,
    T_true, T0, X, obs) as numpy, cam with bf = 40."""
    cam = PinholeCamera(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                        width=640, height=480, bf=40.0)
    X = np.concatenate(
        [rng.uniform(-3, 3, (n_obs, 2)), rng.uniform(4, 10, (n_obs, 1))], 1
    ).astype(np.float32)
    T_true = se3_exp(torch.tensor(XI_TRUE)).numpy()
    pc = X @ T_true[:3, :3].T + T_true[:3, 3]
    u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
    v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
    ur = u - cam.bf / pc[:, 2]
    obs = np.stack([u, v, ur], 1).astype(np.float32)
    obs[:, :2] += rng.normal(0, 0.5, (n_obs, 2))
    obs[int(n_obs * stereo_frac):, 2] = -1.0
    n_out = int(n_obs * outlier_frac)
    idx = rng.choice(n_obs, n_out, replace=False)
    obs[idx, :2] += rng.uniform(20, 60, (n_out, 2))
    T0 = se3_exp(torch.tensor([0.05, 0.0, 0.15, 0.0, 0.0, 0.0])).numpy()
    return cam, T_true, T0, X, obs
