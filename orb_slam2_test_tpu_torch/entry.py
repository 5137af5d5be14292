"""The per-frame tracking step, the keyframe insertion, and the scenes
that drive them.

Entry points:

- `track_frame_step` runs one stereo frame through the whole per-frame
  program, `engine.tracking._build_and_track_device(sensor="stereo")`,
  at the KITTI configuration of the JAX package's bench (`KITTI_CAM`,
  `KITTI_CFG`): 3 launches of kernel 1 (every level of the left ORB,
  of the right ORB, and of both SAD sides) and 2 of kernel 2 (motion
  model, local map).
- `grow_map_step` inserts a tracked stereo frame as a keyframe through
  `engine.tracking._grow_map_device`, as the bench's `grow` does: depth
  points with the close gate, a full insert (rebuild=True: fresh
  observer bitmap and a keyframe cull) or a light one. It launches
  neither kernel.
- `tracking_step` is the port of `__graft_entry__.tracking_step`: ORB
  extraction, projection matching of a local map, and motion-only BA,
  the mono hot path of slice 1.
- `sequence_step` tracks one stereo frame of a sequence through
  `System.track_stereo`: the host Tracker's whole decision (fused
  program, keyframe decision, insert) on a map it built itself.
- `dryrun_multichip` is the port of `__graft_entry__.dryrun_multichip`:
  the distributed BA on a sharded KITTI-scale synthetic problem and a
  data-parallel ORB frontend (kernel 1), on the BA mesh.

Scenes: `kitti_scene` builds a stereo pair and a map at KITTI capacity
that the frame really observes; `kitti_insert_scene` three views of four
planes, 1.07 m apart, for track -> insert -> track -> insert;
`bench_map` is the bench's random map filling. `map_from_numpy` and
`map_to_numpy` carry a map between the JAX package's numpy layouts and
the port's tensors, `frame_from_numpy` a frame and
`vocabulary_from_numpy` a vocabulary, `ba_problem_from_numpy` a bundle
problem and its camera; `kitti_multi_sequence` gives the concurrent
multi-sequence path its sequences; `state_from_numpy`, `consistent_scene`,
`example_scene` and `pose_problem` serve the mono step and kernel 2.
Every function that puts tensors on a device does so on the card
(`device="cuda"`) unless the caller asks for another, such as "cpu".
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_test_tpu_torch.bow.vocabulary import Vocabulary
from orb_slam2_test_tpu_torch.engine.frame import (
    FrameData,
    build_frame_mono,
    build_frame_rgbd,
    build_frame_stereo,
)
from orb_slam2_test_tpu_torch.engine.matchers import search_by_projection
from orb_slam2_test_tpu_torch.engine.tracking import (
    TrackerConfig,
    _build_and_track_device,
    _grow_map_device,
)
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.geometry.se3 import se3_exp
from orb_slam2_test_tpu_torch.io.settings import SlamSettings
from orb_slam2_test_tpu_torch.slam_map.covisibility import build_observer_bitmap
from orb_slam2_test_tpu_torch.slam_map.mapstate import MapState, make_empty_map
from orb_slam2_test_tpu_torch.system import System
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

# the JAX package's bench configuration (bench.py KITTI_CAM / KITTI_CFG,
# copied: bench.py imports jax): KITTI 00-02 stereo at 1241x376, 2000
# features, a map of 384 keyframes and 131072 points
KITTI_CAM = PinholeCamera(
    fx=718.856, fy=718.856, cx=607.19, cy=185.22,
    width=1241, height=376, bf=718.856 * 0.53716,
)
KITTI_CFG = TrackerConfig(
    n_features=2000,
    max_keyframes=384,
    max_points=131072,
    local_pt_cap=8192,
    ba_pt_cap=8192,
    kf_ref_ratio=0.75,
)
# KITTI's camera rate: the frames' timestamp spacing, 1 / KITTI_FPS s
KITTI_FPS = 10.0
# map occupancy of the bench, representative of mid-sequence KITTI
KITTI_N_KF = 200
KITTI_N_PT = 110000
# kitti_scene's right image is the left one shifted by this many
# pixels: a fronto-parallel plane at bf / 19 = 20.3 m
STEREO_DISPARITY = 19
# insert_scene's bands, far to near: each band's stereo disparity in
# pixels (KITTI: 48.3, 32.2, 24.1 and 20.3 m, all beyond close_depth)
INSERT_DISPARITIES = (8, 12, 16, 19)
# TUM freiburg1 RGB-D: Camera.bf of configs/TUM1.yaml
RGBD_CAM = CAM._replace(bf=40.0)
# depth (m) of the mono and RGB-D tracking scenes, inside RGBD_CAM's
# close-point range (th_depth x baseline = 2.7 m)
SCENE_DEPTH = 2.0


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
        radius=15.0, check_view_cos=False,
    )
    has = pm.feat_pt >= 0
    X = pts_xyz[pm.feat_pt.clamp(min=0).to(torch.int64)]
    uvr = torch.cat([frame.uv, frame.ur[:, None]], dim=-1)
    isig2 = 1.0 / (SCALE_FACTOR ** frame.level.to(torch.float32)) ** 2
    res = pose_optimization(cam, Tcw_pred, X, uvr, isig2, has & frame.valid)
    return res.Tcw, res.n_inliers


def state_from_numpy(
    img, pts_xyz, pts_desc, pts_valid, pts_normal, pts_mind, pts_maxd, Tcw,
    device: torch.device | str = "cuda",
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
    device: torch.device | str = "cuda",
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


def bench_map(cfg: TrackerConfig, n_kf: int, n_pt: int, seed: int = 0) -> dict:
    """The JAX package's bench map (`bench._bench_map`) as numpy arrays
    in the JAX package's layouts (descriptors uint32), field by field
    and draw by draw the same: the first n_kf keyframes and n_pt points
    live, random poses, keypoints, levels and descriptors, each feature
    linked with probability 1/2 to a random live point. Returns
    {MapState field: array}."""
    rng = np.random.default_rng(seed)
    cap = cfg.map_capacity
    K, N, P = cap.max_keyframes, cap.max_features, cap.max_points
    m = {k: v.numpy() for k, v in make_empty_map(cap, "cpu")._asdict().items()}
    for k in ("kf_desc", "pt_desc"):
        m[k] = m[k].view(np.uint32)
    cam = KITTI_CAM
    uv = np.stack(
        [rng.uniform(20, cam.width - 20, (K, N)),
         rng.uniform(20, cam.height - 20, (K, N))],
        axis=-1,
    ).astype(np.float32)
    Tcw = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    Tcw[:, 0, 3] = rng.uniform(-0.5, 0.5, K)
    Tcw[:, 2, 3] = rng.uniform(-0.5, 0.5, K)
    Tcw[0] = np.eye(4)
    xyz = np.stack(
        [rng.uniform(-20, 20, P), rng.uniform(-3, 3, P), rng.uniform(5, 40, P)],
        axis=-1,
    ).astype(np.float32)
    dist = np.linalg.norm(xyz, axis=-1).astype(np.float32)
    live_kf = np.arange(K) < n_kf
    m.update(
        kf_Tcw=Tcw,
        kf_valid=live_kf,
        kf_uv=uv,
        kf_level=rng.integers(0, cap.n_levels, (K, N)).astype(np.int32),
        kf_desc=rng.integers(0, 2**32, (K, N, 8), dtype=np.uint32),
        kf_kp_valid=np.broadcast_to(live_kf[:, None], (K, N)).copy(),
    )
    linked = live_kf[:, None] & (rng.uniform(size=(K, N)) < 0.5)
    m.update(
        kf_pt_idx=np.where(linked, rng.integers(0, n_pt, (K, N)), -1).astype(np.int32),
        kf_parent=np.maximum(np.arange(K) - 1, -1).astype(np.int32),
        pt_xyz=xyz,
        pt_valid=np.arange(P) < n_pt,
        pt_desc=rng.integers(0, 2**32, (P, 8), dtype=np.uint32),
        pt_normal=(xyz / np.maximum(dist[:, None], 1e-6)).astype(np.float32),
        pt_min_dist=dist * np.float32(0.3),
        pt_max_dist=dist * np.float32(3.0),
        pt_ref_kf=rng.integers(0, n_kf, P).astype(np.int32),
        pt_first_kf=np.zeros(P, np.int32),
        pt_visible=np.full(P, 10.0, np.float32),
        pt_found=np.full(P, 8.0, np.float32),
        n_kf=np.int32(n_kf),
        n_pt=np.int32(n_pt),
    )
    return m


def _to_device(a, device) -> torch.Tensor:
    """A numpy array (or a JAX array) as a tensor on `device`; uint32
    descriptors become int32 bit patterns."""
    a = np.array(a)  # a writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def map_from_numpy(m, device: torch.device | str = "cuda") -> MapState:
    """A map given as the JAX package's numpy arrays (a mapping or a
    NamedTuple with the MapState fields; descriptors uint32) as the
    port's MapState on `device` (descriptors viewed as int32)."""
    get = m.__getitem__ if isinstance(m, dict) else lambda f: getattr(m, f)
    return MapState(*[_to_device(get(f), device) for f in MapState._fields])


def ba_problem_from_numpy(prob, cam, device: torch.device | str = "cuda"):
    """A bundle problem given as the JAX package's `BAProblem` and
    `PinholeCamera` (numpy or JAX arrays; a camera's fields numbers or
    per-camera [C] arrays) as the port's (BAProblem on `device`,
    PinholeCamera whose [C] fields are float32 tensors there)."""
    from orb_slam2_test_tpu_torch.solvers.ba_core import BAProblem

    def field(f):
        a = np.asarray(f)
        if a.ndim == 0:
            return a.item()
        return torch.from_numpy(a.astype(np.float32)).to(device)

    cam_d = {k: getattr(cam, k) for k in PinholeCamera._fields}
    for k in ("fx", "fy", "cx", "cy", "bf"):
        cam_d[k] = field(cam_d[k])
    return (BAProblem(*[_to_device(getattr(prob, f), device) for f in BAProblem._fields]),
            PinholeCamera(**cam_d))


def map_to_numpy(m: MapState) -> dict:
    """The inverse of `map_from_numpy`: {MapState field: numpy array}
    in the JAX package's layouts (descriptors uint32)."""
    out = {}
    for name, x in zip(MapState._fields, m):
        a = x.detach().cpu().numpy()
        out[name] = a.view(np.uint32) if name.endswith("_desc") else a
    return out


def frame_from_numpy(f, device: torch.device | str = "cuda") -> FrameData:
    """A frame given as numpy arrays (descriptors uint32 or int32) as
    the port's FrameData on `device`."""
    return FrameData(*[_to_device(getattr(f, k), device) for k in FrameData._fields])


def vocabulary_from_numpy(voc, device: torch.device | str = "cuda") -> Vocabulary:
    """A vocabulary given as the JAX package's `Vocabulary` (numpy
    arrays, node_desc uint32) as the port's, its arrays on `device`."""
    out = Vocabulary(
        **{f: np.array(getattr(voc, f)) for f in
           ("node_desc", "node_children", "node_is_leaf", "leaf_word", "word_weight")},
        k=int(voc.k), depth=int(voc.depth),
    )
    out.on(device)
    return out


class TrackScene(NamedTuple):
    """A frame and a map that observes it, as numpy arrays in the JAX
    package's layouts (descriptors uint32), with the tracking inputs of
    the frame that follows the map's keyframe 0:

    img_a, img_b  the image (left for stereo) and the right image (stereo,
                  uint8) or depth map (RGB-D, float32 m); img_b is None
                  for mono
    map           {MapState field: array}
    vel, T_cr     constant-velocity motion and the last frame's pose
                  relative to keyframe 0; vel @ T_cr @ kf_Tcw[0] is off
                  T_true by XI_PRED_ERROR
    last_feat_pt  [N] the last frame's feature -> point links (a subset)
    last_frame    the frame itself (FrameData of numpy arrays)
    ref_kf, close_depth, T_true
    n_scene       the number of scene points, in point slots 0..n_scene-1
    """

    img_a: np.ndarray
    img_b: np.ndarray | None
    map: dict
    vel: np.ndarray
    T_cr: np.ndarray
    last_feat_pt: np.ndarray
    last_frame: FrameData
    ref_kf: int
    close_depth: float
    T_true: np.ndarray
    n_scene: int


def _depth_map(rng: np.random.Generator, h: int, w: int, z0: float) -> np.ndarray:
    """Seeded RGB-D depth [h, w] float32 in metres: a plane at z0 with
    eight rectangles 0.5-2 m further away (their edges exercise the
    depth-spread gate) and a few holes (depth 0)."""
    d = np.full((h, w), z0, np.float32)
    for _ in range(8):
        y0, x0 = rng.integers(0, h - 40), rng.integers(0, w - 40)
        dh, dw = rng.integers(30, h // 3), rng.integers(30, w // 3)
        d[y0 : y0 + dh, x0 : x0 + dw] = z0 + rng.uniform(0.5, 2.0)
    for _ in range(4):
        y0, x0 = rng.integers(0, h - 20), rng.integers(0, w - 20)
        d[y0 : y0 + 20, x0 : x0 + 20] = 0.0
    return d


def _view_frame(img, img_b, sensor, cam, cfg, device) -> FrameData:
    """The frame of one view built on `device`, moved to numpy (the JAX
    package's layouts, descriptors uint32)."""
    kw = dict(n_features=cfg.n_features, n_levels=cfg.n_levels,
              scale_factor=cfg.scale_factor)
    img_t = torch.from_numpy(img).to(device)
    if sensor == "stereo":
        frame = build_frame_stereo(img_t, _to_device(img_b, device), 0.0, cam, **kw)
    elif sensor == "rgbd":
        frame = build_frame_rgbd(img_t, _to_device(img_b, device), 0.0, cam, **kw)
    else:
        frame = build_frame_mono(img_t, 0.0, cam, **kw)
    frame = FrameData(*[x.cpu().numpy() for x in frame])
    return frame._replace(desc=frame.desc.view(np.uint32))


def _write_keyframe0(m, frame, true_depth, cam, cfg, T, n_pt, stride):
    """Write `frame` as keyframe 0 of the numpy map `m` at pose T, with a
    point in slots 0..k-1 for every `stride`-th valid keypoint that has
    a true depth: back-projected at that depth, with the keypoint's
    descriptor and the normal and distance range of
    MapPoint::UpdateNormalAndDepth (as in `consistent_scene`). Returns
    (keyframe 0's links [N], the keypoints given a point, k)."""
    h, w = true_depth.shape
    uv = frame.uv.astype(np.float64)
    xi = np.clip(np.round(frame.uv_raw[:, 0]).astype(int), 0, w - 1)
    yi = np.clip(np.round(frame.uv_raw[:, 1]).astype(int), 0, h - 1)
    z = true_depth[yi, xi].astype(np.float64)
    idx = np.flatnonzero(frame.valid & (z > 0))[: n_pt * stride : stride]
    k = idx.size
    pc = np.stack(
        [(uv[idx, 0] - cam.cx) / cam.fx * z[idx],
         (uv[idx, 1] - cam.cy) / cam.fy * z[idx], z[idx]],
        axis=1,
    )
    R, t = T[:3, :3].astype(np.float64), T[:3, 3].astype(np.float64)
    Xw = (pc - t) @ R  # R^T (pc - t), row-wise
    view = Xw + R.T @ t  # Xw - Ow with Ow = -R^T t
    dist = np.linalg.norm(view, axis=1)
    maxd = dist * cfg.scale_factor ** frame.level[idx].astype(np.float64)

    m["pt_xyz"][:k] = Xw
    m["pt_desc"][:k] = frame.desc[idx]
    m["pt_normal"][:k] = view / dist[:, None]
    m["pt_max_dist"][:k] = maxd
    m["pt_min_dist"][:k] = maxd / cfg.scale_factor ** (cfg.n_levels - 1)
    m["pt_valid"][:k] = True
    m["pt_ref_kf"][:k] = 0
    links = np.full(cfg.n_features, -1, np.int32)
    links[idx] = np.arange(k, dtype=np.int32)
    m["kf_Tcw"][0] = T
    for f in ("uv", "level", "angle", "ur", "depth", "desc"):
        m["kf_" + f][0] = getattr(frame, f)
    m["kf_kp_valid"][0] = frame.valid
    m["kf_pt_idx"][0] = links
    m["kf_valid"][0] = True
    return links, idx, k


def tracking_scene(
    rng: np.random.Generator,
    sensor: str,
    cam: PinholeCamera,
    cfg: TrackerConfig,
    n_kf: int,
    n_pt: int,
    device: torch.device | str = "cuda",
    disparity: int = STEREO_DISPARITY,
) -> TrackScene:
    """A seeded texture seen from T_true, and a map that observes it.

    stereo: the right image is the left shifted by `disparity` pixels,
    right[:, x] = left[:, x + disparity] with the last column repeated,
    so every pixel lies on a fronto-parallel plane at bf / disparity.
    rgbd: a seeded depth map (`_depth_map`) around SCENE_DEPTH. mono: a
    plane at SCENE_DEPTH.

    The frame is built on `device` and its valid keypoints become point
    slots 0..k-1 of a `bench_map` filling (`_write_keyframe0`): keyframe
    0 holds T_true and the frame's keypoints, its features linked to
    those points; the bench's random keyframes may link them too. The
    last frame is the frame itself, but it links only every second
    scene point, as if it had lost the others: motion-model tracking
    matches those (and, with depth, temporary points for the rest), and
    local-map tracking must find the others again through keyframe 0."""
    h, w = cam.height, cam.width
    img = texture_image(rng, h, w)
    if sensor == "stereo":
        img_b = np.ascontiguousarray(img[:, np.minimum(np.arange(w) + disparity, w - 1)])
        true_depth = np.full((h, w), cam.bf / disparity, np.float32)
    elif sensor == "rgbd":
        img_b = true_depth = _depth_map(rng, h, w, SCENE_DEPTH)
    elif sensor == "mono":
        img_b = None
        true_depth = np.full((h, w), SCENE_DEPTH, np.float32)
    else:
        raise ValueError(f"sensor must be mono, stereo or rgbd, got {sensor!r}")
    frame = _view_frame(img, img_b, sensor, cam, cfg, device)
    T_true = se3_exp(torch.tensor(XI_TRUE)).numpy()
    m = bench_map(cfg, n_kf, n_pt, seed=int(rng.integers(2**31)))
    links, idx, k = _write_keyframe0(m, frame, true_depth, cam, cfg, T_true, n_pt, 1)
    last_links = np.full(cfg.n_features, -1, np.int32)
    last_links[idx[::2]] = links[idx[::2]]

    vel = se3_exp(torch.tensor(XI_PRED_ERROR)).numpy()
    return TrackScene(
        img_a=img, img_b=img_b, map=m, vel=vel,
        T_cr=np.eye(4, dtype=np.float32), last_feat_pt=last_links, last_frame=frame,
        ref_kf=0, close_depth=float(cfg.th_depth * cam.baseline),
        T_true=T_true, n_scene=k,
    )


class InsertScene(NamedTuple):
    """Three views of a seeded scene, the second and third moved
    sideways, and a map that holds the first as keyframe 0, as numpy
    arrays in the JAX package's layouts:

    views         three (img_a, img_b): the image (left for stereo) and
                  the right image (stereo, uint8), depth map (RGB-D,
                  float32 m) or None (mono)
    T_true        the three true poses [4, 4]
    depth         [H, W] true depth of every pixel (m)
    map           {MapState field: array}
    vel           the motion from one view to the next, off by
                  XI_PRED_ERROR
    last_feat_pt  keyframe 0's links: the last frame of view 1's tracking
    last_frame    view 0's frame (FrameData of numpy arrays)
    close_depth, n_scene (points written, in slots 0..n_scene-1)
    """

    views: list
    T_true: list
    depth: np.ndarray
    map: dict
    vel: np.ndarray
    last_feat_pt: np.ndarray
    last_frame: FrameData
    close_depth: float
    n_scene: int


def _band_views(rng: np.random.Generator, h: int, w: int, n_views: int, z0: float):
    """Four horizontal bands of one seeded texture, band b a
    fronto-parallel plane at z0 * 19 / d_b for d_b in INSERT_DISPARITIES,
    from the farthest at the top. The texture is w + (2 n - 1) * max(d_b)
    pixels wide; view i shows it shifted by 2 i d_b pixels in band b and
    its right image by d_b more. Returns ([(image, right image)] uint8
    [h, w] per view, the true depth [h, w])."""
    disp = np.asarray(INSERT_DISPARITIES)
    bands = np.array_split(np.arange(h), disp.size)
    tex = texture_image(rng, h, w + (2 * n_views - 1) * int(disp.max()))
    depth = np.empty((h, w), np.float32)
    for rows, d in zip(bands, disp):
        depth[rows] = z0 * STEREO_DISPARITY / d
    views = []
    for i in range(n_views):
        img, right = np.empty((h, w), np.uint8), np.empty((h, w), np.uint8)
        for rows, d in zip(bands, disp):
            cols = 2 * i * d + np.arange(w)
            img[rows] = tex[rows][:, cols]
            right[rows] = tex[rows][:, cols + d]
        views.append((img, right))
    return views, depth


def insert_scene(
    rng: np.random.Generator,
    sensor: str,
    cam: PinholeCamera,
    cfg: TrackerConfig,
    n_kf: int,
    n_pt: int,
    device: torch.device | str = "cuda",
) -> InsertScene:
    """A scene in which keyframe insertion does real work: four
    horizontal bands of one seeded texture, each a fronto-parallel plane,
    from the farthest at the top to the nearest at the bottom. Band b
    lies at z_b = z0 * 19 / d_b for d_b in INSERT_DISPARITIES (z0 =
    bf / 19 = 20.3 m for stereo, SCENE_DEPTH otherwise): its stereo
    disparity is d_b pixels and between two views it shifts by 2 d_b
    pixels, so every view and right image is an exact integer shift of
    the texture, and the camera moves 2 x 19 x z0 / fx sideways per
    view (1.07 m at KITTI, a parallax of 3.0 to 1.3 degrees, inside
    min_parallax_cos 0.9998). The spread of depths keeps the pose
    observable: on a single plane a tilt and a vertical shift look
    alike, and the BA's reduced camera system is near-singular.

    View 0 becomes keyframe 0 of a `bench_map` filling with only every
    second keypoint linked to a point, so the others are free to be
    triangulated against the next keyframe; no other keyframe observes
    the scene's points."""
    if sensor not in ("mono", "stereo", "rgbd"):
        raise ValueError(f"sensor must be mono, stereo or rgbd, got {sensor!r}")
    z0 = cam.bf / STEREO_DISPARITY if sensor == "stereo" else SCENE_DEPTH
    pairs, depth = _band_views(rng, cam.height, cam.width, 3, z0)
    views = [(img, {"stereo": right, "rgbd": depth, "mono": None}[sensor])
             for img, right in pairs]
    frame = _view_frame(*views[0], sensor, cam, cfg, device)
    step = np.eye(4, dtype=np.float32)
    step[0, 3] = -2 * STEREO_DISPARITY * z0 / cam.fx
    T0 = se3_exp(torch.tensor(XI_TRUE)).numpy()
    T_true = [T0, step @ T0, step @ step @ T0]
    m = bench_map(cfg, n_kf, n_pt, seed=int(rng.integers(2**31)))
    links, _, k = _write_keyframe0(m, frame, depth, cam, cfg, T0, n_pt, 2)
    # the bench's random keyframes drop their links to the scene's
    # points: linked, they would share a few random observations with
    # every new keyframe and enter its local BA as free cameras whose
    # garbage observations drag the scene's points metres away (in both
    # packages alike)
    bench_rows = m["kf_pt_idx"][1:]
    bench_rows[(bench_rows >= 0) & (bench_rows < k)] = -1
    vel = se3_exp(torch.tensor(XI_PRED_ERROR)).numpy() @ step
    return InsertScene(
        views=views, T_true=T_true, depth=depth, map=m, vel=vel,
        last_feat_pt=links, last_frame=frame,
        close_depth=float(cfg.th_depth * cam.baseline), n_scene=k,
    )


def kitti_insert_scene(
    rng: np.random.Generator,
    device: torch.device | str = "cuda",
    cfg: TrackerConfig = KITTI_CFG,
    n_kf: int = KITTI_N_KF,
    n_pt: int = KITTI_N_PT,
) -> InsertScene:
    """The stereo `insert_scene` at KITTI geometry (1241x376, 2000
    features, bands at 20.3-48.3 m), by default at the bench's capacity
    and occupancy. close_depth (18.8 m) lies in front of every band, so
    the depth points of an insert come from the "100 nearest" branch of
    the close gate, on the tied depths of the nearest band."""
    return insert_scene(rng, "stereo", KITTI_CAM, cfg, n_kf, n_pt, device)


def track_insert_view(
    scene: InsertScene,
    i: int,
    m: MapState,
    obs_bm: torch.Tensor,
    last_frame: FrameData,
    last_feat_pt: torch.Tensor,
    ref_kf: torch.Tensor,
    cam: PinholeCamera = KITTI_CAM,
    cfg: TrackerConfig = KITTI_CFG,
    sensor: str = "stereo",
) -> tuple[FrameData, tuple[torch.Tensor, ...]]:
    """Track view i of an insert scene against map m, on m's device: the
    per-frame program with the scene's motion and the last frame
    anchored at ref_kf (T_cr = I: the last frame is that keyframe).
    Returns (frame, the 17 outputs of `_track_frame_device`)."""
    dev = m.kf_Tcw.device
    img_a, img_b = scene.views[i]
    f32_matmuls()
    return _build_and_track_device(
        cam, cfg, sensor, m, obs_bm, _to_device(img_a, dev),
        None if img_b is None else _to_device(img_b, dev), float(i),
        _to_device(scene.vel.astype(np.float32), dev),
        torch.eye(4, device=dev), last_feat_pt, last_frame, ref_kf, scene.close_depth,
    )


def kitti_scene(
    rng: np.random.Generator,
    device: torch.device | str = "cuda",
    cfg: TrackerConfig = KITTI_CFG,
    n_kf: int = KITTI_N_KF,
    n_pt: int = KITTI_N_PT,
    disparity: int = STEREO_DISPARITY,
) -> TrackScene:
    """The stereo `tracking_scene` at KITTI geometry (1241x376, 2000
    features), by default at the bench's capacity and occupancy."""
    return tracking_scene(
        rng, "stereo", KITTI_CAM, cfg, n_kf, n_pt, device, disparity=disparity
    )


def scene_inputs(scene: TrackScene, device: torch.device | str = "cuda") -> tuple:
    """The scene on `device`, as the arguments of `track_frame_step` and
    of `_build_and_track_device` after (cam, cfg, sensor): (m, obs_bm,
    img_a, img_b, timestamp, vel, T_cr, last_feat_pt, last_frame,
    ref_kf, close_depth). The observer bitmap is built on the device."""
    m = map_from_numpy(scene.map, device)
    img_b = None if scene.img_b is None else _to_device(scene.img_b, device)
    return (
        m, build_observer_bitmap(m), _to_device(scene.img_a, device), img_b, 0.0,
        _to_device(scene.vel.astype(np.float32), device),
        _to_device(scene.T_cr, device), _to_device(scene.last_feat_pt, device),
        frame_from_numpy(scene.last_frame, device),
        torch.tensor(scene.ref_kf, dtype=torch.int32, device=device),
        scene.close_depth,
    )


def track_frame_step(
    m: MapState,
    obs_bm: torch.Tensor,
    img_left: torch.Tensor,
    img_right: torch.Tensor,
    timestamp: float,
    vel: torch.Tensor,
    T_cr: torch.Tensor,
    last_feat_pt: torch.Tensor,
    last_frame: FrameData,
    ref_kf: torch.Tensor,
    close_depth: float,
    cam: PinholeCamera = KITTI_CAM,
    cfg: TrackerConfig = KITTI_CFG,
) -> tuple[FrameData, tuple[torch.Tensor, ...]]:
    """One stereo frame through the whole per-frame program at KITTI:
    frame build, motion-model tracking, local-map tracking, close counts
    (the JAX bench's `track_one`). Returns (frame, the 17 outputs of
    `_track_frame_device`)."""
    f32_matmuls()
    return _build_and_track_device(
        cam, cfg, "stereo", m, obs_bm, img_left, img_right, timestamp, vel,
        T_cr, last_feat_pt, last_frame, ref_kf, close_depth,
    )


def grow_map_step(
    m: MapState,
    obs_bm: torch.Tensor,
    frame: FrameData,
    Tcw: torch.Tensor,
    feat_pt: torch.Tensor,
    timestamp,
    frame_id,
    close_depth,
    rebuild: bool,
    cam: PinholeCamera = KITTI_CAM,
    cfg: TrackerConfig = KITTI_CFG,
) -> tuple[MapState, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Insert a tracked stereo frame as a keyframe at KITTI: depth points
    through the close gate, then the local-mapping stages; a full insert
    (rebuild=True) or a light one (the JAX bench's `grow`). Returns
    (map, kf, culled kf or -1, n_pt, observer bitmap); the arguments are
    left unchanged."""
    f32_matmuls()
    return _grow_map_device(
        cam, cfg, m, obs_bm, frame, Tcw, feat_pt, timestamp, frame_id,
        close_depth, use_depth=True, close_gate=True, rebuild=rebuild,
    )


class BandSequence(NamedTuple):
    """A stereo sequence of `insert_scene`'s four bands:

    frames   n (timestamp, left, right): uint8 [H, W] images on a device
    T_true   n true poses [4, 4] (Tcw, view 0 at the identity)
    """

    frames: list
    T_true: list


def band_sequence(
    rng: np.random.Generator,
    cam: PinholeCamera,
    n_frames: int,
    device: torch.device | str = "cuda",
    fps: float = 10.0,
) -> BandSequence:
    """`insert_scene`'s stereo scene carried over n_frames views
    (`_band_views` with z0 = bf / 19), so every image is an exact
    integer shift and the camera moves 2 bf / fx sideways per view
    (1.07 m at KITTI), exactly, from T_true[0] = I."""
    z0 = cam.bf / STEREO_DISPARITY
    views, _ = _band_views(rng, cam.height, cam.width, n_frames, z0)
    step = np.eye(4)
    step[0, 3] = -2 * STEREO_DISPARITY * z0 / cam.fx
    frames = [(i / fps, _to_device(left, device), _to_device(right, device))
              for i, (left, right) in enumerate(views)]
    T_true = [np.linalg.matrix_power(step, i) for i in range(n_frames)]
    return BandSequence(frames=frames, T_true=T_true)


def kitti_sequence(
    rng: np.random.Generator, n_frames: int, device: torch.device | str = "cuda"
) -> BandSequence:
    """`band_sequence` at KITTI geometry (1241x376, bands at 20.3-48.3 m,
    1.07 m per view, 10 fps). The map starts empty: the Tracker
    initializes it from the first stereo frame."""
    return band_sequence(rng, KITTI_CAM, n_frames, device, KITTI_FPS)


# an epoch-scale first timestamp for live streams (2025-10): float32
# cannot hold t0 + 0.1, so the Tracker's relative timestamps are needed
LIVE_T0 = 1.76e9


def kitti_live_frames(rng: np.random.Generator, n_frames: int) -> BandSequence:
    """`kitti_sequence`'s frames as a camera would send them: host uint8
    images (rounded and clamped to 0..255) and epoch-scale timestamps
    LIVE_T0 + i / KITTI_FPS, for the live path and the direct run it is
    held against."""
    seq = kitti_sequence(rng, n_frames, "cpu")
    frames = [(LIVE_T0 + i / KITTI_FPS,
               *(x.to(torch.float32).round().clamp(0, 255).to(torch.uint8).numpy()
                 for x in (left, right)))
              for i, (_, left, right) in enumerate(seq.frames)]
    return BandSequence(frames=frames, T_true=seq.T_true)


def kitti_multi_sequence(seeds=(0, 1, 2), n_frames: int = 30,
                         device: torch.device | str = "cuda") -> list:
    """One `kitti_sequence` per seed (each seed's own textures), for the
    concurrent multi-sequence path: a list of BandSequence."""
    return [kitti_sequence(np.random.default_rng(s), n_frames, device) for s in seeds]


def kitti_system(device: torch.device | str = "cuda", vocabulary=None,
                 **overrides) -> System:
    """A stereo System at the bench's KITTI configuration (KITTI_CAM and
    KITTI_CFG's 2000 features, K = 384, P = 131,072 and caps of 8192),
    from an empty map; as for any settings, at most fps = 10 frames pass
    between keyframes. `vocabulary` is System's (None, "default", a path
    or a Vocabulary); `overrides` are System's viewer arguments
    (use_viewer, viewer_dir, live_viewer_port) and TrackerConfig
    fields."""
    c = KITTI_CFG
    settings = SlamSettings(
        fx=KITTI_CAM.fx, fy=KITTI_CAM.fy, cx=KITTI_CAM.cx, cy=KITTI_CAM.cy,
        bf=KITTI_CAM.bf, width=KITTI_CAM.width, height=KITTI_CAM.height, fps=KITTI_FPS,
        n_features=c.n_features, max_keyframes=c.max_keyframes, max_points=c.max_points,
        local_pt_cap=c.local_pt_cap, ba_pt_cap=c.ba_pt_cap,
    )
    return System(settings, "stereo", vocabulary=vocabulary, device=device, **overrides)


def sequence_step(system: System, frame: tuple):
    """Track one stereo frame (timestamp, left, right) of a sequence
    through `System.track_stereo`. Returns the pose (Tcw, numpy) or None
    when lost."""
    t, left, right = frame
    return system.track_stereo(left, right, t)


# ---------------------------------------------------------------------------
# Loop closing: the out-and-back ring and the KITTI-geometry loop
# ---------------------------------------------------------------------------

# tests/test_loop_closing_e2e.py's tracker settings for its 320x240 RGB-D
# scenes: 400 features, a small map, depth thresholds for a 0.08 m
# baseline, and close-deficit constants scaled to the feature count
OUT_AND_BACK_CFG = dict(
    n_features=400, max_keyframes=64, max_points=8192, local_kf_cap=8, ba_fixed_cap=4,
    ba_pt_cap=1024, n_triangulate_neighbors=2, min_depth_init_points=100,
    max_frames_between_kf=3, min_local_inliers=20, th_depth=150.0,
    kf_close_tracked_max=40, kf_close_untracked_min=28,
)


class OutAndBackScene(NamedTuple):
    """The out-and-back ring of tests/test_loop_closing_e2e.py: 320x240
    RGB-D views from a 2 m ring looking out at a wall of 500 textured
    points, 1.25 revolutions (the start is seen again).

    cam, poses [n] Tcw, images [n] float32 [H, W], depths [n] metres,
    vocabulary (k = 10, depth 4, built from the sequence's own ORB
    descriptors, as the JAX test trains it)."""

    cam: PinholeCamera
    poses: list
    images: list
    depths: list
    vocabulary: Vocabulary


def out_and_back_scene(rng: np.random.Generator, n_frames: int = 120,
                       device: torch.device | str = "cuda") -> OutAndBackScene:
    """Render the ring (rng as the JAX test's fixture: default_rng(0))
    and train its vocabulary; the ORB extraction for the vocabulary runs
    on `device` (the card unless the caller asks for another)."""
    from orb_slam2_test_tpu_torch.bow.vocabulary import build_vocabulary
    from orb_slam2_test_tpu_torch.utils.synthetic import (
        _landmark_patches,
        default_camera,
        render_frame,
    )

    cam = default_camera(320, 240)
    cam = cam._replace(bf=0.08 * cam.fx)
    R, n_lm = 2.0, 500
    phi = rng.uniform(0, 2 * np.pi, n_lm)
    r = rng.uniform(R + 6.0, R + 7.0, n_lm)
    yy = rng.uniform(-3.0, 3.0, n_lm)
    landmarks = np.stack([r * np.sin(phi), yy, R - r * np.cos(phi)], axis=1).astype(np.float32)
    inten = rng.uniform(140, 255, n_lm).astype(np.float32)
    patches = _landmark_patches(n_lm)
    normals = -np.stack([np.sin(phi), np.zeros(n_lm), -np.cos(phi)], axis=1).astype(np.float32)
    poses, images, depths = [], [], []
    for i in range(n_frames):
        th = 2 * np.pi * i / 96
        C = np.array([R * np.sin(th), 0.0, R - R * np.cos(th)])
        zax = np.array([np.sin(th), 0.0, -np.cos(th)])  # outward radial
        yax = np.array([0.0, 1.0, 0.0])
        Twc = np.eye(4, dtype=np.float32)
        Twc[:3, :3] = np.stack([np.cross(yax, zax), yax, zax], axis=1)
        Twc[:3, 3] = C
        T = np.linalg.inv(Twc).astype(np.float32)
        img, dep = render_frame(cam, T, landmarks, inten, patches=patches, normals=normals,
                                return_depth=True)
        poses.append(T)
        images.append(img)
        depths.append(dep)
    descs = []
    step = max(n_frames // 6, 1)
    for img in images[::step][:6]:
        f = build_frame_mono(_to_device(img.astype(np.float32), device), 0.0, cam,
                             n_features=OUT_AND_BACK_CFG["n_features"])
        descs.append(f.desc.cpu().numpy().view(np.uint32)[f.valid.cpu().numpy()])
    voc = build_vocabulary(np.concatenate(descs), k=10, depth=4, seed=0)
    return OutAndBackScene(cam=cam, poses=poses, images=images, depths=depths, vocabulary=voc)


def out_and_back_tracker(scene: OutAndBackScene, device: torch.device | str = "cuda"):
    """The JAX test's Tracker for the ring: its settings, place
    recognition with a fixed scale, and 5 keyframes between loops."""
    from orb_slam2_test_tpu_torch.engine.tracking import Tracker

    tracker = Tracker(scene.cam, TrackerConfig(**OUT_AND_BACK_CFG), device=device)
    tracker.enable_place_recognition(scene.vocabulary, fix_scale=True, min_kf_gap=5)
    return tracker


# examples/make_synth_data.py's tracker overrides for its synthetic KITTI
# loops (fewer matchable blobs than real imagery at 2000 features): the
# settings of the JAX package's runs/kitti00_full
KITTI_LOOP_OVERRIDES = dict(
    min_init_matches=60, min_init_triangulated=40, min_local_inliers=20,
    max_frames_between_kf=5, min_depth_init_points=150,
)
KITTI_LOOP_LANDMARKS = 6000  # make_synth_data.py kitti's default


class LoopSequence(NamedTuple):
    """A rendered stereo loop: images [n, 2, H, W] uint8 (left, right),
    T_true [n, 4, 4] Tcw, the timestamps i / fps."""

    images: np.ndarray
    T_true: np.ndarray
    fps: float

    def frames(self) -> list:
        """(timestamp, left, right) per frame, as MemorySequence holds them."""
        return [(i / self.fps, self.images[i, 0], self.images[i, 1])
                for i in range(len(self.images))]


def kitti_loop_sequence(n_frames: int, radius: float, revolutions: float,
                        workers: int = 1, seed: int = 0,
                        n_landmarks: int = KITTI_LOOP_LANDMARKS) -> LoopSequence:
    """The KITTI-geometry stereo loop of examples/make_synth_data.py's
    `kitti` (KITTI_CAM, 1241x376, baseline 0.537 m, a corridor of
    textured quads 3-12 m from a circular path), rendered into memory by
    `workers` processes (about 1.2 s per stereo frame on one core)."""
    from orb_slam2_test_tpu_torch.utils.synthetic import render_loop_stereo

    poses, images = render_loop_stereo(n_frames, KITTI_CAM, radius, revolutions,
                                       n_landmarks=n_landmarks, seed=seed, workers=workers)
    return LoopSequence(images=images, T_true=poses, fps=10.0)


def kitti_loop_system(device: torch.device | str = "cuda", vocabulary="default",
                      max_keyframes: int = KITTI_CFG.max_keyframes,
                      max_points: int = KITTI_CFG.max_points, **overrides) -> System:
    """`kitti_system` with the synthetic KITTI loop's tracker overrides,
    the packaged vocabulary (place recognition, loop closing with a
    fixed scale) and the given starting capacities (they grow as the
    map fills)."""
    return kitti_system(device, vocabulary=vocabulary, max_keyframes=max_keyframes,
                        max_points=max_points, **{**KITTI_LOOP_OVERRIDES, **overrides})


def kitti_loop_run(frames: int = 1200, radius: float = 60.0, revolutions: float = 2.0,
                   max_keyframes: int = 128, max_points: int = 49152, workers: int = 1,
                   seed: int = 0, device: torch.device | str = "cuda", log=print,
                   diag: str | None = None) -> dict:
    """The multi-lap run of the JAX package's runs/kitti00_full through
    the port: render the loop (1200 frames, radius 60 m, ~2 laps by
    default), then `cli.run` on a MemorySequence with small starting
    capacities so the map grows, the ATE against the rendered truth.
    Returns cli.run's summary plus the render time and the ms of every
    frame (host wall) and of the frames that closed a loop."""
    import os
    import tempfile
    import time

    from orb_slam2_test_tpu_torch import cli
    from orb_slam2_test_tpu_torch.io.datasets import MemorySequence
    from orb_slam2_test_tpu_torch.io.trajectory import save_trajectory_tum

    t0 = time.perf_counter()
    seq = kitti_loop_sequence(frames, radius, revolutions, workers=workers, seed=seed)
    render_s = time.perf_counter() - t0
    log(f"rendered {frames} stereo frames {KITTI_CAM.width}x{KITTI_CAM.height} "
        f"(radius {radius} m, {revolutions} laps) in {render_s:.1f} s with {workers} workers")
    system = kitti_loop_system(device, max_keyframes=max_keyframes, max_points=max_points)
    tracker = system.tracker
    frame_ms, loop_frames = [], []
    track_stereo = system.track_stereo

    def timed(left, right, t):
        loops = tracker.stats["loops"]
        t1 = time.perf_counter()
        out = track_stereo(left, right, t)
        frame_ms.append((time.perf_counter() - t1) * 1e3)
        if tracker.stats["loops"] > loops:
            loop_frames.append({"frame": len(frame_ms) - 1, "ms": frame_ms[-1]})
        return out

    system.track_stereo = timed
    with tempfile.TemporaryDirectory() as d:
        gt = os.path.join(d, "groundtruth.txt")
        save_trajectory_tum(gt, [(i / seq.fps, T) for i, T in enumerate(seq.T_true)])
        argv = ["(in memory)", "(in memory)", "--groundtruth", gt,
                "--traj-out", os.path.join(d, "traj.txt"),
                "--kf-traj-out", os.path.join(d, "kf.txt"), "--device", str(device)]
        if diag:
            argv += ["--diag", diag]
        args = cli.common_parser("").parse_args(argv)
        summary = cli.run(system, MemorySequence("stereo", seq.frames()), args, log=log)
    summary.update(render_s=render_s, frame_ms=frame_ms, loop_frames=loop_frames,
                   radius=radius, revolutions=revolutions, seed=seed)
    return summary


# synthetic_loop_map's camera: 320x240, the out-and-back ring's 0.08 m baseline
LOOP_MAP_CAM = PinholeCamera(fx=256.0, fy=256.0, cx=160.0, cy=120.0, width=320, height=240,
                             bf=0.08 * 256.0)
_LOOP_REVISIT = 20  # keyframes from here on revisit the start
_LOOP_STEP_DEG = 18.0


def _ring_pose(theta: float) -> np.ndarray:
    """Tcw on the out-and-back ring, looking outward."""
    R = 2.0
    C = np.array([R * np.sin(theta), 0.0, R - R * np.cos(theta)])
    zax = np.array([np.sin(theta), 0.0, -np.cos(theta)])
    yax = np.array([0.0, 1.0, 0.0])
    Rwc = np.stack([np.cross(yax, zax), yax, zax], axis=1)
    Twc = np.eye(4)
    Twc[:3, :3] = Rwc
    Twc[:3, 3] = C
    return np.linalg.inv(Twc)


def synthetic_loop_map(n_kf: int = 22, K: int = 32, N: int = 200, P: int = 4096,
                       n_world: int = 1600, seed: int = 0) -> tuple[dict, list]:
    """A small map that closes a loop, without tracking: n_kf RGB-D
    keyframes (LOOP_MAP_CAM) 18 degrees apart on the out-and-back ring,
    looking out at a wall of n_world points 6-7 m away, their poses
    drifted along the path (1 cm and 0.17 degrees more per keyframe).
    Keyframes from 20 on revisit the views of 0, 1, ... but hold
    duplicates of the points the start saw (no association across the
    loop). Features are the points' random descriptors with 0-3 flipped
    bits at their projections (0.3 px noise), with depth; points are
    back-projected from their first keyframe's drifted pose; each
    keyframe's parent is the one before. Returns (the map as the JAX
    package's numpy layouts, the true poses Tcw)."""
    from orb_slam2_test_tpu_torch.slam_map.mapstate import MapCapacity

    rng = np.random.default_rng(seed)
    cam = LOOP_MAP_CAM
    phi = rng.uniform(0, 2 * np.pi, n_world)
    r = rng.uniform(8.0, 9.0, n_world)
    Xw = np.stack([r * np.sin(phi), rng.uniform(-3, 3, n_world), 2.0 - r * np.cos(phi)], 1)
    wdesc = rng.integers(0, 2 ** 32, (n_world, 8), dtype=np.uint64).astype(np.uint32)
    wangle = rng.uniform(0, 2 * np.pi, n_world).astype(np.float32)

    m = map_to_numpy(make_empty_map(
        MapCapacity(max_keyframes=K, max_features=N, max_points=P), "cpu"))
    T_true = [_ring_pose(np.deg2rad(_LOOP_STEP_DEG * (i % _LOOP_REVISIT)) + 0.01 * (i >= _LOOP_REVISIT))
              for i in range(n_kf)]
    T_est = [se3_exp(torch.tensor([0.01, 0.0, 0.01, 0.0, 0.003, 0.0], dtype=torch.float64)
                     * i).numpy() @ T for i, T in enumerate(T_true)]
    pt_of_world = {}  # world point -> map point (the start's and the revisit's apart)
    n_pt = 0
    for i in range(n_kf):
        T, Te = T_true[i], T_est[i]
        pc = Xw @ T[:3, :3].T + T[:3, 3]
        z = pc[:, 2]
        u = cam.fx * pc[:, 0] / np.maximum(z, 1e-3) + cam.cx
        v = cam.fy * pc[:, 1] / np.maximum(z, 1e-3) + cam.cy
        vis = np.nonzero((z > 0.5) & (u >= 2) & (u < cam.width - 2) & (v >= 2)
                         & (v < cam.height - 2))[0][:N]
        n = len(vis)
        uv = np.stack([u[vis], v[vis]], 1) + rng.normal(0, 0.3, (n, 2))
        desc = wdesc[vis].copy()
        for row in range(n):
            for b in rng.choice(256, rng.integers(0, 4), replace=False):
                desc[row, b // 32] ^= np.uint32(1 << (b % 32))
        m["kf_Tcw"][i] = Te
        m["kf_valid"][i] = True
        m["kf_timestamp"][i] = 0.1 * i
        m["kf_frame_id"][i] = 3 * i
        m["kf_uv"][i, :n] = uv
        m["kf_angle"][i, :n] = wangle[vis]
        m["kf_depth"][i, :n] = z[vis]
        m["kf_ur"][i, :n] = uv[:, 0] - cam.bf / z[vis]
        m["kf_desc"][i, :n] = desc
        m["kf_kp_valid"][i, :n] = True
        m["kf_parent"][i] = i - 1
        Twc_est = np.linalg.inv(Te)
        for row, w in enumerate(vis):
            key = (w, i >= _LOOP_REVISIT)
            if key not in pt_of_world:
                ray = np.array([(uv[row, 0] - cam.cx) / cam.fx, (uv[row, 1] - cam.cy) / cam.fy, 1])
                X = Twc_est[:3, :3] @ (ray * z[w]) + Twc_est[:3, 3]
                dist = np.linalg.norm(X - Twc_est[:3, 3])
                p = n_pt
                n_pt += 1
                pt_of_world[key] = p
                m["pt_xyz"][p] = X
                m["pt_valid"][p] = True
                m["pt_desc"][p] = wdesc[w]
                m["pt_normal"][p] = (X - Twc_est[:3, 3]) / dist
                m["pt_max_dist"][p] = 1.1 * dist
                m["pt_min_dist"][p] = 1.1 * dist / 1.2 ** 7
                m["pt_ref_kf"][p] = i
                m["pt_first_kf"][p] = 3 * i
                m["pt_visible"][p] = m["pt_found"][p] = 1.0
            m["kf_pt_idx"][i, row] = pt_of_world[key]
    m["n_kf"] = np.int32(n_kf)
    m["n_pt"] = np.int32(n_pt)
    return m, T_true


# ---------------------------------------------------------------------------
# The multi-chip path: the distributed BA and a data-parallel frontend
# ---------------------------------------------------------------------------


def dryrun_multichip(n_devices: int = 1, device: torch.device | str = "cuda") -> dict:
    """The counterpart of `__graft_entry__.dryrun_multichip`: run the
    multi-chip path on an n-shard mesh (the process group's when
    `torch.distributed` is initialized).

    1. The distributed BA on the KITTI-scale synthetic problem (256
       cameras, 32,768 points, 5 observations each), sharded, 2 LM
       iterations; its cost must be finite.
    2. A data-parallel frontend: one 96x128 image per shard through
       `extract_orb` (64 features, 4 levels), which launches kernel 1.
    Returns {"cost", "descs" [shards held here, 64, 8]}."""
    from orb_slam2_test_tpu_torch.ops.extractor import extract_orb
    from orb_slam2_test_tpu_torch.parallel.dist_ba import (
        dist_bundle_adjust,
        make_ba_mesh,
        shard_problem,
    )
    from orb_slam2_test_tpu_torch.parallel.multihost import make_global_problem
    from orb_slam2_test_tpu_torch.utils.synthetic import synthetic_ba_problem

    mesh = make_ba_mesh(n_devices, device)
    rng = np.random.default_rng(0)
    prob, cam = synthetic_ba_problem(256, 32768, 5, seed=0, device=mesh.device)
    sprob = shard_problem(prob, mesh.size)
    if mesh.distributed:
        sprob = make_global_problem(sprob, mesh)
    _, _, cost = dist_bundle_adjust(sprob, cam, mesh, iters=2)
    cost = float(cost)
    if not np.isfinite(cost):
        raise RuntimeError(f"dryrun_multichip: the distributed BA's cost is {cost}")

    imgs = rng.uniform(0, 255, (mesh.size, 96, 128)).astype(np.float32)
    shards = range(mesh.size) if not mesh.distributed else [mesh.rank]
    descs = torch.stack([
        extract_orb(torch.from_numpy(imgs[s]).to(mesh.device), n_features=64, n_levels=4).desc
        for s in shards])
    print(f"dryrun_multichip({mesh.size}): dist-BA cost={cost:.3f}, "
          f"frontend descs={tuple(descs.shape)} OK")
    return {"cost": cost, "descs": descs}
