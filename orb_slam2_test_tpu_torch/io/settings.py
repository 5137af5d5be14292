"""Settings-file loader: the reference's two-file config scheme.

A copy of orb_slam2_test_tpu/io/settings.py with the port's camera and
TrackerConfig. PyYAML is imported by `load_settings` only, so that
`SlamSettings(...)` works on a machine without it.

ORB-SLAM2 parses per-dataset YAML (Examples/*/{TUM1,KITTI00-02,...}.yaml)
with cv::FileStorage inside Tracking::Tracking (src/Tracking.cc:~55-180)
and Viewer::Viewer. Those files start with a `%YAML:1.0` directive and
use `!!opencv-matrix` tags, neither of which stock PyYAML accepts, so
this module sanitizes then parses. Key inventory: SURVEY.md section 2
row 22.

The same YAML files that drive the reference drive this system
unchanged; `SlamSettings` additionally carries the fixed capacities
(map sizes, BA caps) with sane defaults.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera


def _parse_opencv_yaml(text: str) -> dict:
    """Parse an OpenCV FileStorage YAML document into a flat dict.

    Handles: the %YAML:1.0 directive, !!opencv-matrix tags (become
    {'rows','cols','dt','data'} dicts, converted to np arrays), and the
    reference's dotted keys (kept verbatim: 'Camera.fx' is one key).
    """
    import yaml

    lines = []
    for ln in text.splitlines():
        if ln.strip().startswith("%YAML"):
            continue
        if ln.strip() == "---":
            continue
        ln = ln.replace("!!opencv-matrix", "")
        lines.append(ln)
    doc = yaml.safe_load("\n".join(lines)) or {}

    out = {}
    for k, v in doc.items():
        if isinstance(v, dict) and "data" in v and "rows" in v:
            arr = np.asarray(v["data"], dtype=np.float64)
            out[k] = arr.reshape(int(v["rows"]), int(v["cols"]))
        else:
            out[k] = v
    return out


@dataclasses.dataclass
class SlamSettings:
    """Typed view of a reference settings file + the map capacities."""

    # Camera (reference keys Camera.*)
    fx: float = 517.3
    fy: float = 516.5
    cx: float = 318.6
    cy: float = 255.3
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    fps: float = 30.0
    rgb: bool = True  # Camera.RGB: images are RGB (vs BGR)
    bf: float = 0.0  # Camera.bf = baseline * fx
    th_depth: float = 35.0  # ThDepth: close/far stereo point threshold
    depth_map_factor: float = 1.0  # DepthMapFactor (5000 for TUM png)

    # ORB extractor (reference keys ORBextractor.*)
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7

    # Viewer (reference keys Viewer.*) — used by viz/
    keyframe_size: float = 0.05
    keyframe_line_width: float = 1.0
    graph_line_width: float = 0.9
    point_size: float = 2.0
    camera_size: float = 0.08
    camera_line_width: float = 3.0
    viewpoint_x: float = 0.0
    viewpoint_y: float = -0.7
    viewpoint_z: float = -1.8
    viewpoint_f: float = 500.0

    # EuRoC-style stereo rectification blocks (LEFT.*/RIGHT.*), if present
    rectification: Optional[dict] = None

    # map capacities (no reference equivalent; the object map is
    # fixed-capacity padded arrays — SURVEY.md section 7 design stance)
    max_keyframes: int = 256
    max_points: int = 32768
    local_kf_cap: int = 16
    local_k2_cap: int = 64
    local_pt_cap: int = 4096
    ba_pt_cap: int = 4096

    # Tracker thresholds (reference: hard-coded constants in
    # Tracking.cc/ORBmatcher.h; exposed as optional Tracker.* YAML keys
    # so small/synthetic scenes can be run without code changes).
    # None = use TrackerConfig defaults (the reference's constants).
    min_init_matches: Optional[int] = None
    min_init_triangulated: Optional[int] = None
    min_track_matches: Optional[int] = None
    min_local_inliers: Optional[int] = None
    min_depth_init_points: Optional[int] = None
    n_triangulate_neighbors: Optional[int] = None
    ba_fixed_cap: Optional[int] = None
    max_frames_between_kf: Optional[int] = None
    min_frames_between_kf: Optional[int] = None
    kf_queue_depth: Optional[int] = None
    enable_local_ba: Optional[int] = None  # 0/1 (debug/ablation switch)
    enable_fuse: Optional[int] = None  # 0/1 (debug/ablation switch)
    enable_kf_culling: Optional[int] = None  # 0/1 (debug/ablation switch)

    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def camera(self) -> PinholeCamera:
        return PinholeCamera(
            fx=float(self.fx), fy=float(self.fy),
            cx=float(self.cx), cy=float(self.cy),
            k1=float(self.k1), k2=float(self.k2),
            p1=float(self.p1), p2=float(self.p2), k3=float(self.k3),
            bf=float(self.bf),
            width=int(self.width), height=int(self.height),
        )

    def tracker_config(self, **overrides):
        from orb_slam2_test_tpu_torch.engine.tracking import TrackerConfig

        kw = dict(
            n_features=int(self.n_features),
            n_levels=int(self.n_levels),
            scale_factor=float(self.scale_factor),
            max_keyframes=int(self.max_keyframes),
            max_points=int(self.max_points),
            local_kf_cap=int(self.local_kf_cap),
            local_k2_cap=int(self.local_k2_cap),
            local_pt_cap=int(self.local_pt_cap),
            ba_pt_cap=int(self.ba_pt_cap),
            max_frames_between_kf=int(round(self.fps)),
            th_depth=float(self.th_depth),
        )
        for f in (
            "min_init_matches", "min_init_triangulated",
            "min_track_matches", "min_local_inliers",
            "min_depth_init_points", "n_triangulate_neighbors",
            "ba_fixed_cap", "max_frames_between_kf",
            "min_frames_between_kf", "kf_queue_depth",
        ):
            v = getattr(self, f)
            if v is not None:
                kw[f] = int(v)
        for f in ("enable_local_ba", "enable_fuse", "enable_kf_culling"):
            v = getattr(self, f)
            if v is not None:
                kw[f] = bool(int(v))
        kw.update(overrides)
        return TrackerConfig(**kw)


_KEYMAP = {
    "Camera.fx": "fx", "Camera.fy": "fy",
    "Camera.cx": "cx", "Camera.cy": "cy",
    "Camera.k1": "k1", "Camera.k2": "k2",
    "Camera.p1": "p1", "Camera.p2": "p2", "Camera.k3": "k3",
    "Camera.width": "width", "Camera.height": "height",
    "Camera.fps": "fps", "Camera.bf": "bf",
    "ThDepth": "th_depth", "DepthMapFactor": "depth_map_factor",
    "ORBextractor.nFeatures": "n_features",
    "ORBextractor.scaleFactor": "scale_factor",
    "ORBextractor.nLevels": "n_levels",
    "ORBextractor.iniThFAST": "ini_th_fast",
    "ORBextractor.minThFAST": "min_th_fast",
    "Viewer.KeyFrameSize": "keyframe_size",
    "Viewer.KeyFrameLineWidth": "keyframe_line_width",
    "Viewer.GraphLineWidth": "graph_line_width",
    "Viewer.PointSize": "point_size",
    "Viewer.CameraSize": "camera_size",
    "Viewer.CameraLineWidth": "camera_line_width",
    "Viewer.ViewpointX": "viewpoint_x",
    "Viewer.ViewpointY": "viewpoint_y",
    "Viewer.ViewpointZ": "viewpoint_z",
    "Viewer.ViewpointF": "viewpoint_f",
    # extension keys of this engine (optional in the YAML)
    "Map.maxKeyFrames": "max_keyframes",
    "Map.maxPoints": "max_points",
    "Tracker.localKFCap": "local_kf_cap",
    "Tracker.localK2Cap": "local_k2_cap",
    "Tracker.localPtCap": "local_pt_cap",
    "Tracker.baPtCap": "ba_pt_cap",
    "Tracker.minInitMatches": "min_init_matches",
    "Tracker.minInitTriangulated": "min_init_triangulated",
    "Tracker.minTrackMatches": "min_track_matches",
    "Tracker.minLocalInliers": "min_local_inliers",
    "Tracker.minDepthInitPoints": "min_depth_init_points",
    "Tracker.nTriangulateNeighbors": "n_triangulate_neighbors",
    "Tracker.baFixedCap": "ba_fixed_cap",
    "Tracker.maxFramesBetweenKF": "max_frames_between_kf",
    "Tracker.minFramesBetweenKF": "min_frames_between_kf",
    "Tracker.kfQueueDepth": "kf_queue_depth",
    "Tracker.enableLocalBA": "enable_local_ba",
    "Tracker.enableFuse": "enable_fuse",
    "Tracker.enableKFCulling": "enable_kf_culling",
}

_INT_FIELDS = {
    "width", "height", "n_features", "n_levels", "ini_th_fast",
    "min_th_fast", "max_keyframes", "max_points",
    "local_kf_cap", "local_k2_cap", "local_pt_cap", "ba_pt_cap",
}


def load_settings(path: str) -> SlamSettings:
    """Load a reference-format settings YAML into SlamSettings."""
    with open(path, "r") as f:
        raw = _parse_opencv_yaml(f.read())

    s = SlamSettings()
    rect = {}
    for k, v in raw.items():
        if k in _KEYMAP:
            field = _KEYMAP[k]
            if field in _INT_FIELDS:
                v = int(v)
            setattr(s, field, v)
        elif k == "Camera.RGB":
            s.rgb = bool(int(v))
        elif re.match(r"^(LEFT|RIGHT)\.", k):
            rect[k] = v
        else:
            s.extra[k] = v
    if rect:
        s.rectification = rect
        # EuRoC-style files put the post-rectification intrinsics in
        # LEFT.P (3x4); they override Camera.* for the rectified stream
        P = rect.get("LEFT.P")
        if P is not None:
            s.fx, s.fy = float(P[0, 0]), float(P[1, 1])
            s.cx, s.cy = float(P[0, 2]), float(P[1, 2])
            s.k1 = s.k2 = s.p1 = s.p2 = s.k3 = 0.0
        if "LEFT.width" in rect:
            s.width = int(rect["LEFT.width"])
            s.height = int(rect["LEFT.height"])
    return s


def save_settings(s: SlamSettings, path: str) -> None:
    """Write settings back in the reference's YAML dialect (round-trip
    compatible with load_settings and with cv::FileStorage)."""
    inv = {v: k for k, v in _KEYMAP.items()}
    lines = ["%YAML:1.0", ""]
    for f in dataclasses.fields(s):
        if f.name in ("extra", "rectification", "rgb"):
            continue
        key = inv.get(f.name)
        if key is None:
            continue
        val = getattr(s, f.name)
        if val is None:  # unset optional Tracker.* override
            continue
        lines.append(f"{key}: {val}")
    lines.append(f"Camera.RGB: {int(s.rgb)}")
    for k, v in s.extra.items():
        if isinstance(v, (int, float, str)):
            lines.append(f"{k}: {v}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
