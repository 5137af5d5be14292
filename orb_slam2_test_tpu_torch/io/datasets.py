"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV.

A copy of orb_slam2_test_tpu/io/datasets.py, plus `MemorySequence` for
frames already in memory. OpenCV is imported by the loaders only.

Replaces the LoadImages functions in the reference example drivers
(Examples/Monocular/{mono_tum,mono_kitti,mono_euroc}.cc,
Examples/Stereo/{stereo_kitti,stereo_euroc}.cc,
Examples/RGB-D/rgbd_tum.cc — SURVEY.md section 2 row 20). Same on-disk
formats; images decode to uint8 grayscale [H, W] (the frame builders
cast on the device).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np


def load_image_gray(path: str) -> np.ndarray:
    """Decode an image to float32 grayscale [H, W] (reference drivers
    use cv::imread + Tracking converts with cvtColor)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(f"failed to load image: {path}")
    # stay uint8: the frame builders cast on the device, so the upload
    # is 1 byte/pixel
    return img


def load_depth(path: str, depth_map_factor: float) -> np.ndarray:
    """Decode a 16-bit depth PNG to metric float32 depth [H, W]
    (reference rgbd_tum.cc: imread(CV_LOAD_IMAGE_UNCHANGED), then
    Frame scales by 1/DepthMapFactor; 0 stays 0 = invalid)."""
    import cv2

    d = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if d is None:
        raise FileNotFoundError(f"failed to load depth image: {path}")
    d = d.astype(np.float32)
    if depth_map_factor not in (0.0, 1.0):
        d = d / depth_map_factor
    return d


@dataclasses.dataclass
class SequenceItem:
    timestamp: float
    paths: tuple  # 1 path (mono), 2 (stereo L/R or rgb+depth)


@dataclasses.dataclass
class Sequence:
    """A loaded dataset sequence: timestamps + image paths, lazily
    decoded. kind is 'mono' | 'stereo' | 'rgbd'."""

    kind: str
    items: list
    depth_map_factor: float = 1.0

    def __len__(self) -> int:
        return len(self.items)

    def __iter__(self) -> Iterator[tuple]:
        for it in self.items:
            yield self.load(it)

    def load(self, it: SequenceItem) -> tuple:
        if self.kind == "mono":
            return it.timestamp, load_image_gray(it.paths[0])
        if self.kind == "stereo":
            return (
                it.timestamp,
                load_image_gray(it.paths[0]),
                load_image_gray(it.paths[1]),
            )
        if self.kind == "rgbd":
            return (
                it.timestamp,
                load_image_gray(it.paths[0]),
                load_depth(it.paths[1], self.depth_map_factor),
            )
        raise ValueError(self.kind)


@dataclasses.dataclass
class MemorySequence(Sequence):
    """A sequence whose items are already decoded: (timestamp, image)
    for mono, (timestamp, left, right) for stereo, (timestamp, image,
    depth in metres) for RGB-D, as `Sequence.load` returns them."""

    def load(self, it: tuple) -> tuple:
        return it


# ---------------------------------------------------------------------------
# TUM RGB-D (reference: mono_tum.cc LoadImages reads rgb.txt;
# rgbd_tum.cc reads associations.txt made by associate.py)
# ---------------------------------------------------------------------------

def _read_tum_list(path: str) -> list:
    """Parse a TUM-format list file: '# comment' lines then
    'timestamp path [timestamp path ...]' rows."""
    rows = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append(line.split())
    return rows


def load_tum_mono(seq_dir: str) -> Sequence:
    rows = _read_tum_list(os.path.join(seq_dir, "rgb.txt"))
    items = [
        SequenceItem(float(r[0]), (os.path.join(seq_dir, r[1]),))
        for r in rows
    ]
    return Sequence("mono", items)


def load_tum_rgbd(
    seq_dir: str,
    depth_map_factor: float = 5000.0,
    associations: Optional[str] = None,
    max_dt: float = 0.02,
) -> Sequence:
    """RGB-D pairs. With an associations.txt (reference workflow), use
    it; otherwise associate rgb.txt/depth.txt by nearest timestamp
    (replicates the TUM benchmark's associate.py so the external tool
    is not required)."""
    if associations is not None:
        rows = _read_tum_list(associations)
        items = [
            SequenceItem(
                float(r[0]),
                (os.path.join(seq_dir, r[1]), os.path.join(seq_dir, r[3])),
            )
            for r in rows
        ]
        return Sequence("rgbd", items, depth_map_factor)

    rgb = _read_tum_list(os.path.join(seq_dir, "rgb.txt"))
    dep = _read_tum_list(os.path.join(seq_dir, "depth.txt"))
    dts = np.array([float(r[0]) for r in dep])
    items = []
    used = set()
    for r in rgb:
        t = float(r[0])
        i = int(np.argmin(np.abs(dts - t)))
        if abs(dts[i] - t) <= max_dt and i not in used:
            used.add(i)
            items.append(
                SequenceItem(
                    t,
                    (
                        os.path.join(seq_dir, r[1]),
                        os.path.join(seq_dir, dep[i][1]),
                    ),
                )
            )
    return Sequence("rgbd", items, depth_map_factor)


# ---------------------------------------------------------------------------
# KITTI odometry (reference: mono_kitti.cc / stereo_kitti.cc LoadImages:
# times.txt + image_0/%06d.png + image_1/%06d.png)
# ---------------------------------------------------------------------------

def load_kitti(seq_dir: str, stereo: bool = False) -> Sequence:
    with open(os.path.join(seq_dir, "times.txt"), "r") as f:
        times = [float(x) for x in f.read().split()]
    items = []
    for i, t in enumerate(times):
        left = os.path.join(seq_dir, "image_0", f"{i:06d}.png")
        if stereo:
            right = os.path.join(seq_dir, "image_1", f"{i:06d}.png")
            items.append(SequenceItem(t, (left, right)))
        else:
            items.append(SequenceItem(t, (left,)))
    return Sequence("stereo" if stereo else "mono", items)


# ---------------------------------------------------------------------------
# EuRoC MAV (reference: mono_euroc.cc / stereo_euroc.cc LoadImages:
# cam0/data + external timestamp list; we also accept cam0/data.csv)
# ---------------------------------------------------------------------------

def _euroc_stamps(cam_dir: str, timestamps_file: Optional[str]) -> list:
    if timestamps_file is not None:
        with open(timestamps_file, "r") as f:
            return [ln.strip() for ln in f if ln.strip()]
    rows = []
    with open(os.path.join(cam_dir, "data.csv"), "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append(line.split(",")[0])
    return rows


def load_euroc(
    mav_dir: str,
    stereo: bool = False,
    timestamps_file: Optional[str] = None,
) -> Sequence:
    """mav_dir is the directory containing mav0/ (or mav0 itself)."""
    root = mav_dir
    if os.path.isdir(os.path.join(mav_dir, "mav0")):
        root = os.path.join(mav_dir, "mav0")
    cam0 = os.path.join(root, "cam0")
    stamps = _euroc_stamps(cam0, timestamps_file)
    items = []
    for s in stamps:
        t = float(s) * 1e-9  # ns -> s
        left = os.path.join(cam0, "data", f"{s}.png")
        if stereo:
            right = os.path.join(root, "cam1", "data", f"{s}.png")
            items.append(SequenceItem(t, (left, right)))
        else:
            items.append(SequenceItem(t, (left,)))
    return Sequence("stereo" if stereo else "mono", items)


# ---------------------------------------------------------------------------
# EuRoC stereo rectification (reference stereo_euroc.cc:
# cv::initUndistortRectifyMap from the LEFT.*/RIGHT.* YAML blocks,
# then remap every frame)
# ---------------------------------------------------------------------------

class StereoRectifier:
    """Precomputed rectification maps; call on each (left, right)."""

    def __init__(self, rectification: dict):
        import cv2

        r = rectification
        size = (int(r["LEFT.width"]), int(r["LEFT.height"]))
        self.m1l = cv2.initUndistortRectifyMap(
            r["LEFT.K"], r["LEFT.D"], r["LEFT.R"],
            r["LEFT.P"][:3, :3], size, cv2.CV_32F,
        )
        self.m1r = cv2.initUndistortRectifyMap(
            r["RIGHT.K"], r["RIGHT.D"], r["RIGHT.R"],
            r["RIGHT.P"][:3, :3], size, cv2.CV_32F,
        )

    def __call__(self, left: np.ndarray, right: np.ndarray):
        import cv2

        lr = cv2.remap(left, self.m1l[0], self.m1l[1], cv2.INTER_LINEAR)
        rr = cv2.remap(right, self.m1r[0], self.m1r[1], cv2.INTER_LINEAR)
        return lr, rr
