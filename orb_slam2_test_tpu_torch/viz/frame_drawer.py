"""FrameDrawer: keypoint and status overlay on the current image
(reference src/FrameDrawer.cc: DrawFrame draws green squares on tracked
keypoints and a status bar with the state and counts).

A copy of orb_slam2_test_tpu/viz/frame_drawer.py. The Tracker keeps a
reference to the last image it was given (`Tracker.last_image`, numpy or
a tensor on any device); it is read back here, only when a frame is
drawn."""

from __future__ import annotations

import numpy as np
import torch


def host_array(x) -> np.ndarray:
    """A numpy copy of a tensor on any device, or np.asarray of anything
    else (the viewers' one way to read the port's state back)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def draw_frame(
    img: np.ndarray,
    uv: np.ndarray,
    tracked: np.ndarray,
    state: str = "OK",
    n_kf: int = 0,
    n_pts: int = 0,
) -> np.ndarray:
    """Render the tracking overlay.

    img [H, W] float grayscale; uv [N, 2] keypoints; tracked [N] bool
    (matched to a map point -> green, else blue like the reference's
    "visual odometry" points). Returns a BGR uint8 image with a status
    bar appended at the bottom.
    """
    import cv2

    H, W = img.shape[:2]
    rgb = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8), cv2.COLOR_GRAY2BGR)
    uv = np.asarray(uv)
    tracked = np.asarray(tracked)
    r = 3
    for i in range(len(uv)):
        u, v = int(round(uv[i, 0])), int(round(uv[i, 1]))
        if not (0 <= u < W and 0 <= v < H):
            continue
        color = (0, 255, 0) if tracked[i] else (255, 100, 0)
        cv2.rectangle(rgb, (u - r, v - r), (u + r, v + r), color, 1)
    n_tracked = int(tracked.sum())
    bar = np.zeros((22, W, 3), np.uint8)
    text = f"{state} | KFs: {n_kf} | MPs: {n_pts} | tracked: {n_tracked}"
    cv2.putText(bar, text, (6, 15), cv2.FONT_HERSHEY_PLAIN, 1.0, (255, 255, 255), 1)
    return np.concatenate([rgb, bar], axis=0)


def draw_tracker_frame(tracker) -> np.ndarray | None:
    """The overlay of a Tracker's last frame, or None before its first
    frame. Reads the frame, its links and the last image back; without
    OpenCV it raises ModuleNotFoundError before reading anything."""
    import cv2  # noqa: F401  (fail before the readbacks)

    f = tracker.last_frame
    if f is None:
        return None
    uv = host_array(f.uv_raw)
    valid = host_array(f.valid)
    if tracker.cur_feat_pt is not None:
        tracked = host_array(tracker.cur_feat_pt) >= 0
    else:
        tracked = np.zeros(len(uv), bool)
    # the Tracker keeps the last raw image (reference FrameDrawer::Update
    # copies mImGray); a blank canvas only when no frame came through an
    # image entry point
    img = getattr(tracker, "last_image", None)
    if img is None:
        img = np.full((tracker.cam.height, tracker.cam.width), 40.0, np.float32)
    else:
        img = host_array(img).astype(np.float32)
    return draw_frame(
        img, uv[valid], tracked[valid],
        state=tracker.state,
        n_kf=int(tracker.stats["n_kf"]),
        n_pts=int(host_array(tracker.map.pt_valid).sum()),
    )
