"""Viewer: headless periodic snapshots (reference src/Viewer.cc runs a
Pangolin render loop in its own thread; here update() is called once
per frame and writes map and frame snapshots every `every` frames, and
close() a final pair; no display server needed).

A copy of orb_slam2_test_tpu/viz/viewer.py."""

from __future__ import annotations

import os


class Viewer:
    def __init__(self, system, out_dir: str = "viewer_out", every: int = 30):
        self.system = system
        self.out_dir = out_dir
        self.every = every
        self.counter = 0
        os.makedirs(out_dir, exist_ok=True)

    def update(self):
        self.counter += 1
        if self.counter % self.every:
            return
        self.snapshot(tag=f"{self.counter:06d}")

    def snapshot(self, tag: str = "final"):
        """map_<tag>.png, and frame_<tag>.png once a frame was tracked."""
        from orb_slam2_test_tpu_torch.viz.frame_drawer import draw_tracker_frame
        from orb_slam2_test_tpu_torch.viz.map_drawer import draw_map

        tr = self.system.tracker
        draw_map(tr.map, trajectory=tr.trajectory,
                 path=os.path.join(self.out_dir, f"map_{tag}.png"))
        frame = draw_tracker_frame(tr)
        if frame is not None:
            import cv2

            cv2.imwrite(os.path.join(self.out_dir, f"frame_{tag}.png"), frame)

    def close(self):
        self.snapshot(tag="final")
