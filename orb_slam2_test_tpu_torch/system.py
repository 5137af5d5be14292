"""System: the facade over the engine (reference include/System.h,
src/System.cc).

Port of orb_slam2_test_tpu/system.py:

  reference System::                  here:
    System(voc, settings, sensor)  ->  System(settings, sensor, vocabulary, device)
    TrackMonocular(im, t)          ->  track_monocular(img, t)
    TrackStereo(imL, imR, t)       ->  track_stereo(imgL, imgR, t)
    TrackRGBD(im, depth, t)        ->  track_rgbd(img, depth, t)
    ActivateLocalizationMode       ->  activate_localization_mode()
    DeactivateLocalizationMode     ->  deactivate_localization_mode()
    Reset                          ->  reset()
    Shutdown                       ->  shutdown()
    SaveTrajectoryTUM              ->  save_trajectory_tum(path)
    SaveTrajectoryKITTI            ->  save_trajectory_kitti(path)
    SaveKeyFrameTrajectoryTUM      ->  save_keyframe_trajectory_tum(path)
    GetTrackingState               ->  tracking_state
    (absent in the reference)      ->  save_checkpoint / load_checkpoint

The engine runs on `device`, the card unless the caller asks for
another; asking for the card without one raises. The reference runs
Tracking, LocalMapping and LoopClosing as three threads; here a keyframe
insert is queued on the card behind tracking and resolved at the next
keyframe decision, and a resolved keyframe then enters the
place-recognition database. With a vocabulary the Tracker relocalizes
by BoW candidates and PnP RANSAC and detects loop candidates; closing a
loop (Sim3, the essential graph, global BA) and the viewers are not
ported yet.
"""

from __future__ import annotations

import time
from typing import Union

import numpy as np
import torch

from orb_slam2_test_tpu_torch.bow.vocabulary import (
    Vocabulary,
    default_vocabulary,
    load_vocabulary,
)
from orb_slam2_test_tpu_torch.engine.tracking import Tracker, TrackingState
from orb_slam2_test_tpu_torch.io import trajectory as traj_io
from orb_slam2_test_tpu_torch.io.checkpoint import load_tracker, save_tracker
from orb_slam2_test_tpu_torch.io.settings import SlamSettings, load_settings

MONOCULAR = "monocular"
STEREO = "stereo"
RGBD = "rgbd"

_SENSORS = (MONOCULAR, STEREO, RGBD)


class System:
    """Facade over the SLAM engine."""

    def __init__(
        self,
        settings: Union[str, SlamSettings],
        sensor: str = MONOCULAR,
        vocabulary=None,
        device: torch.device | str = "cuda",
        **config_overrides,
    ):
        """settings: a reference-format YAML path or a SlamSettings.
        vocabulary: None (no place recognition), "default" (the packaged
        artifact; a warning and no place recognition if it is absent), a
        path (.npz or DBoW2 text) or a Vocabulary. config_overrides:
        TrackerConfig fields."""
        if sensor not in _SENSORS:
            raise ValueError(f"sensor must be one of {_SENSORS}")
        self.sensor = sensor
        self.settings = load_settings(settings) if isinstance(settings, str) else settings
        # reference NeedNewKeyFrame: thRefRatio = 0.75 for stereo/RGB-D,
        # 0.9 for monocular
        if sensor != MONOCULAR and "kf_ref_ratio" not in config_overrides:
            config_overrides["kf_ref_ratio"] = 0.75
        cfg = self.settings.tracker_config(**config_overrides)
        self.tracker = Tracker(self.settings.camera, cfg, device)
        self._frame_times = []  # per-frame host wall time, seconds

        self.vocabulary = None
        if isinstance(vocabulary, Vocabulary):
            self.vocabulary = vocabulary
        elif vocabulary is not None:
            t0 = time.time()
            try:
                self.vocabulary = (default_vocabulary() if vocabulary == "default"
                                   else load_vocabulary(vocabulary))
            except FileNotFoundError as e:
                if vocabulary != "default":
                    raise
                print(f"WARNING: {e}; running without place recognition")
            else:
                print(f"Vocabulary loaded in {time.time() - t0:.2f}s "
                      f"({self.vocabulary.n_words} words)")
        if self.vocabulary is not None:
            # stereo / RGB-D fix the Sim3 scale (reference: bFixScale =
            # sensor != MONOCULAR in the System ctor)
            self.tracker.enable_place_recognition(
                self.vocabulary, fix_scale=(sensor != MONOCULAR))

    # ------------------------------------------------------------------
    def track_monocular(self, img, timestamp: float):
        if self.sensor != MONOCULAR:
            raise RuntimeError("track_monocular requires sensor=MONOCULAR")
        return self._timed(lambda: self.tracker.process_image_mono(img, timestamp))

    def track_stereo(self, img_left, img_right, timestamp: float):
        if self.sensor != STEREO:
            raise RuntimeError("track_stereo requires sensor=STEREO")
        return self._timed(
            lambda: self.tracker.process_image_stereo(img_left, img_right, timestamp))

    def track_rgbd(self, img, depth, timestamp: float):
        if self.sensor != RGBD:
            raise RuntimeError("track_rgbd requires sensor=RGBD")
        return self._timed(lambda: self.tracker.process_image_rgbd(img, depth, timestamp))

    def _timed(self, fn):
        t0 = time.perf_counter()
        pose = fn()
        self._frame_times.append(time.perf_counter() - t0)
        return pose

    # ------------------------------------------------------------------
    def activate_localization_mode(self):
        """Track against the frozen map: no new keyframes or points."""
        self.tracker.drain_backend()
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False

    def reset(self):
        self.tracker.reset()
        self._frame_times = []

    def shutdown(self):
        """Resolve the deferred inserts and wait for the device (the
        reference joins its threads here)."""
        self.tracker.drain_backend()
        if self.tracker.device.type == "cuda":
            torch.cuda.synchronize(self.tracker.device)

    # ------------------------------------------------------------------
    @property
    def tracking_state(self) -> str:
        return self.tracker.state

    @property
    def is_lost(self) -> bool:
        return self.tracker.state == TrackingState.LOST

    def get_tracked_map_points(self) -> np.ndarray:
        """Ids of the map points matched in the current frame."""
        fp = self.tracker.cur_feat_pt
        if fp is None:
            return np.zeros((0,), np.int32)
        fp = fp.cpu().numpy()
        return fp[fp >= 0]

    def timing_stats(self) -> dict:
        """Median and mean per-frame track time, host wall (what the
        reference's example mains print at exit)."""
        if not self._frame_times:
            return {"n": 0}
        ts = np.sort(np.array(self._frame_times))
        return {
            "n": len(ts),
            "median_s": float(np.median(ts)),
            "mean_s": float(ts.mean()),
            "fps_median": float(1.0 / max(np.median(ts), 1e-9)),
        }

    # ------------------------------------------------------------------
    def save_trajectory_tum(self, path: str):
        traj_io.save_trajectory_tum(path, self.tracker.export_trajectory())

    def save_trajectory_kitti(self, path: str):
        traj_io.save_trajectory_kitti(path, self.tracker.export_trajectory())

    def save_keyframe_trajectory_tum(self, path: str):
        traj_io.save_trajectory_tum(path, self.tracker.export_keyframe_trajectory())

    def save_checkpoint(self, path: str):
        save_tracker(path, self.tracker)

    def load_checkpoint(self, path: str):
        load_tracker(path, self.tracker)
