"""Map checkpoint / resume.

Port of orb_slam2_test_tpu/io/checkpoint.py, in the same npz format
(version 2), so that each package loads the other's files: every
MapState field under "map/<field>" plus a JSON header with the capacity
and the tracker's host state. Descriptors are uint32 in the file and
int32 bit patterns in the port; they are viewed across at the boundary.
The reference has no map save/load (SURVEY.md section 5.4).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from orb_slam2_test_tpu_torch.slam_map.mapstate import MapCapacity, MapState, grow_map

_FORMAT_VERSION = 2  # v2: spanning tree (kf_parent/kf_loop_edge/kf_Tcp)


def _to_file(name: str, x: torch.Tensor) -> np.ndarray:
    a = x.detach().cpu().numpy()
    return a.view(np.uint32) if name.endswith("_desc") else a


def _from_file(name: str, a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy
    if name.endswith("_desc"):
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def save_map(path: str, m: MapState, cap: MapCapacity, meta: dict | None = None):
    """Write a MapState, its capacity and JSON-able metadata."""
    arrays = {f"map/{k}": _to_file(k, v) for k, v in zip(m._fields, m)}
    header = {
        "version": _FORMAT_VERSION,
        "capacity": dataclasses.asdict(cap),
        "meta": meta or {},
    }
    np.savez_compressed(
        path, __header__=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
        **arrays,
    )


def load_map(path: str, device: torch.device | str = "cuda"
             ) -> tuple[MapState, MapCapacity, dict]:
    """Read back (MapState on `device`, MapCapacity, meta)."""
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        if header["version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {header['version']}")
        m = MapState(**{f: _from_file(f, z[f"map/{f}"], device) for f in MapState._fields})
    return m, MapCapacity(**header["capacity"]), header["meta"]


def save_tracker(path: str, tracker) -> None:
    """Checkpoint a whole Tracker: the map, its host state, trajectory."""
    tracker.drain_backend()
    cam = tracker.cam
    meta = {
        "camera": {
            "fx": float(cam.fx), "fy": float(cam.fy),
            "cx": float(cam.cx), "cy": float(cam.cy),
            "k1": float(cam.k1), "k2": float(cam.k2),
            "p1": float(cam.p1), "p2": float(cam.p2),
            "k3": float(cam.k3), "bf": float(cam.bf),
            "width": int(cam.width), "height": int(cam.height),
        },
        "state": tracker.state,
        "ts0": tracker._ts0,
        "ref_kf": int(tracker.ref_kf),
        "ref_kf_tracked": int(tracker.ref_kf_tracked),
        "frames_since_kf": int(tracker.frames_since_kf),
        "frame_id": int(tracker.frame_id),
        "stats": tracker.stats,
        "last_Tcw": np.asarray(tracker.last_Tcw).tolist(),
        "trajectory_t": [t for t, _ in tracker.trajectory],
        "trajectory_T": [np.asarray(T).tolist() for _, T in tracker.trajectory],
        # the relative trajectory, from which export recomputes absolute
        # poses against the optimized keyframe poses
        "rel_t": [t for t, _, _ in tracker.rel_trajectory],
        "rel_ref": [int(r) for _, r, _ in tracker.rel_trajectory],
        "rel_T": [np.asarray(T).tolist() for _, _, T in tracker.rel_trajectory],
    }
    save_map(path, tracker.map, tracker.cap, meta)


def load_tracker(path: str, tracker) -> None:
    """Restore a Tracker in place from `save_tracker`'s file, on the
    tracker's device. A checkpoint of other keyframe or point capacities
    is grown to the larger of the two (maps grow at run time); the
    feature and pyramid geometry must match."""
    m, cap, meta = load_map(path, tracker.device)
    if cap != tracker.cap:
        if (
            cap.max_features != tracker.cap.max_features
            or cap.n_levels != tracker.cap.n_levels
            or cap.scale_factor != tracker.cap.scale_factor
        ):
            raise ValueError(
                f"checkpoint capacity {cap} incompatible with tracker "
                f"capacity {tracker.cap} (feature/pyramid geometry)"
            )
        tracker.cfg = dataclasses.replace(
            tracker.cfg,
            max_keyframes=max(cap.max_keyframes, tracker.cap.max_keyframes),
            max_points=max(cap.max_points, tracker.cap.max_points),
        )
        tracker.cap = tracker.cfg.map_capacity
        if cap != tracker.cap:
            m = grow_map(m, cap, tracker.cap)
    tracker.map = m
    tracker._obs_bm = None  # shapes may have changed: rebuilt on use
    tracker._n_pt_host = int(m.pt_valid.sum())
    tracker.n_live_kf = int(m.kf_valid.sum())
    tracker.state = meta["state"]
    tracker._ts0 = meta.get("ts0")
    tracker.ref_kf = meta["ref_kf"]
    tracker.ref_kf_tracked = meta["ref_kf_tracked"]
    tracker.frames_since_kf = meta["frames_since_kf"]
    tracker.frame_id = meta["frame_id"]
    tracker.stats = meta["stats"]
    tracker.last_Tcw = np.asarray(meta["last_Tcw"])
    tracker._prev_Tcw = tracker.last_Tcw.copy()
    tracker.trajectory = [
        (t, np.asarray(T)) for t, T in zip(meta["trajectory_t"], meta["trajectory_T"])
    ]
    tracker.rel_trajectory = [
        (t, r, np.asarray(T)) for t, r, T in zip(meta["rel_t"], meta["rel_ref"], meta["rel_T"])
    ]
    tracker.velocity = None
    tracker.last_frame = None
    tracker.last_feat_pt = None
    tracker.cur_feat_pt = None
    # the deferred-insert state belongs to the previous map
    tracker._pending_kf = []
    tracker._T_cr_last = None
    tracker._ref_is_new_kf = False
    tracker._ref_Tcw_host = None
