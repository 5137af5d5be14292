"""Local-BA window sweep: ATE and time against the window's size.

The counterpart of the JAX package's examples/ba_window_sweep.py. The
local BA optimizes at most `local_kf_cap` keyframes (the Tracker's
`LocalBACaps.n_local`, 16 by default), a static-shape cap of the TPU
program that the port keeps, where the reference takes every covisible
keyframe (src/Optimizer.cc:~440). The sweep runs the same stereo
sequence at each window n (with ba_fixed_cap max(8, n // 2)) through
`System` with the packaged vocabulary, on --device, and reports the
ATE, keyframes, loops, lost frames and time per window:

  python -m orb_slam2_test_tpu_torch.cli ba_window_sweep DATASET \\
      --windows 16 32 64 --max-frames 700 --out runs/ba_window_sweep.json
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from orb_slam2_test_tpu_torch.evaluation import absolute_trajectory_error
from orb_slam2_test_tpu_torch.io.datasets import Sequence, load_kitti
from orb_slam2_test_tpu_torch.io.settings import SlamSettings, load_settings
from orb_slam2_test_tpu_torch.io.trajectory import load_trajectory_tum
from orb_slam2_test_tpu_torch.system import STEREO, System
from orb_slam2_test_tpu_torch.tools import torch_device


def sweep_system(settings: SlamSettings, n_local: int, ba_pt_cap: int,
                 max_kf: int | None = None, max_pt: int | None = None,
                 device: torch.device | str = "cuda") -> System:
    """A stereo System with the packaged vocabulary and a local-BA
    window of n_local keyframes (max(8, n_local // 2) fixed ones,
    ba_pt_cap points); max_kf / max_pt override the map's capacity."""
    extra = {}
    if max_kf is not None:
        extra["max_keyframes"] = max_kf
    if max_pt is not None:
        extra["max_points"] = max_pt
    return System(settings, STEREO, vocabulary="default", device=device,
                  local_kf_cap=n_local, ba_fixed_cap=max(8, n_local // 2),
                  ba_pt_cap=ba_pt_cap, **extra)


def run_system(system: System, seq: Sequence, n_local: int, max_frames: int | None,
               groundtruth: list, log=print) -> dict:
    """Track the first max_frames stereo frames of `seq` through
    `system.track_stereo`, resolve the backend and evaluate: the JAX
    script's row (the ATE against `groundtruth`, keyframes, loops, lost
    frames, the median frame ms and the wall seconds, host wall)."""
    n = len(seq) if max_frames is None else min(len(seq), max_frames)
    tracker = system.tracker
    frame_times = []
    t0 = time.time()
    for i, it in enumerate(seq.items[:n]):
        data = seq.load(it)
        f0 = time.time()
        system.track_stereo(data[1], data[2], data[0])
        frame_times.append(time.time() - f0)
        if (i + 1) % 200 == 0:
            log(f"  [n_local={n_local}] {i + 1}/{n} kf={tracker.stats['n_kf']}")
    wall = time.time() - t0
    tracker.drain_backend()
    res = absolute_trajectory_error(tracker.export_trajectory(), groundtruth)
    return {
        "n_local": n_local,
        "frames": n,
        "ate_rmse_m": round(float(res["rmse"]), 4),
        "ate_pairs": int(res["n_pairs"]),
        "keyframes": int(tracker.stats["n_kf"]),
        "loops": int(tracker.stats["loops"]),
        "lost_frames": int(tracker.stats["lost_frames"]),
        "median_frame_ms": round(float(np.median(frame_times)) * 1e3, 1),
        "wall_s": round(wall, 1),
    }


def run_one(dataset: str, n_local: int, max_frames: int | None, ba_pt_cap: int,
            max_kf: int | None = None, max_pt: int | None = None,
            device: torch.device | str = "cuda", log=print) -> dict:
    """One row of the sweep on a KITTI-format dataset (settings.yaml,
    times.txt, image_0/1, groundtruth.txt)."""
    settings = load_settings(os.path.join(dataset, "settings.yaml"))
    seq = load_kitti(dataset, stereo=True)
    gt = load_trajectory_tum(os.path.join(dataset, "groundtruth.txt"))
    system = sweep_system(settings, n_local, ba_pt_cap, max_kf, max_pt, device)
    try:
        return run_system(system, seq, n_local, max_frames, gt, log)
    finally:
        system.shutdown()


def add_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("dataset")
    p.add_argument("--windows", type=int, nargs="+", default=[16, 32, 64])
    p.add_argument("--max-frames", type=int, default=700)
    p.add_argument("--ba-pt-cap", type=int, default=8192)
    p.add_argument("--max-kf", type=int, default=None,
                   help="override Map.maxKeyFrames (above the expected insert count, so "
                        "that no capacity growth lands in the timing rows)")
    p.add_argument("--max-pt", type=int, default=None)
    p.add_argument("--out", default="runs/ba_window_sweep.json")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default cuda, which raises without a "
                        "card; cpu runs on the CPU)")
    return p


def main(args) -> int:
    device = torch_device(args.device)
    rows = []
    for n_local in args.windows:
        print(f"=== n_local = {n_local}", flush=True)
        rows.append(run_one(args.dataset, n_local, args.max_frames, args.ba_pt_cap,
                            args.max_kf, args.max_pt, device))
        print(json.dumps(rows[-1]), flush=True)
    report = {"metric": "local_ba_window_sweep", "dataset": args.dataset, "rows": rows}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"written to {args.out}")
    return 0
