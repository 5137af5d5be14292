"""Runs of the six dataset commands on the datasets `make_synth_data`
writes: the steps that chip_smoke.py [19] and
examples/dataset_drivers_run.py share.

`start_dataset` starts `make_synth_data` in a process of its own (the
rendering is NumPy on the host, so several datasets render at once), at
the length of the JAX package's recorded run of that kind or cut to its
first frames; `finish_dataset` waits for it. `run_driver` runs one
dataset command through `cli.main` with --diag and --summary-out and
returns the summary with what the scripts check: the kernels' launches
per frame, the lost frames, and each relocalization's frame, host ms
and distance from the ground truth.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

from orb_slam2_test_tpu_torch import cli
from orb_slam2_test_tpu_torch.evaluation import aligned_errors
from orb_slam2_test_tpu_torch.io.trajectory import load_trajectory_tum
from orb_slam2_test_tpu_torch.ops.patches import PATCH_GATHER
from orb_slam2_test_tpu_torch.solvers.pose_opt_cuda import POSE_OPT
from orb_slam2_test_tpu_torch.tools.make_synth_data import (
    full_step_revolutions,
    write_rectified_settings,
)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# command -> (dataset kind, settings file in the dataset); stereo_euroc
# reads the identity LEFT.* / RIGHT.* blocks `write_rectified_settings`
# adds
DRIVERS = {
    "mono_euroc": ("euroc", "settings.yaml"),
    "stereo_euroc": ("euroc", "settings_rectified.yaml"),
    "mono_kitti": ("kitti", "settings.yaml"),
    "stereo_kitti": ("kitti", "settings.yaml"),
    "mono_tum": ("tum-mono", "settings.yaml"),
    "rgbd_tum": ("tum-rgbd", "settings.yaml"),
}
# kind -> (frames, first blank frame or None) of the JAX package's runs:
# runs/euroc_mh01_synth, runs/tum_mono_synth and runs/tum_rgbd_synth
# (a 5-frame blackout at 300, their diag), and make_synth_data's KITTI
# default. Those runs and runs/r04/*.log rendered each quad facing the
# path 0.35 rad back, as make_loop_scene does below 57.14 m (the JAX
# package's generator has used 20 m of arc since commit 4e42fb9), and all
# but runs/r04/tum_rgbd.log ran without the `Tracker.maxFramesBetweenKF:
# 5` that make_synth_data writes (examples/dataset_drivers_run.py's
# JAX_RUNS)
FULL = {"euroc": (300, None), "kitti": (600, None), "tum-mono": (360, 300),
        "tum-rgbd": (360, 300)}
BLACKOUT_LEN = 5


def start_dataset(kind: str, out: str, frames: int | None = None,
                  blackout_at: int | None = None, workers: int = 1,
                  log=None) -> subprocess.Popen:
    """Start `make_synth_data kind --out out` in a new process. frames:
    the first `frames` frames of the full-length trajectory (the same
    scene and step per frame; default FULL's length); blackout_at: the
    first of BLACKOUT_LEN blank frames; workers: KITTI's render
    processes. Its output goes to `log` (a file), else is discarded."""
    full = FULL[kind][0]
    argv = [sys.executable, "-m", "orb_slam2_test_tpu_torch.cli", "make_synth_data", kind,
            "--out", out, "--frames", str(frames or full), "--device", "cpu"]
    if frames and frames != full:
        argv += ["--revolutions", repr(full_step_revolutions(frames, full))]
    if blackout_at is not None:
        argv += ["--blackout-at", str(blackout_at), "--blackout-len", str(BLACKOUT_LEN)]
    if workers > 1:
        argv += ["--workers", str(workers)]
    return subprocess.Popen(argv, cwd=ROOT, stdout=log or subprocess.DEVNULL,
                            stderr=subprocess.STDOUT)


def finish_dataset(proc: subprocess.Popen, kind: str, out: str, timeout: float) -> None:
    """Wait for `start_dataset`'s process; raise if it failed. An EuRoC
    dataset then gets its rectified settings for stereo_euroc."""
    if proc.wait(timeout=timeout) != 0:
        raise RuntimeError(f"make_synth_data {kind} exited with {proc.returncode}")
    if kind == "euroc":
        write_rectified_settings(out)


def run_driver(driver: str, data: str, out: str, vocabulary: str | None = "default",
               device: str = "cuda", max_frames: int | None = None,
               tag: str | None = None) -> dict:
    """`cli.main([driver, settings, data, ...])` with the dataset's
    ground truth, writing the trajectory, the diag and the summary to
    `out`/<tag or driver>_*. Returns the summary (cli.run's, with the
    ATE) and, from the diag: each frame's `states`, host seconds
    `frame_s`, `timestamps` and `launches_per_frame` [(patch_gather,
    pose_opt)], `lost_at` the LOST frames,
    `relocalized` [{"frame", "ms", "err_m"}] for each frame that went
    from LOST to OK (its error after the ATE's alignment, Sim3 for a
    monocular run) and `paths`."""
    settings = os.path.join(data, DRIVERS[driver][1])
    gt = os.path.join(data, "groundtruth.txt")
    prefix = os.path.join(out, tag or driver)
    paths = {k: f"{prefix}_{k}" for k in ("traj.txt", "kf.txt", "diag.jsonl", "summary.json")}
    argv = [driver, settings, data, "--groundtruth", gt, "--device", device,
            "--traj-out", paths["traj.txt"], "--kf-traj-out", paths["kf.txt"],
            "--diag", paths["diag.jsonl"], "--summary-out", paths["summary.json"]]
    argv += ["--no-vocabulary"] if vocabulary is None else ["--vocabulary", vocabulary]
    if max_frames is not None:
        argv += ["--max-frames", str(max_frames)]
    start = [PATCH_GATHER.launches, POSE_OPT.launches]
    if cli.main(argv) != 0:
        raise RuntimeError(f"cli {' '.join(argv)} failed")
    with open(paths["summary.json"]) as f:
        summary = json.load(f)
    with open(paths["diag.jsonl"]) as f:
        diag = [json.loads(line) for line in f]
    counts = np.array([start] + [r["launches"] for r in diag])
    states = [r["state"] for r in diag]
    times, err, _ = aligned_errors(load_trajectory_tum(paths["traj.txt"]),
                                   load_trajectory_tum(gt),
                                   with_scale=driver.startswith("mono"))
    relocalized = []
    for i in range(1, len(states)):
        if states[i - 1] == "LOST" and states[i] == "OK":
            k = int(np.argmin(np.abs(times - diag[i]["timestamp"])))
            relocalized.append({"frame": i, "ms": diag[i]["t_frame_s"] * 1e3,
                                "err_m": float(err[k])})
    summary.update(
        states=states, frame_s=[r["t_frame_s"] for r in diag],
        timestamps=[r["timestamp"] for r in diag],
        launches_per_frame=[tuple(int(x) for x in d) for d in np.diff(counts, axis=0)],
        lost_at=[i for i, s in enumerate(states) if s == "LOST"],
        relocalized=relocalized, paths=paths)
    return summary
