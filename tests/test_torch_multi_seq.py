"""The port's parallel CLI subcommands on the CPU: `cli multi_seq` (the JAX
package's examples/multi_seq.py) and `cli dist_ba_scaling`
(examples/dist_ba_scaling.py).

- multi_seq on two KITTI-layout stereo sequences written to files
  (`entry.band_sequence` at 640x480, bf 40, 6 frames each, two seeds),
  2 shards, a joint BA every 6 frames summed over the sequences and a
  final one: both sequences track every frame, each writes its
  trajectory (CameraTrajectory_<i>.txt under --traj-prefix), every
  joint BA prints its `[joint BA]` line with the cameras of both maps,
  the summary line prints the aggregate fps, and --measure-scaling
  prints the JSON report with measure_scaling's keys.
- dist_ba_scaling --synthetic C P O: the report's keys and shard counts.
"""

import json
import os

import cv2
import numpy as np
import torch

from orb_slam2_test_tpu_torch import cli, entry
from orb_slam2_test_tpu_torch.io import settings as tsettings
from orb_slam2_test_tpu_torch.io import trajectory as ttraj

torch.set_num_threads(2)

N_FRAMES = 6
REPORT_KEYS = {"metric", "n_cams", "n_pts", "n_obs", "iters", "device", "solve_s", "efficiency",
               "shard_solve_s", "partition_efficiency", "host_cores", "cpu_s",
               "work_efficiency"}


def _write_kitti(d: str, seed: int) -> None:
    """entry.band_sequence (640x480, bf 40) as a KITTI odometry stereo
    sequence: times.txt, image_0/, image_1/."""
    seq = entry.band_sequence(np.random.default_rng(seed), entry.RGBD_CAM, N_FRAMES, "cpu")
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    for i, (_, left, right) in enumerate(seq.frames):
        cv2.imwrite(os.path.join(d, "image_0", f"{i:06d}.png"), left.numpy())
        cv2.imwrite(os.path.join(d, "image_1", f"{i:06d}.png"), right.numpy())
    with open(os.path.join(d, "times.txt"), "w") as f:
        f.write("\n".join(f"{t:.6e}" for t, _, _ in seq.frames) + "\n")


def test_multi_seq_cli(tmp_path, capsys):
    cam = entry.RGBD_CAM
    settings = str(tmp_path / "band.yaml")
    tsettings.save_settings(tsettings.SlamSettings(
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf, width=cam.width,
        height=cam.height, fps=10.0, max_keyframes=64, max_points=16384,
        min_depth_init_points=300), settings)
    dirs = [str(tmp_path / f"seq{i}") for i in range(2)]
    for i, d in enumerate(dirs):
        _write_kitti(d, seed=3 + i)
    prefix = str(tmp_path / "traj")
    rc = cli.main(["multi_seq", "--seq", f"{settings}:{dirs[0]}", "--seq", f"{settings}:{dirs[1]}",
                   "--dataset", "kitti", "--sensor", "stereo", "--no-vocabulary",
                   "--joint-ba-every", "6", "--joint-ba-iters", "4", "--devices", "2",
                   "--traj-prefix", prefix, "--measure-scaling", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert "[multi_seq] 2 sequences, mesh of 2 device(s)" in lines
    joint = [ln for ln in lines if ln.startswith("[joint BA]")]
    # after 3 and 6 round-robin cycles (6 and 12 frames summed), and the final one
    assert len(joint) == 3, joint
    n_cams = [int(ln.split("cams=")[1].split()[0]) for ln in joint]
    assert all(n >= 4 for n in n_cams) and all("devices=2" in ln for ln in joint)
    assert any(ln.startswith(f"[multi_seq] {2 * N_FRAMES} frames total") and "fps aggregate" in ln
               for ln in lines)
    assert sum("state=OK" in ln for ln in lines) == 2
    for i in range(2):
        traj = ttraj.load_trajectory_tum(f"{prefix}_{i}.txt")
        assert len(traj) == N_FRAMES
        # the camera moves 2 bf / fx = 0.155 m to the right per frame
        x = [T[0, 3] for _, T in traj]
        np.testing.assert_allclose(np.diff(x), 2 * cam.baseline, atol=1e-2)
    report = json.loads(next(ln for ln in lines if ln.startswith("{")))
    assert set(report) == REPORT_KEYS
    assert set(report["solve_s"]) == {"1", "2", "4", "8"} and report["n_cams"] == n_cams[-1]


def test_dist_ba_scaling_synthetic(tmp_path, capsys):
    path = str(tmp_path / "scaling.json")
    rc = cli.main(["dist_ba_scaling", "--synthetic", "8", "300", "4", "--iters", "2",
                   "--repeats", "1", "--device", "cpu", "--out", path])
    assert rc == 0
    with open(path) as f:
        report = json.load(f)
    assert set(report) == REPORT_KEYS
    assert (report["n_cams"], report["n_pts"], report["iters"]) == (8, 300, 2)
    assert set(report["partition_efficiency"]) == {"1", "2", "4", "8"}
    assert report["efficiency"]["1"] == 1.0
    assert f"written to {path}" in capsys.readouterr().out
