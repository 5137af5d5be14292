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
- multi_seq --multihost on the same two sequences in two processes
  joined by gloo (SLAM_COORDINATOR / SLAM_NUM_PROCS / SLAM_PROC_ID, as
  tests/test_torch_dist_ba.py launches its ranks): both ranks print the
  same joint BAs on a mesh of 2, and their trajectories equal a
  one-process run on 2 shards within 1e-5 (that file's gloo bound).
- dist_ba_scaling --synthetic C P O: the report's keys and shard counts.
"""

import json
import os
import socket
import subprocess
import sys

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


def _write_two_sequences(tmp_path) -> tuple[str, list]:
    """The band settings and two 6-frame sequences (seeds 3 and 4)."""
    cam = entry.RGBD_CAM
    settings = str(tmp_path / "band.yaml")
    tsettings.save_settings(tsettings.SlamSettings(
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf, width=cam.width,
        height=cam.height, fps=10.0, max_keyframes=64, max_points=16384,
        min_depth_init_points=300), settings)
    dirs = [str(tmp_path / f"seq{i}") for i in range(2)]
    for i, d in enumerate(dirs):
        _write_kitti(d, seed=3 + i)
    return settings, dirs


def test_multi_seq_cli(tmp_path, capsys):
    cam = entry.RGBD_CAM
    settings, dirs = _write_two_sequences(tmp_path)
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


RANK = """
import sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, {root!r})
from orb_slam2_test_tpu_torch import cli
sys.exit(cli.main({argv!r} + ["--traj-prefix"] + sys.argv[1:]))
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_multi_seq_cli_multihost(tmp_path):
    settings, dirs = _write_two_sequences(tmp_path)
    argv = ["multi_seq", "--seq", f"{settings}:{dirs[0]}", "--seq", f"{settings}:{dirs[1]}",
            "--dataset", "kitti", "--sensor", "stereo", "--no-vocabulary",
            "--joint-ba-every", "6", "--joint-ba-iters", "4", "--device", "cpu"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "rank.py"
    script.write_text(RANK.format(root=root, argv=argv))
    port = _free_port()
    # two ranks, and the one-process run on 2 shards with the ranks' one
    # thread (the tracking's float sums depend on the thread count)
    runs = [(["rank0", "--multihost"], {"SLAM_PROC_ID": "0"}),
            (["rank1", "--multihost"], {"SLAM_PROC_ID": "1"}),
            (["one", "--devices", "2"], {"SLAM_NUM_PROCS": "1"})]
    procs = []
    for extra, env in runs:
        env = {**os.environ, "SLAM_COORDINATOR": f"127.0.0.1:{port}", "SLAM_NUM_PROCS": "2",
               **env}
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(tmp_path / extra[0]), *extra[1:]], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    results = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=240)
            results.append((p.returncode, so.decode(), se.decode()))
    finally:
        for p in procs:
            p.kill()
    for rc, so, se in results:
        assert rc == 0, so[-2000:] + se[-4000:]
    joint = [[ln for ln in so.splitlines() if ln.startswith("[joint BA]")]
             for _, so, _ in results]
    # cams, pts, obs and cost; the solve's time differs
    same = [[ln.split(" solve=")[0] for ln in run] for run in joint]
    print("\n".join(joint[0]))
    assert len(joint[0]) == 3 and same[0] == same[1] == same[2]
    assert all(ln.endswith("devices=2") for run in joint for ln in run)
    assert "[multi_seq] 2 sequences, mesh of 2 device(s)" in results[0][1].splitlines()
    for i in range(2):
        ref = ttraj.load_trajectory_tum(str(tmp_path / f"one_{i}.txt"))
        for rank in range(2):
            got = ttraj.load_trajectory_tum(str(tmp_path / f"rank{rank}_{i}.txt"))
            assert [t for t, _ in got] == [t for t, _ in ref]
            np.testing.assert_allclose(np.stack([T for _, T in got]),
                                       np.stack([T for _, T in ref]), atol=1e-5)


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
