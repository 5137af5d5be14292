"""`ba_window_sweep` of the port (tools/ba_window_sweep.py) on the CPU.

- Tier-1, the port alone: `sweep_system` gives the Tracker its window
  (local_kf_cap and the local BA's n_local = n, n_fixed = max(8, n // 2),
  n_points = --ba-pt-cap), and `run_one` through the CLI writes one row
  per window on a short stereo sequence laid out as KITTI by this file's
  own helper (`entry.band_sequence` at 640x480, bf 40, 4 frames, 0.155 m
  per frame): every frame tracked, the ATE against the exact poses
  below 1 cm.
- `-m slow` (the JAX System's compiles at two windows take minutes):
  the port's rows against the JAX script's `run_one` on the same files,
  keyframes, loops and lost frames equal and the ATE within 1e-3 m; the
  timing fields are not compared.
"""

import json
import os

import numpy as np
import pytest
import torch

from orb_slam2_test_tpu_torch import cli, entry
from orb_slam2_test_tpu_torch.io import settings as tsettings
from orb_slam2_test_tpu_torch.io import trajectory as ttraj
from orb_slam2_test_tpu_torch.tools import ba_window_sweep

from test_torch_make_synth_data import load_example

torch.set_num_threads(2)

N_FRAMES = 4
WINDOWS = (4, 16)


def write_kitti_band(d: str, n: int = N_FRAMES) -> str:
    """`entry.band_sequence` (640x480, bf 40) as a KITTI odometry stereo
    dataset: times.txt, image_0/, image_1/, settings.yaml (1000 features,
    K = 64, P = 16,384, 300 depth points to start the map) and the exact
    poses as groundtruth.txt."""
    import cv2

    cam = entry.RGBD_CAM
    seq = entry.band_sequence(np.random.default_rng(3), cam, n, "cpu")
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    for i, (_, left, right) in enumerate(seq.frames):
        cv2.imwrite(os.path.join(d, "image_0", f"{i:06d}.png"), left.numpy())
        cv2.imwrite(os.path.join(d, "image_1", f"{i:06d}.png"), right.numpy())
    with open(os.path.join(d, "times.txt"), "w") as f:
        f.write("\n".join(f"{t:.6e}" for t, _, _ in seq.frames) + "\n")
    ttraj.save_trajectory_tum(os.path.join(d, "groundtruth.txt"),
                              [(t, T) for (t, _, _), T in zip(seq.frames, seq.T_true)])
    s = tsettings.SlamSettings(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
                               width=cam.width, height=cam.height, fps=10.0,
                               max_keyframes=64, max_points=16384,
                               min_depth_init_points=300)
    tsettings.save_settings(s, os.path.join(d, "settings.yaml"))
    return d


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_kitti_band(str(tmp_path_factory.mktemp("band") / "kitti"))


@pytest.fixture(scope="module")
def port_rows(dataset, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sweep") / "sweep.json")
    argv = ["ba_window_sweep", dataset, "--windows", *map(str, WINDOWS), "--ba-pt-cap", "2048",
            "--out", out, "--device", "cpu"]
    assert cli.main(argv) == 0
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("n_local", [4, 16, 32])
def test_window_reaches_the_tracker(dataset, n_local):
    settings = tsettings.load_settings(os.path.join(dataset, "settings.yaml"))
    system = ba_window_sweep.sweep_system(settings, n_local, 2048, max_kf=32, max_pt=8192,
                                          device="cpu")
    cfg = system.tracker.cfg
    caps = cfg.ba_caps
    assert cfg.local_kf_cap == caps.n_local == n_local
    assert cfg.ba_fixed_cap == caps.n_fixed == max(8, n_local // 2)
    assert cfg.ba_pt_cap == caps.n_points == 2048
    assert (cfg.max_keyframes, cfg.max_points) == (32, 8192)
    assert system.vocabulary is not None and system.tracker.loop_closer is not None


def test_sweep_rows(port_rows, dataset):
    assert port_rows["metric"] == "local_ba_window_sweep" and port_rows["dataset"] == dataset
    rows = port_rows["rows"]
    assert [r["n_local"] for r in rows] == list(WINDOWS)
    for r in rows:
        assert set(r) == {"n_local", "frames", "ate_rmse_m", "ate_pairs", "keyframes", "loops",
                          "lost_frames", "median_frame_ms", "wall_s"}
        assert r["frames"] == r["ate_pairs"] == N_FRAMES
        assert r["lost_frames"] == 0 and r["loops"] == 0 and r["keyframes"] >= 2
        assert r["ate_rmse_m"] < 0.01


@pytest.mark.slow
def test_sweep_rows_match_jax(port_rows, dataset):
    mod = load_example("ba_window_sweep")
    for row in port_rows["rows"]:
        j = mod.run_one(dataset, row["n_local"], None, 2048)
        print(f"n_local {row['n_local']}: port {row}, JAX {j}")
        for key in ("n_local", "frames", "ate_pairs", "keyframes", "loops", "lost_frames"):
            assert row[key] == j[key], key
        assert abs(row["ate_rmse_m"] - j["ate_rmse_m"]) <= 1e-3
