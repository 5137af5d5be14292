"""The port's CLI drivers for stereo and RGB-D, and the dataset loaders
they read through, on the CPU (the mono driver and the System:
tests/test_torch_system.py).

- the stereo_kitti and rgbd_tum drivers on `entry.band_sequence`
  (640x480, bf 40, 6 frames) written as KITTI odometry and TUM RGB-D
  files: the loaders list the same items as the JAX package's, every
  frame is tracked (depth initialization on the first), keyframes are
  inserted, and the camera's 0.155 m per frame comes out within 1 cm;
- the EuRoC loader: the same items as the JAX package's.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from orb_slam2_test_tpu.io import datasets as jdatasets
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.io import datasets as tdatasets
from orb_slam2_test_tpu_torch.io import settings as tsettings
from orb_slam2_test_tpu_torch.io import trajectory as ttraj

from test_torch_system import _cli

torch.set_num_threads(2)


def _write_band_datasets(d, n=6):
    """entry.band_sequence (640x480, bf 40) written as a KITTI odometry
    stereo sequence (times.txt, image_0/, image_1/) and as a TUM RGB-D
    one (rgb.txt, depth.txt, 16-bit depth at DepthMapFactor 5000), and a
    settings file for both (300 depth points start the map: the four
    bands give 485-508 stereo matches of 1000 features, around the
    default of 500)."""
    cam = entry.RGBD_CAM
    seq = entry.band_sequence(np.random.default_rng(3), cam, n, "cpu")
    _, depth = entry._band_views(np.random.default_rng(3), cam.height, cam.width, n,
                                 cam.bf / entry.STEREO_DISPARITY)
    kitti, tum = os.path.join(d, "kitti"), os.path.join(d, "tum")
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(kitti, sub), exist_ok=True)
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(tum, sub), exist_ok=True)
    rgb_rows, depth_rows = [], []
    for i, (t, left, right) in enumerate(seq.frames):
        cv2.imwrite(os.path.join(kitti, "image_0", f"{i:06d}.png"), left.numpy())
        cv2.imwrite(os.path.join(kitti, "image_1", f"{i:06d}.png"), right.numpy())
        cv2.imwrite(os.path.join(tum, "rgb", f"{i}.png"), left.numpy())
        cv2.imwrite(os.path.join(tum, "depth", f"{i}.png"), (depth * 5000).astype(np.uint16))
        rgb_rows.append(f"{1000 + t:.6f} rgb/{i}.png")
        depth_rows.append(f"{1000 + t + 0.001:.6f} depth/{i}.png")
    with open(os.path.join(kitti, "times.txt"), "w") as f:
        f.write("\n".join(f"{t:.6e}" for t, _, _ in seq.frames) + "\n")
    for name, rows in (("rgb.txt", rgb_rows), ("depth.txt", depth_rows)):
        with open(os.path.join(tum, name), "w") as f:
            f.write("# c\n" + "\n".join(rows) + "\n")
    s = tsettings.SlamSettings(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
                               width=cam.width, height=cam.height, fps=10.0,
                               depth_map_factor=5000.0, max_keyframes=64, max_points=16384,
                               min_depth_init_points=300)
    path = os.path.join(d, "band.yaml")
    tsettings.save_settings(s, path)
    return kitti, tum, path


@pytest.mark.parametrize("dataset", ["stereo_kitti", "rgbd_tum"])
def test_cli_runs_stereo_and_rgbd(dataset, tmp_path, capsys):
    """The stereo and RGB-D drivers of the CLI on the band sequence:
    the loaders equal the JAX package's, every frame tracks (depth
    initialization on the first), and keyframes are inserted."""
    kitti, tum, settings = _write_band_datasets(str(tmp_path))
    if dataset == "stereo_kitti":
        t_seq, j_seq = tdatasets.load_kitti(kitti, True), jdatasets.load_kitti(kitti, True)
        d = kitti
    else:
        t_seq, j_seq = tdatasets.load_tum_rgbd(tum), jdatasets.load_tum_rgbd(tum)
        d = tum
        _, _, dep = t_seq.load(t_seq.items[0])
        assert dep.dtype == np.float32 and 2.0 < np.median(dep[dep > 0]) < 6.0
    assert [(i.timestamp, i.paths) for i in t_seq.items] == \
        [(i.timestamp, i.paths) for i in j_seq.items]
    assert len(t_seq) == 6
    n_kf, lost, _ = _cli(capsys, dataset, settings, d, "--device", "cpu",
                         "--traj-out", str(tmp_path / "t.txt"),
                         "--kf-traj-out", str(tmp_path / "k.txt"))
    assert lost == 0 and n_kf >= 2
    traj = ttraj.load_trajectory_tum(str(tmp_path / "t.txt"))
    assert len(traj) == 6
    # the camera moves 2 bf / fx = 0.155 m to the right per frame
    x = [T[0, 3] for _, T in traj]
    np.testing.assert_allclose(np.diff(x), 2 * entry.RGBD_CAM.baseline, atol=1e-2)


def test_euroc_loader_matches_jax(tmp_path):
    cam0 = tmp_path / "mav0" / "cam0"
    (cam0 / "data").mkdir(parents=True)
    stamps = [1403636579763555584 + 50_000_000 * i for i in range(4)]
    (cam0 / "data.csv").write_text("#timestamp [ns],filename\n" + "".join(
        f"{s},{s}.png\n" for s in stamps))
    for stereo in (False, True):
        t = tdatasets.load_euroc(str(tmp_path), stereo=stereo)
        j = jdatasets.load_euroc(str(tmp_path), stereo=stereo)
        assert t.kind == j.kind
        assert [(i.timestamp, i.paths) for i in t.items] == \
            [(i.timestamp, i.paths) for i in j.items]
