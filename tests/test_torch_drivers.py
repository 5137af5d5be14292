"""The port's dataset drivers that no other test runs (mono_kitti,
mono_euroc, stereo_euroc) and its EuRoC rectification, on the CPU.

- mono_kitti, mono_euroc and stereo_euroc through `cli.main` on 6-frame
  datasets written by the port's `make_synth_data` (the first 6 frames
  of the full-length run's trajectory: the same step per frame), beside
  the JAX package's examples/mono_kitti.py, mono_euroc.py and
  stereo_euroc.py on the same files: the loaders list the same items,
  every frame after the initialization is tracked with 0 lost, at least
  2 keyframes, and the ATE within max(10%, 1 cm) of the JAX driver's
  (tests/test_torch_system.py's bound: the RANSAC draws differ).
  stereo_euroc reads the dataset's settings with identity LEFT.* /
  RIGHT.* blocks (`make_synth_data.write_rectified_settings`).
- `StereoRectifier` with configs/EuRoC.yaml's real blocks on one
  rendered pair: equal to the JAX package's, pixel for pixel.

A relocalization after a blackout read from files:
tests/test_torch_dataset_runs.py.
"""

import os
import re

import numpy as np
import pytest
import torch

from orb_slam2_test_tpu.io import datasets as jdatasets
from orb_slam2_test_tpu.io import settings as jsettings
from orb_slam2_test_tpu_torch import cli
from orb_slam2_test_tpu_torch.io import datasets as tdatasets
from orb_slam2_test_tpu_torch.io import settings as tsettings
from orb_slam2_test_tpu_torch.io.trajectory import load_trajectory_tum
from orb_slam2_test_tpu_torch.tools.make_synth_data import (
    full_step_revolutions,
    write_rectified_settings,
)

from test_torch_make_synth_data import ROOT, load_example, run_example

torch.set_num_threads(2)

N_FRAMES = 6
# the JAX package's full-length runs these datasets cut: frames of the
# default make_synth_data kitti / euroc datasets
FULL_FRAMES = {"kitti": 600, "euroc": 300}
# the driver -> (dataset kind, loader of both packages' io.datasets)
DRIVERS = {
    "mono_kitti": ("kitti", lambda ds, d: ds.load_kitti(d, stereo=False)),
    "mono_euroc": ("euroc", lambda ds, d: ds.load_euroc(d, stereo=False)),
    "stereo_euroc": ("euroc", lambda ds, d: ds.load_euroc(d, stereo=True)),
}


def _stats(out: str) -> tuple:
    """(keyframes, lost frames, relocs, ATE, ATE pairs) of a driver's
    printed summary (the JAX runner and the port's print the same
    lines)."""
    kf = int(re.search(r"keyframes: (\d+)", out).group(1))
    lost = int(re.search(r"lost frames: (\d+)", out).group(1))
    relocs = int(re.search(r"relocs: (\d+)", out).group(1))
    ate = re.search(r"ATE RMSE: (\S+) m over (\d+) pairs", out)
    return kf, lost, relocs, float(ate.group(1)), int(ate.group(2))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The 6-frame KITTI and EuRoC datasets, written through the CLI."""
    out = {}
    for kind, full in FULL_FRAMES.items():
        d = str(tmp_path_factory.mktemp(kind))
        assert cli.main(["make_synth_data", kind, "--out", d, "--frames", str(N_FRAMES),
                         "--revolutions", repr(full_step_revolutions(N_FRAMES, full)),
                         "--device", "cpu"]) == 0
        out[kind] = d
    return out


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_driver_matches_jax(datasets, driver, tmp_path, capsys):
    kind, load = DRIVERS[driver]
    d = datasets[kind]
    settings = os.path.join(d, "settings.yaml")
    if driver == "stereo_euroc":
        settings = write_rectified_settings(d)
    t_items = [(i.timestamp, i.paths) for i in load(tdatasets, d).items]
    assert t_items == [(i.timestamp, i.paths) for i in load(jdatasets, d).items]
    assert len(t_items) == N_FRAMES
    common = [settings, d, "--groundtruth", os.path.join(d, "groundtruth.txt"),
              "--no-vocabulary", "--kf-traj-out", str(tmp_path / "kf.txt")]
    capsys.readouterr()
    assert run_example(load_example(driver),
                       common + ["--traj-out", str(tmp_path / "jax.txt")]) == 0
    j = _stats(capsys.readouterr().out)
    assert cli.main([driver, *common, "--traj-out", str(tmp_path / "port.txt"),
                     "--device", "cpu"]) == 0
    t = _stats(capsys.readouterr().out)
    print(f"{driver}: port (keyframes, lost, relocs, ATE, pairs) {t}, JAX {j}")
    for kf, lost, relocs, ate, pairs in (t, j):
        assert kf >= 2 and lost == 0 and relocs == 0 and np.isfinite(ate)
    # every frame from the initialization on is in the trajectory
    first = N_FRAMES - t[4]
    traj = load_trajectory_tum(str(tmp_path / "port.txt"))
    np.testing.assert_allclose([ts for ts, _ in traj], [ts for ts, _ in t_items[first:]],
                               rtol=0, atol=1e-5)  # the file's 6 decimals
    assert t[4] == j[4]
    assert abs(t[3] - j[3]) <= max(0.1 * j[3], 0.01)


def test_stereo_rectifier_matches_jax(datasets):
    """configs/EuRoC.yaml's LEFT.* / RIGHT.* blocks (real distortion and
    rotation) on one rendered pair: the port's maps and pixels equal the
    JAX package's."""
    path = os.path.join(ROOT, "configs", "EuRoC.yaml")
    t_rect = tdatasets.StereoRectifier(tsettings.load_settings(path).rectification)
    j_rect = jdatasets.StereoRectifier(jsettings.load_settings(path).rectification)
    for a, b in zip(t_rect.m1l + t_rect.m1r, j_rect.m1l + j_rect.m1r):
        np.testing.assert_array_equal(a, b)
    _, left, right = tdatasets.load_euroc(datasets["euroc"], stereo=True).load(
        tdatasets.load_euroc(datasets["euroc"], stereo=True).items[0])
    t_out, j_out = t_rect(left, right), j_rect(left, right)
    for a, b, raw in zip(t_out, j_out, (left, right)):
        assert a.shape == raw.shape == (480, 752)
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, raw)  # the blocks do move the pixels
