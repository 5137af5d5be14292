"""tools/dataset_runs (the dataset commands on `make_synth_data`'s
datasets, as chip_smoke.py [19] and examples/dataset_drivers_run.py run
them) and `evaluation.aligned_errors`, on the CPU.

- mono_tum on a 36-frame TUM mono dataset blacked out at frames 26-30,
  with the default vocabulary: LOST on exactly those 5 frames, 1
  relocalization on frame 31, no kernel launch counted on the CPU, and
  the relocalized frame no farther from the truth than the farthest
  frame tracked before the blackout, after the trajectory's Sim3
  alignment (these short monocular maps are tens of centimetres off
  before any blackout). Fewer frames before the blackout leave 5
  keyframes or fewer when the initialization's RANSAC draw fails on
  frame 1 (the port's seeded draw does on this scene, and its Tracker
  initializes on frame 6, where the JAX package's starts on frame 1;
  tests/test_torch_init_frame.py), and the Tracker then resets instead
  of relocalizing, as the reference does.
- `aligned_errors`: the ATE's own alignment, pose by pose; the ATE
  stays the JAX package's.
"""

import os

import numpy as np
import torch

from orb_slam2_test_tpu.evaluation import ate as jate
from orb_slam2_test_tpu_torch.evaluation import absolute_trajectory_error, aligned_errors
from orb_slam2_test_tpu_torch.io.trajectory import load_trajectory_tum
from orb_slam2_test_tpu_torch.tools import dataset_runs

torch.set_num_threads(2)

BLACKOUT = (36, 26)  # frames, first of dataset_runs.BLACKOUT_LEN blank frames


def test_blackout_relocalizes_from_files(tmp_path):
    """Through tools/dataset_runs, as chip_smoke.py [19] runs it."""
    n, at = BLACKOUT
    d = str(tmp_path / "tum")
    dataset_runs.finish_dataset(dataset_runs.start_dataset("tum-mono", d, n, at), "tum-mono",
                                d, timeout=300)
    run = dataset_runs.run_driver("mono_tum", d, str(tmp_path), device="cpu")
    print(f"blackout at {at}: {run['keyframes']} keyframes, {run['lost_frames']} lost at "
          f"{run['lost_at']}, relocalized {run['relocalized']}, ATE {run['ate_rmse']:.4f} m "
          f"over {run['ate_pairs']} pairs")
    blank = list(range(at, at + dataset_runs.BLACKOUT_LEN))
    assert run["lost_frames"] == len(blank) and run["lost_at"] == blank
    assert run["relocs"] == 1 and [r["frame"] for r in run["relocalized"]] == [blank[-1] + 1]
    assert run["launches_per_frame"] == [(0, 0)] * n  # the CPU launches no kernel
    times, err, _ = aligned_errors(load_trajectory_tum(run["paths"]["traj.txt"]),
                                   load_trajectory_tum(os.path.join(d, "groundtruth.txt")),
                                   with_scale=True)
    before = float(err[times < run["timestamps"][at]].max())
    assert run["relocalized"][0]["err_m"] <= before


def test_aligned_errors_are_the_ate():
    """aligned_errors is absolute_trajectory_error's alignment pose by
    pose; with 0 or 1 pairs the ATE stays the JAX package's."""
    rng = np.random.default_rng(5)
    est, gt = [], []
    for i in range(12):
        T = np.eye(4)
        T[:3, 3] = rng.normal(size=3)
        est.append((100.0 + 0.1 * i, T))
        G = np.eye(4)
        G[:3, 3] = -2.0 * T[:3, 3] + rng.normal(0, 0.01, 3) + 1.0
        gt.append((100.0 + 0.1 * i + 0.001, G))
    for scale in (False, True):
        times, err, s = aligned_errors(est, gt, with_scale=scale)
        res = absolute_trajectory_error(est, gt, with_scale=scale)
        assert res == jate.absolute_trajectory_error(est, gt, with_scale=scale)
        np.testing.assert_array_equal(times, [t for t, _ in est])
        assert float(np.sqrt((err ** 2).mean())) == res["rmse"] and s == res["scale"]
    for k in (0, 1):
        assert absolute_trajectory_error(est[:k], gt) == \
            jate.absolute_trajectory_error(est[:k], gt)
