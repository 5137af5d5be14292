"""Where the time of the PyTorch port's tracking step goes, on one GPU.

    python3 examples/profile_torch_step.py [--path mono|kitti-stereo]
        [--steps 10] [--out runs/profile_torch_step]

Runs one of the port's per-frame entry points under torch.profiler after
a warm-up:
- mono (default): `entry.tracking_step`, 640x480 / 1000 features /
  2048 map points;
- kitti-stereo: `entry.track_frame_step`, the whole per-frame program
  on one stereo frame at the KITTI configuration (1241x376 / 2000
  features, a map of 384 keyframes and 131072 points, 200 and 110000
  live) on `entry.kitti_scene`.
It reports per step: host wall time, device busy time (the union of the
kernels' intervals), the device's idle share, the number of kernel
launches, and the kernels and operators with the most device time.
Writes the summary to <out>/profile_torch_step[_kitti-stereo].json.
Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=["mono", "kitti-stereo"], default="mono")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default="runs/profile_torch_step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA card", file=sys.stderr)
        return 1

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from orb_slam2_test_tpu_torch import entry
    from orb_slam2_test_tpu_torch.utils.cuda_build import load_library

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    load_library()
    rng = np.random.default_rng(0)
    if args.path == "mono":
        img, scene, _, T_pred = entry.example_scene(rng, dev)
        state = entry.state_from_numpy(img, *scene, T_pred, device=dev)

        def step():
            entry.tracking_step(*state)
    else:
        inputs = entry.scene_inputs(entry.kitti_scene(rng, dev), dev)

        def step():
            entry.track_frame_step(*inputs)
    for _ in range(5):
        step()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = _busy_us(
        [(e.time_range.start, e.time_range.end) for e in kernels]
    ) / 1e3 / args.steps

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    table = sorted(prof.key_averages(), key=dev_us, reverse=True)
    top = [
        {"name": e.key, "device_ms_per_step": dev_us(e) / 1e3 / args.steps,
         "calls_per_step": e.count / args.steps}
        for e in table[:25] if dev_us(e) > 0
    ]
    summary = {
        "path": args.path,
        "card": card,
        "steps": args.steps,
        "host_wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches_per_step": len(kernels) / args.steps,
        "top_device_time": top,
    }
    os.makedirs(args.out, exist_ok=True)
    suffix = "" if args.path == "mono" else "_" + args.path
    with open(os.path.join(args.out, f"profile_torch_step{suffix}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "top_device_time"}))
    for row in top:
        print(f"{row['device_ms_per_step']:9.4f} ms {row['calls_per_step']:7.1f}x  {row['name'][:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
