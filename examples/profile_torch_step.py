"""Where the time of the PyTorch port's tracking step goes, on one GPU.

    python3 examples/profile_torch_step.py
        [--path mono|kitti-stereo|kitti-insert|kitti-sequence|kitti-loop]
        [--steps 10] [--out runs/profile_torch_step]

Runs one of the port's entry points under torch.profiler after a
warm-up:
- mono (default): `entry.tracking_step`, 640x480 / 1000 features /
  2048 map points;
- kitti-stereo: `entry.track_frame_step`, the whole per-frame program
  on one stereo frame at the KITTI configuration (1241x376 / 2000
  features, a map of 384 keyframes and 131072 points, 200 and 110000
  live) on `entry.kitti_scene`;
- kitti-insert: `entry.grow_map_step`, one full and one light keyframe
  insert at the JAX bench's inputs (its bench map at the KITTI
  configuration, a frame of two random images, T = I, random links,
  frame id 99), each profiled on its own;
- kitti-sequence: one step is a whole `entry.kitti_sequence` of 30
  stereo frames through a fresh `entry.kitti_system` (the host Tracker:
  initialization, the fused frames, its own keyframe inserts), so the
  per-frame figures are the step's over 30;
- kitti-loop: the loop correction `_correct_loop_device` and one global
  BA chunk (`bundle_adjust_partial`, 4 robust LM steps) at the KITTI
  capacities (K = 384, N = 2000, P = 131072) on
  `entry.synthetic_loop_map` (22 live keyframes, keyframe 21 closing
  on keyframe 1), each profiled on its own.
It reports per step: host wall time, device busy time (the union of the
kernels' intervals), the device's idle share, the number of kernel
launches, and the kernels and operators with the most device time.
Writes the summary to <out>/profile_torch_step[_<path>].json.
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


def profile_steps(step, steps: int, card: str) -> dict:
    """step() `steps` times under torch.profiler after a warm-up: host
    wall, device busy and idle share, launches and top operators, per
    step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = _busy_us(
        [(e.time_range.start, e.time_range.end) for e in kernels]
    ) / 1e3 / steps

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    table = sorted(prof.key_averages(), key=dev_us, reverse=True)
    return {
        "card": card,
        "steps": steps,
        "host_wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches_per_step": len(kernels) / steps,
        "top_device_time": [
            {"name": e.key, "device_ms_per_step": dev_us(e) / 1e3 / steps,
             "calls_per_step": e.count / steps}
            for e in table[:25] if dev_us(e) > 0
        ],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=["mono", "kitti-stereo", "kitti-insert", "kitti-sequence",
                                       "kitti-loop"],
                    default="mono")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default="runs/profile_torch_step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA card", file=sys.stderr)
        return 1

    from orb_slam2_test_tpu_torch import entry
    from orb_slam2_test_tpu_torch.engine.frame import build_frame_stereo
    from orb_slam2_test_tpu_torch.slam_map.covisibility import build_observer_bitmap
    from orb_slam2_test_tpu_torch.utils.cuda_build import load_library

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    load_library()
    rng = np.random.default_rng(0)
    steps = {}
    if args.path == "mono":
        img, scene, _, T_pred = entry.example_scene(rng, dev)
        state = entry.state_from_numpy(img, *scene, T_pred, device=dev)
        steps["mono"] = lambda: entry.tracking_step(*state)
    elif args.path == "kitti-stereo":
        inputs = entry.scene_inputs(entry.kitti_scene(rng, dev), dev)
        steps["kitti-stereo"] = lambda: entry.track_frame_step(*inputs)
    elif args.path == "kitti-sequence":
        seq = entry.kitti_sequence(rng, 30, dev)

        def run_sequence():
            system = entry.kitti_system(dev)
            for frame in seq.frames:
                entry.sequence_step(system, frame)
            system.shutdown()

        steps["kitti-sequence"] = run_sequence
    elif args.path == "kitti-loop":
        from orb_slam2_test_tpu_torch.engine import loop_closing as lc
        from orb_slam2_test_tpu_torch.solvers import ba_core
        from orb_slam2_test_tpu_torch.utils.precision import f32_matmuls

        f32_matmuls()
        cfg = entry.KITTI_CFG
        m_np, T_true = entry.synthetic_loop_map(K=cfg.max_keyframes, N=cfg.n_features,
                                                P=cfg.max_points)
        m = entry.map_from_numpy(m_np, dev)
        cam = entry.LOOP_MAP_CAM
        S12 = torch.from_numpy((T_true[21] @ np.linalg.inv(T_true[1])).astype(np.float32)).to(dev)
        kf, cand = torch.tensor(21, device=dev), torch.tensor(1, device=dev)
        corrected = lc._correct_loop_device(cam, m, kf, cand, S12, True)
        prob = lc.LoopCloser._build_gba_prob(corrected)
        lam = torch.full((), 1e-4, device=dev)
        cost0 = ba_core._robust_cost(prob, cam)
        active = torch.ones_like(prob.obs_valid)
        steps["correction"] = lambda: lc._correct_loop_device(cam, m, kf, cand, S12, True)
        steps["gba-chunk"] = lambda: ba_core.bundle_adjust_partial(prob, cam, lam, cost0,
                                                                   active, iters=4)
    else:
        cam, cfg = entry.KITTI_CAM, entry.KITTI_CFG
        m = entry.map_from_numpy(entry.bench_map(cfg, entry.KITTI_N_KF, entry.KITTI_N_PT), dev)
        bm = build_observer_bitmap(m)
        img_l, img_r = (torch.tensor(rng.uniform(0, 255, (cam.height, cam.width)),
                                     dtype=torch.float32, device=dev) for _ in range(2))
        feat = torch.tensor(rng.integers(-1, 40000, cfg.n_features), dtype=torch.int32,
                            device=dev)
        frame = build_frame_stereo(img_l, img_r, 0.0, cam, n_features=cfg.n_features)
        close_depth = cfg.th_depth * cam.baseline
        eye = torch.eye(4, device=dev)
        for name, rebuild in (("full", True), ("light", False)):
            steps[name] = (lambda rebuild=rebuild: entry.grow_map_step(
                m, bm, frame, eye, feat, 0.0, 99, close_depth, rebuild))

    summary = {"path": args.path}
    for name, step in steps.items():
        summary[name] = profile_steps(step, args.steps, card)
        print(name, json.dumps({k: v for k, v in summary[name].items()
                                if k != "top_device_time"}))
        for row in summary[name]["top_device_time"]:
            print(f"{row['device_ms_per_step']:9.4f} ms {row['calls_per_step']:7.1f}x  "
                  f"{row['name'][:90]}")
    os.makedirs(args.out, exist_ok=True)
    suffix = "" if args.path == "mono" else "_" + args.path
    with open(os.path.join(args.out, f"profile_torch_step{suffix}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
