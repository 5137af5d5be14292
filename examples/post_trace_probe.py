"""Does a device trace leave the process slower? One CUDA card.

    python3 examples/post_trace_probe.py [--runs 2] [--out runs/post_trace_probe]

In a fresh process for each arm, 30 KITTI stereo frames of
`entry.kitti_live_frames` go through `System.track_stereo` (a System of
`entry.kitti_system`, the frames as float32 host arrays, as
chip_smoke.py [17]'s direct run), --runs times each: first, after a
`utils.profiling.device_trace` of CPU activities only over 10 frames of
another System, and after one of CPU and CUDA activities. The arms: as
the process starts; with TEARDOWN_CUPTI=1 in its environment (which
tells kineto to detach CUPTI at each trace's end); and a control that
tracks the same 10 frames with no trace at all. Each run makes its own
System and drops it, with a garbage collection, before the next; a
first run warms the libraries up. Prints each run's median ms a frame
on CUDA events and host wall, the seconds the garbage collector took
during the run and the objects it tracks after it, with the card's name
and power limit, and writes post_trace_probe.json to --out. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_FRAMES = 30
TRACED_FRAMES = 10
ARMS = {"no trace": {}, "default": {}, "TEARDOWN_CUPTI=1": {"TEARDOWN_CUPTI": "1"}}


def _direct_run(dev, live) -> dict:
    """The frames through one System, per frame CUDA events and host wall."""
    import torch

    from orb_slam2_test_tpu_torch import entry

    system = entry.kitti_system(dev)
    frames = [(ts, a.astype(np.float32), b.astype(np.float32)) for ts, a, b in live.frames]
    torch.cuda.synchronize()
    events, wall = [], []
    for ts, a, b in frames:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        system.track_stereo(a, b, ts)
        end.record()
        wall.append((time.perf_counter() - t0) * 1e3)
        events.append((start, end))
    system.shutdown()
    return {"event_ms": [s.elapsed_time(e) for s, e in events], "wall_ms": wall}


def _arm(runs: int, trace: bool) -> dict:
    """One process's runs: first, after a CPU-only trace, after a CUDA one
    (trace False: after the same frames tracked with no trace)."""
    import contextlib
    import gc

    import torch

    from orb_slam2_test_tpu_torch import entry
    from orb_slam2_test_tpu_torch.utils.precision import f32_matmuls
    from orb_slam2_test_tpu_torch.utils.profiling import device_trace

    f32_matmuls()
    dev = torch.device("cuda", 0)
    live = entry.kitti_live_frames(np.random.default_rng(4), N_FRAMES)

    gc_s = [0.0, 0.0]  # the collector's seconds in the run, its last start

    def timed_gc(phase: str, info: dict) -> None:
        if phase == "start":
            gc_s[1] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_s[1]

    gc.callbacks.append(timed_gc)

    def direct() -> dict:
        gc_s[0] = 0.0
        r = _direct_run(dev, live)
        out = {k: float(np.median(v)) for k, v in r.items()}
        out.update(gc_s=gc_s[0], gc_objects=len(gc.get_objects()))
        gc.collect()
        return out

    def traced(log_dir: str, cuda: bool) -> None:
        system = entry.kitti_system(dev)
        with device_trace(log_dir, cuda=cuda) if trace else contextlib.nullcontext():
            for ts, a, b in live.frames[:TRACED_FRAMES]:
                system.track_stereo(a.astype(np.float32), b.astype(np.float32), ts)
            torch.cuda.synchronize()
        system.shutdown()
        del system
        gc.collect()

    direct()
    out = {"first": [direct() for _ in range(runs)]}
    with tempfile.TemporaryDirectory() as tmp:
        traced(os.path.join(tmp, "cpu"), cuda=False)
        out["after_cpu_trace"] = [direct() for _ in range(runs)]
        traced(os.path.join(tmp, "cuda"), cuda=True)
        out["after_cuda_trace"] = [direct() for _ in range(runs)]
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--out", default="runs/post_trace_probe")
    p.add_argument("--arm-out", help=argparse.SUPPRESS)  # a worker process's JSON
    p.add_argument("--no-trace", dest="trace", action="store_false", help=argparse.SUPPRESS)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("post_trace_probe: needs a CUDA card", file=sys.stderr)
        return 1
    if args.arm_out:
        with open(args.arm_out, "w") as f:
            json.dump(_arm(args.runs, trace=args.trace), f)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    os.makedirs(args.out, exist_ok=True)
    result = {"card": card, "runs": args.runs, "arms": {}}
    for arm, env in ARMS.items():
        path = os.path.join(args.out, "arm.json")
        argv = [sys.executable, os.path.abspath(__file__), "--runs", str(args.runs),
                "--arm-out", path] + (["--no-trace"] if arm == "no trace" else [])
        proc = subprocess.run(argv, env={**os.environ, **env}, timeout=900)
        if proc.returncode != 0:
            print(f"post_trace_probe: the {arm} process failed ({proc.returncode})",
                  file=sys.stderr)
            return 1
        with open(path) as f:
            result["arms"][arm] = json.load(f)
        os.remove(path)
        print(f"{arm}: median ms a frame, CUDA events / host wall (collector s, objects), over "
              f"{N_FRAMES} frames ({card}): " + "; ".join(
                  f"{k} " + ", ".join(f"{r['event_ms']:.3f} / {r['wall_ms']:.3f} "
                                      f"({r['gc_s']:.3f}, {r['gc_objects']})" for r in v)
                  for k, v in result["arms"][arm].items()))
    with open(os.path.join(args.out, "post_trace_probe.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
