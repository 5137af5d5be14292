"""The port's multi-lap KITTI-geometry loop run on one GPU.

    python3 examples/kitti_loop_run.py [--frames 1200] [--radius 60]
        [--revolutions 2] [--max-keyframes 128] [--max-points 49152]
        [--workers N] [--out runs/kitti_loop_run]

Renders the stereo loop of examples/make_synth_data.py's `kitti` into
memory (1241x376, 6,000 textured quads lining a circular corridor, a
process per core), then drives it through the port's `cli.run` with the
packaged vocabulary and small starting capacities, so that loops close
and the map grows, as the JAX package's runs/kitti00_full did
(`orb_slam2_test_tpu_torch.entry.kitti_loop_run`). Prints the summary
(frames, lost frames, loops, capacity growths, keyframes, ATE against
the rendered truth, median and mean ms per frame on the host clock, the
loop frames' ms) beside that run's `summary.json`, the card's name and
power limit, and writes the summary and the per-frame diagnostics to
--out. It needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frames", type=int, default=1200)
    p.add_argument("--radius", type=float, default=60.0)
    p.add_argument("--revolutions", type=float, default=2.0)
    p.add_argument("--max-keyframes", type=int, default=128)
    p.add_argument("--max-points", type=int, default=49152)
    p.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    p.add_argument("--out", default="runs/kitti_loop_run")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("kitti_loop_run: needs a CUDA card", file=sys.stderr)
        return 1

    from orb_slam2_test_tpu_torch import entry
    from orb_slam2_test_tpu_torch.utils.precision import f32_matmuls

    f32_matmuls()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    os.makedirs(args.out, exist_ok=True)
    summary = entry.kitti_loop_run(
        frames=args.frames, radius=args.radius, revolutions=args.revolutions,
        max_keyframes=args.max_keyframes, max_points=args.max_points, workers=args.workers,
        diag=os.path.join(args.out, "kitti_loop_run_diag.jsonl"))
    ms = summary["frame_ms"]
    summary.update(card=card, median_track_ms=statistics.median(ms),
                   mean_track_ms=statistics.mean(ms))
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "runs",
                           "kitti00_full", "summary.json")) as f:
        ref = json.load(f)
    keys = ("frames", "lost_frames", "loops", "keyframes", "ate_rmse_m")
    port = dict(frames=summary["frames"], lost_frames=summary["lost_frames"],
                loops=summary["loops"], keyframes=summary["keyframes"],
                ate_rmse_m=summary.get("ate_rmse"))
    print(f"port ({card}): " + ", ".join(f"{k} {port[k]}" for k in keys)
          + f", growths {summary['capacity_growth_events']}")
    print("JAX runs/kitti00_full (a TPU run; counts and ATE only): "
          + ", ".join(f"{k} {ref[k]}" for k in keys)
          + f", growths {ref['capacity_growth_events']}")
    print(f"median {summary['median_track_ms']:.1f} ms/frame, mean "
          f"{summary['mean_track_ms']:.1f} ms/frame (host wall, {card}); loop frames "
          f"{[(x['frame'], round(x['ms'], 1)) for x in summary['loop_frames']]}; render "
          f"{summary['render_s']:.1f} s")
    with open(os.path.join(args.out, "kitti_loop_run.json"), "w") as f:
        json.dump(summary, f)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
