"""The port's dataset commands at the JAX package's recorded lengths on
one GPU, beside the JAX package's recorded runs.

    python3 examples/dataset_drivers_run.py [--workers N] [--out runs/dataset_drivers]

Writes four datasets with `make_synth_data` (in processes of their own,
at once): EuRoC at its defaults (300 frames, 752x480, 3,000 landmarks,
radius 15 m), TUM mono and TUM RGB-D at 360 frames with 5 blank frames
from frame 300 (the JAX runs' blackout), and KITTI at its defaults (600
stereo frames at 1241x376, --workers render processes). Then runs,
through `cli.main` on the card (tools/dataset_runs.run_driver):

- mono_euroc, mono_tum and rgbd_tum, each with the JAX package's L5
  vocabulary (orb_slam2_test_tpu/data/vocab_k10_L5.npz, read by its
  path) and the default L6: the runs of runs/euroc_mh01_synth,
  runs/tum_mono_synth, runs/tum_rgbd_synth and runs/r04/*.log;
- stereo_euroc (L5, L6) on the EuRoC dataset, through identity LEFT.* /
  RIGHT.* blocks, and mono_kitti (L6) on the KITTI dataset's image_0
  (the JAX package recorded neither).

The datasets are the port's: below a radius of 57.14 m (EuRoC, TUM) each
quad faces the path 0.35 rad of arc back, as in every recorded JAX run,
and every settings file holds make_synth_data's
`Tracker.maxFramesBetweenKF: 5`, which only runs/r04/tum_rgbd.log had.

For each run it prints frames, lost, relocs, loops, keyframes, the ATE
(Sim3-aligned for a monocular run), the median and p90 host ms a frame,
the relocalizing frame's ms and error, the kernels' launches and the JAX
run's figures beside them with its keyframe cap and quads' offset, with
the card's name and power limit, and writes dataset_drivers_run.json
(and each run's trajectory, diag and summary) to --out. The datasets go
to a temporary directory. It needs a CUDA card and exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L5 = os.path.join(ROOT, "orb_slam2_test_tpu", "data", "vocab_k10_L5.npz")
L6 = os.path.join(ROOT, "orb_slam2_test_tpu", "data", "vocab_k10_L6.npz")
# (driver, vocabulary name) -> the JAX package's recorded run on a TPU
# (its log): whether its settings capped the keyframe interval at 5, its
# quads' viewpoint offset in rad (0.35 before commit 4e42fb9), frames,
# lost, relocs, loops, keyframes, ATE. The runs/*_synth runs came before
# the cap (commit dd5b592) and runs/r04's EuRoC and TUM mono logs too;
# runs/r04/tum_rgbd.log ran with it
JAX_RUNS = {
    ("mono_euroc", "L5"): ("runs/euroc_mh01_synth/run.log", False, 0.35, 300, 0, 0, 0, 35,
                           1.0029),
    ("mono_euroc", "L6"): ("runs/r04/euroc_mono.log", False, 0.35, 300, 0, 0, 0, 34, 0.9353),
    ("mono_tum", "L5"): ("runs/tum_mono_synth/run.log", False, 0.35, 360, 5, 1, 1, 40, 0.1871),
    ("mono_tum", "L6"): ("runs/r04/tum_mono.log", False, 0.35, 360, 5, 1, 1, 40, 0.1645),
    ("rgbd_tum", "L5"): ("runs/tum_rgbd_synth/run.log", False, 0.35, 360, 5, 1, 0, 41, 0.5686),
    ("rgbd_tum", "L6"): ("runs/r04/tum_rgbd.log", True, 0.35, 360, 5, 1, 1, 73, 0.4509),
    ("stereo_euroc", "L5"): None,
    ("stereo_euroc", "L6"): None,
    ("mono_kitti", "L6"): None,
}
JAX_FIELDS = ("source", "cap", "offset_rad", "frames", "lost", "relocs", "loops", "keyframes",
              "ate_m")


def main() -> int:
    import numpy as np
    import torch

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workers", type=int, default=max(1, (os.cpu_count() or 1) - 3),
                   help="KITTI's render processes")
    p.add_argument("--out", default="runs/dataset_drivers")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("dataset_drivers_run: needs a CUDA card", file=sys.stderr)
        return 1

    from orb_slam2_test_tpu_torch.tools import dataset_runs
    from orb_slam2_test_tpu_torch.utils.precision import f32_matmuls

    f32_matmuls()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} ({card})", flush=True)
    os.makedirs(args.out, exist_ok=True)
    summary = {"card": card, "runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = {}
        for kind, (_, at) in dataset_runs.FULL.items():
            log = open(os.path.join(args.out, f"make_synth_data_{kind}.log"), "w")
            procs[kind] = (dataset_runs.start_dataset(
                kind, os.path.join(tmp, kind), blackout_at=at,
                workers=args.workers if kind == "kitti" else 1, log=log), log)
        try:
            for kind, (proc, log) in procs.items():
                dataset_runs.finish_dataset(proc, kind, os.path.join(tmp, kind), timeout=1800)
                log.close()
        finally:
            for proc, _ in procs.values():
                proc.kill()
        summary["datasets_s"] = time.perf_counter() - t0
        print(f"== datasets written in {summary['datasets_s']:.1f} s", flush=True)

        for (driver, voc), jax_run in JAX_RUNS.items():
            kind = dataset_runs.DRIVERS[driver][0]
            tag = f"{driver}_{voc}"
            t0 = time.perf_counter()
            r = dataset_runs.run_driver(driver, os.path.join(tmp, kind), args.out,
                                        vocabulary=L5 if voc == "L5" else L6, tag=tag)
            wall = time.perf_counter() - t0
            ms = np.asarray(r["frame_s"]) * 1e3
            row = {"frames": r["frames"], "lost": r["lost_frames"], "lost_at": r["lost_at"],
                   "relocs": r["relocs"], "loops": r["loops"], "keyframes": r["keyframes"],
                   "ate_m": r["ate_rmse"], "ate_pairs": r["ate_pairs"],
                   "median_ms": float(np.median(ms)), "p90_ms": float(np.percentile(ms, 90)),
                   "mean_ms": float(np.mean(ms)), "relocalized": r["relocalized"],
                   "launches": [int(x) for x in np.sum(r["launches_per_frame"], axis=0)],
                   "capacity_growth_events": r["capacity_growth_events"], "wall_s": wall}
            if jax_run is not None:
                row["jax"] = dict(zip(JAX_FIELDS, jax_run))
            summary["runs"][tag] = row
            jax = ("no JAX run" if jax_run is None else
                   f"JAX ({row['jax']['source']}, TPU; offset {row['jax']['offset_rad']} rad, "
                   f"{'cap 5' if row['jax']['cap'] else 'no cap'}): {row['jax']['frames']} frames, "
                   f"{row['jax']['lost']} lost, {row['jax']['relocs']} relocs, "
                   f"{row['jax']['loops']} loops, {row['jax']['keyframes']} keyframes, ATE "
                   f"{row['jax']['ate_m']} m")
            print(f"== {tag}: {row['frames']} frames, {row['lost']} lost at {row['lost_at']}, "
                  f"{row['relocs']} relocs {row['relocalized']}, {row['loops']} loops, "
                  f"{row['keyframes']} keyframes, ATE {row['ate_m']:.4f} m over "
                  f"{row['ate_pairs']} pairs; median {row['median_ms']:.1f}, p90 "
                  f"{row['p90_ms']:.1f}, mean {row['mean_ms']:.1f} ms a frame host wall; "
                  f"launches {row['launches']}; {wall:.1f} s ({card}); {jax}", flush=True)
            with open(os.path.join(args.out, "dataset_drivers_run.json"), "w") as f:
                json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
