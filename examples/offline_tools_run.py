"""The port's four offline tools at their full default sizes on one GPU.

    python3 examples/offline_tools_run.py [--workers N] [--data DIR]
        [--out runs/offline_tools]

Runs, through the tools' own entry points (orb_slam2_test_tpu_torch/tools/,
the CLI's subcommands of the same names), on the card:

1. `make_synth_data kitti` at its defaults (600 stereo frames at
   1241x376, radius 60 m, 1.08 laps, 6,000 landmarks) with --workers
   spawned processes, into --data (a temporary directory by default);
2. `build_vocab` at its defaults (24 scenes x 8 frames x 1,200 features,
   k = 10, L = 5);
3. `vocab_recall` on that dataset (--split 500 --stride 2) with the
   packaged L5 and L6 vocabularies and the one trained in 2;
4. `ba_window_sweep` on that dataset at windows 16, 32 and 64 over its
   600 frames.

Prints each tool's output and its wall seconds, the kernel launches of
each (kernel 1 patch_gather, kernel 2 pose_opt) and the card's name and
power limit, and writes offline_tools_run.json (the summary), the
vocabulary, vocab_recall.json and ba_window_sweep.json to --out after
each step. It needs a CUDA card and exits non-zero without one.
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


def main() -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    p.add_argument("--data", default=None, help="dataset directory (default: a temporary one)")
    p.add_argument("--out", default="runs/offline_tools")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("offline_tools_run: needs a CUDA card", file=sys.stderr)
        return 1

    from orb_slam2_test_tpu_torch import cli
    from orb_slam2_test_tpu_torch.bow.vocabulary import DEFAULT_VOCABULARY_PATH
    from orb_slam2_test_tpu_torch.ops import patches
    from orb_slam2_test_tpu_torch.solvers import pose_opt_cuda
    from orb_slam2_test_tpu_torch.tools import (
        ba_window_sweep,
        build_vocab,
        make_synth_data,
        vocab_recall,
    )
    from orb_slam2_test_tpu_torch.utils.precision import f32_matmuls

    f32_matmuls()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} ({card})", flush=True)
    os.makedirs(args.out, exist_ok=True)
    summary = {"card": card}

    def step(name: str, fn):
        patches.PATCH_GATHER.launches = 0
        pose_opt_cuda.POSE_OPT.launches = 0
        t0 = time.perf_counter()
        result = fn()
        if not isinstance(result, dict):
            if result != 0:
                raise RuntimeError(f"{name} returned {result}")
            result = {}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"patch_gather": patches.PATCH_GATHER.launches,
                    "pose_opt": pose_opt_cuda.POSE_OPT.launches}
        summary[name] = {"wall_s": wall, "launches": launches, **result}
        print(f"== {name}: {wall:.1f} s wall, launches {launches} ({card})", flush=True)
        with open(os.path.join(args.out, "offline_tools_run.json"), "w") as f:
            json.dump(summary, f, indent=1)

    parse = cli.build_parser().parse_args
    with tempfile.TemporaryDirectory() as tmp:
        data = args.data or os.path.join(tmp, "kitti00")
        step("make_synth_data", lambda: make_synth_data.main(parse(
            ["make_synth_data", "kitti", "--out", data, "--workers", str(args.workers)])))

        voc_path = os.path.join(args.out, "vocab_k10_L5.npz")

        def train():
            s = build_vocab.run(parse(["build_vocab", "--out", voc_path]))
            return {k: s[k] for k in ("n_descriptors", "distinct_words", "extract_s",
                                      "kmeans_s", "idf_s")} | {
                "frames": len(s["frames"]), "n_words": s["vocabulary"].n_words}

        step("build_vocab", train)

        packaged = os.path.dirname(os.path.normpath(DEFAULT_VOCABULARY_PATH))
        recall_json = os.path.join(args.out, "vocab_recall.json")
        step("vocab_recall", lambda: vocab_recall.main(parse(
            ["vocab_recall", data, "--vocab", os.path.join(packaged, "vocab_k10_L5.npz"),
             "--vocab", os.path.join(packaged, "vocab_k10_L6.npz"), "--vocab", voc_path,
             "--split", "500", "--stride", "2", "--out", recall_json])))

        sweep_json = os.path.join(args.out, "ba_window_sweep.json")
        step("ba_window_sweep", lambda: ba_window_sweep.main(parse(
            ["ba_window_sweep", data, "--out", sweep_json])))
    print(json.dumps(summary))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
