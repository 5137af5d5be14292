"""Kernel 2's serial floor on one CUDA card: where an iteration's time goes.

    python3 examples/pose_opt_floor.py [--before CSRC_DIR] [--out DIR]

Builds orb_slam2_test_tpu_torch/csrc twice, as the package loads it and
with -DPOSE_OPT_CLOCKS (thread 0 of the cluster's first CTA adds the
clock64 cycles of each phase of an iteration, and the iterations'
nanoseconds on the global timer), and prints ptxas's register and spill
report of `pose_opt_kernel`. On the motion-only BA problems of
`entry.pose_problem` at O = 7 (one warp: the floor of the 40 dependent
iterations) and O = 2000 (a cluster of 8 CTAs) it then reports:

- the phase breakdown of one iteration, in cycles and in ns at the
  clock the global timer implies;
- the time of the `pose_opt` C entry point alone on prepared buffers
  (100 launches between two CUDA events, after warm-up), for the
  current sources and, with --before, for another csrc directory
  (for example an unpacked earlier commit), in the order before, now,
  now, before; both must agree on the pose within 1e-4.

Writes pose_opt_floor.json into --out (default runs/pose_opt_floor). Needs one
CUDA card and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PHASES = ("accumulate", "reduce-scatter", "CTA barrier + column sum",
          "cluster barrier (CTA's if one)", "cluster sums + broadcast", "LDL^T solve",
          "exp update (sincosf)", "reclassification + loop")
N_LOOP = 100


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _ptxas(log: str) -> list[str]:
    """ptxas's report lines of pose_opt_kernel from an `nvcc -Xptxas -v` log."""
    lines, mine = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            mine = "pose_opt_kernel" in line
        if mine and ("registers" in line or "spill" in line):
            lines.append(line.strip())
    return lines


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", type=Path, help="another csrc directory to time beside this one")
    ap.add_argument("--out", type=Path, default=Path("runs/pose_opt_floor"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pose_opt_floor: needs a CUDA card", file=sys.stderr)
        return 1

    from orb_slam2_test_tpu_torch import entry
    from orb_slam2_test_tpu_torch.solvers import pose_opt_cuda
    from orb_slam2_test_tpu_torch.utils import cuda_build

    card = _card_line()
    dev = torch.device("cuda", 0)
    builds = {"now": (cuda_build.CSRC, ()), "clocks": (cuda_build.CSRC, ("-DPOSE_OPT_CLOCKS",))}
    if args.before is not None:
        builds["before"] = (args.before.resolve(), ())
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as ex:
        futures = {k: ex.submit(cuda_build.build_library, *v) for k, v in builds.items()}
        infos = {k: f.result() for k, f in futures.items()}
    libs, result = {}, {"card": card, "ptxas": {}, "problems": {}}
    for name, info in infos.items():
        lib = ctypes.CDLL(str(info.path))
        fn = lib.pose_opt
        fn.argtypes = pose_opt_cuda.POSE_OPT.argtypes
        fn.restype = ctypes.c_int
        libs[name] = (lib, fn)
        result["ptxas"][name] = _ptxas(info.log)
        for line in result["ptxas"][name]:
            print(f"ptxas ({name}): {line}")
    clocks_fn = libs["clocks"][0].pose_opt_clocks
    clocks_fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    clocks_fn.restype = ctypes.c_int

    def launch(fn, a):
        rc = fn(*a)
        if rc != 0:
            raise RuntimeError(f"pose_opt: CUDA error {rc}")

    def loop_ms(fn, a):
        for _ in range(10):
            launch(fn, a)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(N_LOOP):
            launch(fn, a)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / N_LOOP

    for O in (7, 2000):
        cam, _, T0, X, obs = entry.pose_problem(np.random.default_rng(3), O)
        inputs = (torch.from_numpy(T0).to(dev), torch.from_numpy(X).to(dev),
                  torch.from_numpy(obs).to(dev), torch.ones(O, device=dev),
                  torch.ones(O, dtype=torch.bool, device=dev))
        a, outs = pose_opt_cuda.pose_opt_launch_args(cam, *inputs)
        n_iters = 40
        poses = {}
        for name in libs:
            launch(libs[name][1], a)
            torch.cuda.synchronize()
            poses[name] = outs[0].clone()
        for name in poses:
            gap = float((poses[name] - poses["now"]).abs().max())
            if gap > 1e-4:
                raise RuntimeError(f"O = {O}: pose of {name} differs from now by {gap}")
        buf = (ctypes.c_ulonglong * (len(PHASES) + 1))()
        if clocks_fn(buf) != 0:
            raise RuntimeError("pose_opt_clocks failed")
        cyc = [buf[i] / n_iters for i in range(len(PHASES))]
        ns_it = buf[len(PHASES)] / n_iters
        ghz = sum(cyc) / ns_it
        order = ["before", "now", "now", "before"] if "before" in libs else ["now", "now"]
        times = {}
        for name in order:
            times.setdefault(name, []).append(loop_ms(libs[name][1], a))
        clk_ms = loop_ms(libs["clocks"][1], a)
        print(f"O = {O}: one iteration {sum(cyc):.0f} cycles, {ns_it:.1f} ns "
              f"({ghz:.3f} GHz) in the clocks build, which takes {clk_ms:.4f} ms ({card})")
        for ph, c in zip(PHASES, cyc):
            print(f"    {ph:30s} {c:8.1f} cycles {c / ghz:8.1f} ns {c / sum(cyc):6.1%}")
        for name, t in times.items():
            print(f"    alone, {name}: " + " / ".join(f"{x:.4f}" for x in t) + f" ms ({card})")
        result["problems"][str(O)] = {
            "cycles_per_iteration": dict(zip(PHASES, cyc)), "ns_per_iteration": ns_it,
            "ghz": ghz, "clocks_build_ms": clk_ms, "alone_ms": times,
        }
    args.out.mkdir(parents=True, exist_ok=True)
    with open(os.path.join(args.out, "pose_opt_floor.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
