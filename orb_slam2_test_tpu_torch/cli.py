"""Command-line driver: run a dataset sequence through the port.

    python -m orb_slam2_test_tpu_torch.cli DATASET SETTINGS SEQUENCE [options]

DATASET is one of mono_tum, mono_kitti, mono_euroc, stereo_kitti,
stereo_euroc, rgbd_tum (the reference's Examples/* mains and the JAX
package's examples/*.py). The loop loads each frame, tracks it through
`System.track_*`, prints timing and counts at the end, saves the
trajectories and, with --groundtruth, prints the ATE. `run(system, seq,
args)` is the loop itself, so a `Sequence` built in memory
(`io.datasets.MemorySequence`) can drive it; it returns the summary.

The engine runs on the card (--device cuda, the default) and raises
without one; --device cpu runs it on the CPU. Reading image files needs
OpenCV and reading a settings file PyYAML, both imported only then.
--vocabulary (default "default", the packaged artifact) turns on place
recognition: BoW relocalization after tracking loss and loop-candidate
detection; --no-vocabulary turns it off. Not ported yet: --viewer,
--live-viewer, --profile and --device-trace.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from orb_slam2_test_tpu_torch.evaluation import absolute_trajectory_error
from orb_slam2_test_tpu_torch.io import datasets
from orb_slam2_test_tpu_torch.io.trajectory import load_trajectory_tum
from orb_slam2_test_tpu_torch.system import MONOCULAR, RGBD, STEREO, System

DATASETS = {
    "mono_tum": MONOCULAR,
    "mono_kitti": MONOCULAR,
    "mono_euroc": MONOCULAR,
    "stereo_kitti": STEREO,
    "stereo_euroc": STEREO,
    "rgbd_tum": RGBD,
}
PREFETCH_DEPTH = 3


def add_common_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("settings", help="settings YAML (reference format)")
    p.add_argument("sequence", help="dataset sequence directory")
    p.add_argument("--vocabulary", default="default",
                   help="vocabulary path (.npz native or DBoW2 text); default: the "
                        "packaged artifact, so BoW relocalization is on")
    p.add_argument("--no-vocabulary", dest="vocabulary", action="store_const", const=None,
                   help="disable place recognition (no BoW relocalization)")
    p.add_argument("--traj-out", default="CameraTrajectory.txt")
    p.add_argument("--kf-traj-out", default="KeyFrameTrajectory.txt")
    p.add_argument("--kitti-traj", action="store_true",
                   help="save the trajectory in KITTI format")
    p.add_argument("--checkpoint-out", default=None, help="save the map (npz)")
    p.add_argument("--load-checkpoint", default=None)
    p.add_argument("--localization-only", action="store_true")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--groundtruth", default=None,
                   help="TUM-format ground truth: print the ATE at exit")
    p.add_argument("--diag", default=None, metavar="FILE",
                   help="write per-frame diagnostics (state, match/inlier "
                        "counts, map occupancy) as JSONL")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default cuda; cpu runs on the CPU)")
    return p


def common_parser(description: str) -> argparse.ArgumentParser:
    """The options every dataset driver takes."""
    return add_common_args(argparse.ArgumentParser(description=description))


def run(system: System, seq: datasets.Sequence, args, log=print) -> dict:
    """Track the sequence's frames, then save and evaluate. Returns the
    summary: frames, keyframes, lost frames, loops, relocalizations, the
    capacity growths ({"frame", "cap_kf", "cap_pt"} each), timing (host
    wall) and, with args.groundtruth, the ATE RMSE and its pair count."""
    n = len(seq) if args.max_frames is None else min(len(seq), args.max_frames)
    if args.load_checkpoint:
        system.load_checkpoint(args.load_checkpoint)
    if args.localization_only:
        system.activate_localization_mode()
    log(f"Processing {n} frames ({seq.kind}) ...")
    diag_fh = open(args.diag, "w") if args.diag is not None else None
    prev_state = system.tracking_state
    tracker = system.tracker
    items = seq.items[:n]
    # decode frames i+1..i+3 in a thread while frame i tracks
    prefetch: collections.deque = collections.deque()
    next_submit = 0
    t_start = time.perf_counter()
    try:
        with ThreadPoolExecutor(max_workers=1) as pool:
            for i in range(n):
                while len(prefetch) < PREFETCH_DEPTH and next_submit < n:
                    prefetch.append(pool.submit(seq.load, items[next_submit]))
                    next_submit += 1
                data = prefetch.popleft().result()
                t_f0 = time.perf_counter()
                if seq.kind == "mono":
                    system.track_monocular(data[1], data[0])
                elif seq.kind == "stereo":
                    system.track_stereo(data[1], data[2], data[0])
                else:
                    system.track_rgbd(data[1], data[2], data[0])
                t_frame = time.perf_counter() - t_f0
                if diag_fh is not None:
                    rec = {"frame": i, "t_frame_s": round(t_frame, 4),
                           "state": system.tracking_state,
                           "n_kf": tracker.stats["n_kf"], "n_live_kf": tracker.n_live_kf,
                           "cap_kf": tracker.cfg.max_keyframes,
                           "cap_pt": tracker.cfg.max_points}
                    rec.update((k, v) for k, v in tracker.last_diag.items()
                               if isinstance(v, (int, float, bool)))
                    diag_fh.write(json.dumps(rec) + "\n")
                    if system.tracking_state != prev_state:
                        log(f"  [diag] frame {i}: {prev_state} -> {system.tracking_state}")
                        prev_state = system.tracking_state
                if (i + 1) % 50 == 0:
                    st = system.timing_stats()
                    log(f"  frame {i + 1}/{n}  state={system.tracking_state}"
                        f"  kf={tracker.stats['n_kf']}  median={st['median_s'] * 1e3:.1f} ms")
    finally:
        if diag_fh is not None:
            diag_fh.close()
    wall = time.perf_counter() - t_start
    system.shutdown()

    st = system.timing_stats()
    stats = tracker.stats
    log("-" * 60)
    log(f"median tracking time: {st.get('median_s', 0) * 1e3:.2f} ms")
    log(f"mean tracking time:   {st.get('mean_s', 0) * 1e3:.2f} ms")
    log(f"wall time:            {wall:.1f} s ({n / max(wall, 1e-9):.1f} fps)")
    log(f"keyframes: {stats['n_kf']}  loops: {stats['loops']}  "
        f"relocs: {stats['reloc']}  lost frames: {stats['lost_frames']}")
    if args.kitti_traj:
        system.save_trajectory_kitti(args.traj_out)
    else:
        system.save_trajectory_tum(args.traj_out)
    system.save_keyframe_trajectory_tum(args.kf_traj_out)
    log(f"trajectory saved to {args.traj_out}")
    if args.checkpoint_out:
        system.save_checkpoint(args.checkpoint_out)
        log(f"map checkpoint saved to {args.checkpoint_out}")
    summary = {"frames": n, "keyframes": stats["n_kf"], "live_keyframes": tracker.n_live_kf,
               "lost_frames": stats["lost_frames"], "loops": stats["loops"],
               "relocs": stats["reloc"], "capacity_growth_events": list(tracker.growth_events),
               "wall_s": wall, "median_s": st.get("median_s"), "mean_s": st.get("mean_s")}
    if args.groundtruth:
        res = absolute_trajectory_error(
            tracker.export_trajectory(), load_trajectory_tum(args.groundtruth),
            with_scale=(seq.kind == "mono"),
        )
        log(f"ATE RMSE: {res['rmse']:.4f} m over {res['n_pairs']} pairs")
        summary.update(ate_rmse=res["rmse"], ate_pairs=res["n_pairs"])
    return summary


def load_sequence(dataset: str, args, system: System) -> datasets.Sequence:
    """The dataset's sequence, as the reference's mains load it."""
    if dataset == "mono_tum":
        return datasets.load_tum_mono(args.sequence)
    if dataset in ("mono_kitti", "stereo_kitti"):
        return datasets.load_kitti(args.sequence, stereo=dataset == "stereo_kitti")
    if dataset == "rgbd_tum":
        return datasets.load_tum_rgbd(
            args.sequence,
            depth_map_factor=float(system.settings.depth_map_factor or 5000.0),
            associations=args.associations,
        )
    seq = datasets.load_euroc(args.sequence, stereo=dataset == "stereo_euroc",
                              timestamps_file=args.timestamps)
    if dataset == "stereo_euroc":
        # rectify every pair (reference stereo_euroc.cc: remap with the
        # LEFT.*/RIGHT.* blocks of the settings file)
        if system.settings.rectification is None:
            raise SystemExit("settings file has no LEFT.*/RIGHT.* blocks")
        rectify = datasets.StereoRectifier(system.settings.rectification)
        load = seq.load

        def load_rectified(it):
            t, left, right = load(it)
            return (t,) + tuple(rectify(left, right))

        seq.load = load_rectified
    return seq


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m orb_slam2_test_tpu_torch.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="dataset", required=True)
    for name in DATASETS:
        sp = add_common_args(sub.add_parser(name))
        if name.endswith("euroc"):
            sp.add_argument("--timestamps", default=None)
        if name == "rgbd_tum":
            sp.add_argument("--associations", default=None)
    args = p.parse_args(argv)
    system = System(args.settings, DATASETS[args.dataset], vocabulary=args.vocabulary,
                    device=args.device)
    seq = load_sequence(args.dataset, args, system)
    run(system, seq, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
