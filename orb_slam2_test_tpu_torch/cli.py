"""Command-line driver: run a dataset sequence or a live stream through
the port.

    python -m orb_slam2_test_tpu_torch.cli COMMAND ... [options]

Dataset commands: mono_tum, mono_kitti, mono_euroc, stereo_kitti,
stereo_euroc, rgbd_tum SETTINGS SEQUENCE (the reference's Examples/*
mains and the JAX package's examples/*.py). The loop loads each frame,
tracks it through `System.track_*`, prints timing and counts at the
end, saves the trajectories and, with --groundtruth, prints the ATE.
`run(system, seq, args)` is the loop itself, so a `Sequence` built in
memory (`io.datasets.MemorySequence`) can drive it; it returns the
summary.

Live commands: live_mono, live_stereo, live_rgbd SETTINGS (the JAX
package's examples/live_*.py, the reference's ROS nodes): frames from
a spool directory (--spool, --spool2) or TCP (--port, --port2, the
`io.live.SocketSource` wire format), stereo and RGB-D pairs matched by
`io.live.ApproximateTimeSync` (--sync-slop), until the producer ends
the stream or --idle-timeout passes without a frame. `run_live(system,
source, kind, args)` is that loop, for sources built in memory too.

`ar` SETTINGS SEQUENCE (examples/ar_demo.py): monocular tracking over a
TUM sequence, a plane fitted to the tracked map points every
--refit-every frames and a cube drawn on it, PNGs into --out.

Two more port the JAX package's parallel examples: `multi_seq`
(examples/multi_seq.py: several sequences tracked round-robin by their
own Systems, with a joint distributed BA over their maps every
--joint-ba-every frames and at the end) and `dist_ba_scaling`
(examples/dist_ba_scaling.py: the distributed BA's strong scaling on
map checkpoints or a synthetic problem).

The offline tools (`tools/`, the JAX package's examples of the same
names): `make_synth_data` KIND --out DIR writes a synthetic KITTI / TUM
mono / TUM RGB-D / EuRoC dataset with its settings and ground truth;
`build_vocab` trains and packages a vocabulary from the port's own
extractor (default --out runs/vocab/vocab_k10_L5.npz); `vocab_recall`
DATASET --vocab PATH ... measures top-1 / top-5 place-recognition
recall; `ba_window_sweep` DATASET measures ATE and time against the
local-BA window.

The engine runs on the card (--device cuda, the default) and raises
without one; --device cpu runs it on the CPU. Reading image files needs
OpenCV and reading a settings file PyYAML, both imported only then.
--vocabulary (default "default", the packaged artifact) turns on place
recognition: BoW relocalization after tracking loss and loop closing;
--no-vocabulary turns it off. --viewer writes PNG snapshots of the map
and the frame (matplotlib and OpenCV), --live-viewer [PORT] serves the
live viewer over HTTP, --profile prints the Tracker's stage spans at
exit, and --device-trace DIR writes a torch.profiler trace of frames
20-40 (of a sequence shorter than 41 frames, from half its length up
to its last frame).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from orb_slam2_test_tpu_torch.evaluation import absolute_trajectory_error
from orb_slam2_test_tpu_torch.io import datasets
from orb_slam2_test_tpu_torch.io.live import (
    ApproximateTimeSync,
    DirectorySource,
    FrameSource,
    SocketSource,
)
from orb_slam2_test_tpu_torch.io.trajectory import load_trajectory_tum
from orb_slam2_test_tpu_torch.parallel.dist_ba import make_ba_mesh
from orb_slam2_test_tpu_torch.parallel.multi_map import (
    joint_bundle_adjust,
    measure_scaling,
    measure_scaling_problem,
)
from orb_slam2_test_tpu_torch.system import MONOCULAR, RGBD, STEREO, System
from orb_slam2_test_tpu_torch.tools import (
    ba_window_sweep,
    build_vocab,
    make_synth_data,
    vocab_recall,
)
from orb_slam2_test_tpu_torch.utils.profiling import device_trace, profiler
from orb_slam2_test_tpu_torch.viz.ar import (
    draw_ar_frame,
    fit_plane_ransac,
    tracked_world_points,
)

DATASETS = {
    "mono_tum": MONOCULAR,
    "mono_kitti": MONOCULAR,
    "mono_euroc": MONOCULAR,
    "stereo_kitti": STEREO,
    "stereo_euroc": STEREO,
    "rgbd_tum": RGBD,
}
LIVE = {"live_mono": MONOCULAR, "live_stereo": STEREO, "live_rgbd": RGBD}
TOOLS = {"make_synth_data": make_synth_data, "build_vocab": build_vocab,
         "vocab_recall": vocab_recall, "ba_window_sweep": ba_window_sweep}
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
    add_engine_args(p)
    p.add_argument("--device-trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of frames 20-40 into DIR")
    return p


# --device-trace's frames [start, stop) (the JAX package's window): a
# steady state past the first frames' set-up
TRACE_WINDOW = (20, 40)


def _trace_window(n: int | None = None) -> tuple[int, int]:
    """TRACE_WINDOW, cut to a sequence of n frames as the JAX package
    cuts it (a live stream has no n)."""
    start, stop = TRACE_WINDOW
    return (start, stop) if n is None else (min(start, n // 2), min(stop, n - 1))


def _trace_at(trace: contextlib.ExitStack, i: int, window: tuple[int, int], args,
              system: System) -> None:
    """--device-trace: enter the trace into `trace` before frame
    window[0] and close it before frame window[1]."""
    if args.device_trace:
        if i == window[0]:
            trace.enter_context(device_trace(
                args.device_trace, cuda=system.tracker.device.type == "cuda"))
        elif i == window[1]:
            trace.close()


@contextlib.contextmanager
def _profiled(on: bool, log):
    """--profile: the stage profiler emptied and on for the block, its
    report printed at the block's end, and the profiler off again after
    it (unless ORB_TPU_PROFILE had turned it on)."""
    if not on:
        yield
        return
    was_on = profiler.enabled
    profiler.clear()
    profiler.enable()
    try:
        yield
        log("-" * 60)
        log(profiler.format_report())
    finally:
        if not was_on:
            profiler.disable()


def add_engine_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The options of the dataset and the live commands alike: the
    viewers, the stage profiler and the device."""
    p.add_argument("--viewer", action="store_true",
                   help="PNG snapshots of the map and the frame into viewer_out/")
    p.add_argument("--live-viewer", type=int, nargs="?", const=8765, default=None,
                   metavar="PORT",
                   help="serve the live map and frame view with menu controls over "
                        "HTTP (default port 8765; 0 picks a free one)")
    p.add_argument("--profile", action="store_true",
                   help="print the Tracker's per-stage wall-clock breakdown at exit")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default cuda; cpu runs on the CPU)")
    return p


def make_system(args, sensor: str) -> System:
    """The System of a dataset or live command: its settings,
    vocabulary, viewer and device."""
    return System(args.settings, sensor, vocabulary=args.vocabulary, device=args.device,
                  use_viewer=args.viewer, live_viewer_port=args.live_viewer)


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
    trace, window = contextlib.ExitStack(), _trace_window(n)
    prev_state = system.tracking_state
    tracker = system.tracker
    items = seq.items[:n]
    # decode frames i+1..i+3 in a thread while frame i tracks
    prefetch: collections.deque = collections.deque()
    next_submit = 0
    t_start = time.perf_counter()
    with _profiled(args.profile, log):
        try:
            with ThreadPoolExecutor(max_workers=1) as pool:
                for i in range(n):
                    _trace_at(trace, i, window, args, system)
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
            trace.close()
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


def add_live_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The live commands' options (the JAX package's
    examples/_live_runner.py, plus the viewers, the profiler, a device
    trace and the device)."""
    p.add_argument("settings", help="settings YAML (reference format)")
    p.add_argument("--spool", default=None, help="spool directory to tail for frames")
    p.add_argument("--spool2", default=None, help="second spool (right / depth stream)")
    p.add_argument("--port", type=int, default=None,
                   help="listen for frames on this TCP port")
    p.add_argument("--port2", type=int, default=None,
                   help="second TCP port (right / depth stream)")
    p.add_argument("--vocabulary", default="default")
    p.add_argument("--no-vocabulary", dest="vocabulary", action="store_const", const=None)
    p.add_argument("--traj-out", default="CameraTrajectory.txt")
    p.add_argument("--checkpoint-out", default=None)
    p.add_argument("--idle-timeout", type=float, default=10.0,
                   help="stop after this many seconds without a frame")
    p.add_argument("--sync-slop", type=float, default=0.02,
                   help="approximate-time pairing window (s)")
    p.add_argument("--depth-map-factor", type=float, default=5000.0,
                   help="depth units per metre of the RGB-D producer")
    p.add_argument("--device-trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of frames 20-40 into DIR")
    return add_engine_args(p)


def make_source(args, second: bool = False, grayscale: bool = True) -> FrameSource:
    """The spool directory or TCP port of the first or second stream.
    grayscale=False reads spooled images as they are: 16-bit depth
    (the JAX package's driver reads a depth spool as 8-bit grey, its
    values divided by 257)."""
    spool = args.spool2 if second else args.spool
    port = args.port2 if second else args.port
    if spool:
        return DirectorySource(spool, grayscale=grayscale)
    if port:
        print(f"listening on :{port} ...")
        return SocketSource(port=port)
    raise SystemExit("need --spool or --port" + (" (and --spool2/--port2)" if second else ""))


def run_live(system: System, source, kind: str, args, log=print) -> dict:
    """Track a live stream until the producer closes it, args.idle_timeout
    seconds pass without a frame, or ctrl-c; then shut down, close the
    source and save the trajectory (and the map with
    args.checkpoint_out). kind: mono (`source` a FrameSource) or stereo
    / rgbd (an ApproximateTimeSync; RGB-D depth is divided by
    args.depth_map_factor). Returns the summary: frames tracked,
    keyframes, lost frames, frames the pairing dropped, wall seconds
    and each frame's ms from its dequeue (the source handing it over)
    to the return of its track call (host wall, `track_ms`; on the card
    also CUDA events, `track_event_ms`), with their median and mean. The
    time a frame waited before its dequeue, in the source's queues or
    the transport's buffers, is not in them."""
    tracker = system.tracker
    on_card = tracker.device.type == "cuda"
    trace, window = contextlib.ExitStack(), _trace_window()
    n = 0
    track_ms, events = [], []
    t_start = t_last = time.monotonic()
    log("live tracking started (ctrl-c or idle timeout to stop)")
    with _profiled(args.profile, log):
        try:
            while True:
                try:
                    f = source.next_frame(timeout=0.5) if kind == "mono" else \
                        source.next_pair(timeout=0.5)
                except StopIteration:
                    log("stream closed by producer")
                    break
                if f is None:
                    if time.monotonic() - t_last > args.idle_timeout:
                        log("idle timeout")
                        break
                    continue
                t_last = time.monotonic()
                _trace_at(trace, n, window, args, system)
                t0 = time.perf_counter()
                if on_card:
                    start, end = torch.cuda.Event(enable_timing=True), \
                        torch.cuda.Event(enable_timing=True)
                    start.record()
                if kind == "mono":
                    ts, img = f
                    system.track_monocular(img, ts)
                elif kind == "stereo":
                    ts, left, right = f
                    system.track_stereo(left, right, ts)
                else:
                    ts, rgb, depth = f
                    system.track_rgbd(rgb, depth / args.depth_map_factor, ts)
                if on_card:
                    end.record()
                    events.append((start, end))
                track_ms.append((time.perf_counter() - t0) * 1e3)
                n += 1
                if n % 30 == 0:
                    st = system.timing_stats()
                    log(f"  {n} frames  state={system.tracking_state}"
                        f"  kf={tracker.stats['n_kf']}  median={st['median_s'] * 1e3:.1f} ms")
        except KeyboardInterrupt:
            log("interrupted")
        finally:
            trace.close()
        wall = time.monotonic() - t_start
        system.shutdown()
        source.close()
    stats = tracker.stats
    log(f"{n} frames tracked; kf={stats['n_kf']} lost={stats['lost_frames']}")
    system.save_trajectory_tum(args.traj_out)
    log(f"trajectory saved to {args.traj_out}")
    if args.checkpoint_out:
        system.save_checkpoint(args.checkpoint_out)
        log(f"map checkpoint saved to {args.checkpoint_out}")
    event_ms = [a.elapsed_time(b) for a, b in events] if on_card else None
    return {"frames": n, "keyframes": stats["n_kf"], "lost_frames": stats["lost_frames"],
            "dropped": getattr(source, "dropped", 0), "wall_s": wall,
            "track_ms": track_ms, "track_event_ms": event_ms,
            "track_ms_median": float(np.median(track_ms)) if track_ms else None,
            "track_ms_mean": float(np.mean(track_ms)) if track_ms else None}


def live_main(args) -> int:
    system = make_system(args, LIVE[args.command])
    source = make_source(args)
    if args.command != "live_mono":
        second = make_source(args, second=True, grayscale=args.command != "live_rgbd")
        source = ApproximateTimeSync(source, second, slop=args.sync_slop)
    run_live(system, source, args.command.removeprefix("live_"), args)
    return 0


def add_ar_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("settings", help="settings YAML (reference format)")
    p.add_argument("sequence", help="TUM RGB-D sequence directory (rgb.txt)")
    p.add_argument("--vocabulary", default="default")
    p.add_argument("--no-vocabulary", dest="vocabulary", action="store_const", const=None)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--out", default="ar_out", help="directory of the overlaid PNGs")
    p.add_argument("--cube-size", type=float, default=0.1)
    p.add_argument("--refit-every", type=int, default=30,
                   help="re-detect the plane every N frames (the reference "
                        "recomputes it on a menu click)")
    return add_engine_args(p)


def run_ar(system: System, seq: datasets.Sequence, args, log=print) -> dict:
    """The AR loop of examples/ar_demo.py (reference ros_mono_ar.cc and
    ViewerAR.cc): track each frame; while tracking, fit the dominant
    plane among the tracked map points on the first OK frame and every
    args.refit_every frames, keeping the fit with the most inliers;
    draw the cube on it over the frame, with the tracked keypoints, and
    write ar_<i>.png into args.out. Returns the frames, the plane's
    inlier count (0 without a plane) and the files written."""
    import cv2

    os.makedirs(args.out, exist_ok=True)
    n = len(seq) if args.max_frames is None else min(len(seq), args.max_frames)
    plane = None
    rng = np.random.default_rng(0)
    tr = system.tracker
    written = []
    with _profiled(args.profile, log):
        for i, it in enumerate(seq.items[:n]):
            ts, img = seq.load(it)[:2]
            system.track_monocular(img, ts)
            if system.tracking_state == "OK":
                if plane is None or i % args.refit_every == 0:
                    cand = fit_plane_ransac(tracked_world_points(tr), rng=rng)
                    if cand is not None and (plane is None or cand.n_inliers > plane.n_inliers):
                        plane = cand
                        log(f"  frame {i}: plane with {plane.n_inliers} inliers")
                uv = None
                if tr.last_frame is not None and tr.cur_feat_pt is not None:
                    uv = tr.last_frame.uv_raw[tr.cur_feat_pt >= 0].cpu().numpy()
                frame = draw_ar_frame(img, tr.last_Tcw, tr.cam, plane,
                                      cube_size=args.cube_size, tracked_uv=uv)
            else:
                frame = draw_ar_frame(img, np.eye(4), tr.cam, None)
            path = os.path.join(args.out, f"ar_{i:06d}.png")
            cv2.imwrite(path, frame)
            written.append(path)
        system.shutdown()
    log(f"{n} AR frames written to {args.out}/")
    return {"frames": n, "plane_inliers": 0 if plane is None else plane.n_inliers,
            "written": written}


# multi_seq's (--dataset, --sensor) -> the dataset subcommand whose loader reads it
MULTI_SEQ_DATASETS = {
    ("kitti", MONOCULAR): "mono_kitti", ("kitti", STEREO): "stereo_kitti",
    ("tum", MONOCULAR): "mono_tum", ("tum", RGBD): "rgbd_tum",
    ("euroc", MONOCULAR): "mono_euroc", ("euroc", STEREO): "stereo_euroc",
}


def add_multi_seq_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--seq", action="append", required=True, metavar="SETTINGS:DIR",
                   help="settings YAML and sequence directory, colon-separated; repeatable")
    p.add_argument("--dataset", default="kitti", choices=["kitti", "tum", "euroc"])
    p.add_argument("--sensor", default=STEREO, choices=[MONOCULAR, STEREO, RGBD])
    p.add_argument("--vocabulary", default="default")
    p.add_argument("--no-vocabulary", dest="vocabulary", action="store_const", const=None)
    p.add_argument("--joint-ba-every", type=int, default=200,
                   help="frames (summed over sequences) between joint BAs")
    p.add_argument("--joint-ba-iters", type=int, default=8)
    p.add_argument("--max-cams", type=int, default=256,
                   help="newest keyframes kept free per sequence in the joint BA")
    p.add_argument("--max-frames", type=int, default=None, help="per-sequence frame cap")
    p.add_argument("--devices", type=int, default=None,
                   help="BA mesh size: shards in one process (default 1), or the "
                        "process count with --multihost")
    p.add_argument("--traj-prefix", default="CameraTrajectory")
    p.add_argument("--kitti-traj", action="store_true")
    p.add_argument("--measure-scaling", action="store_true")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process run: initialize torch.distributed from "
                        "SLAM_COORDINATOR / SLAM_NUM_PROCS / SLAM_PROC_ID and put "
                        "the joint BA on the mesh of every rank")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default cuda; cpu runs on the CPU)")
    return p


def run_multi_seq(systems: list, seqs: list, args, log=print) -> dict:
    """Track the sequences round-robin, one frame of each live sequence
    per cycle (the multi-map form of the reference's per-frame loop),
    with a joint BA over every map after each args.joint_ba_every frames
    summed over the sequences and a final one, then save each
    trajectory as <args.traj_prefix>_<i>.txt. Before a joint BA a
    System's pending global BA (a loop's) runs to its end: its apply
    would otherwise write its snapshot's poses over the joint BA's.
    After it each moved System's velocity and cached reference pose are
    dropped. Returns the summary: frames, wall seconds, aggregate fps,
    the joint BAs' infos and each sequence's median track seconds and
    state."""
    mesh = make_ba_mesh(args.devices, args.device)
    log(f"[multi_seq] {len(systems)} sequences, mesh of {mesh.size} device(s)")
    lengths = [len(s) if args.max_frames is None else min(len(s), args.max_frames)
               for s in seqs]
    cursors = [0] * len(seqs)
    since_ba = 0
    ba_infos = []

    def run_joint_ba():
        nonlocal since_ba
        for s in systems:
            lc = s.tracker.loop_closer
            if lc is not None and lc.gba_running():
                s.tracker.drain_backend()
        new_maps, info = joint_bundle_adjust(
            [s.tracker.map for s in systems], [s.tracker.cam for s in systems], mesh,
            iters=args.joint_ba_iters, max_cams=args.max_cams,
            scale_factor=[s.tracker.cfg.scale_factor for s in systems])
        for s, m in zip(systems, new_maps):
            if m is s.tracker.map:
                continue  # too small: untouched
            s.tracker.map = m
            # the BA moved keyframes and points under the tracker: the
            # constant-velocity prior and the cached reference pose are
            # stale (as after a loop correction)
            s.tracker.velocity = None
            s.tracker._ref_Tcw_host = None
        ba_infos.append(info)
        since_ba = 0
        if info["n_cams"]:
            log(f"[joint BA] cams={info['n_cams']} pts={info['n_pts']} obs={info['n_obs']} "
                f"cost={info['cost']:.1f} solve={info['solve_s'] * 1e3:.0f}ms "
                f"devices={info['n_devices']}")

    t_start = time.perf_counter()
    while any(c < n for c, n in zip(cursors, lengths)):
        for i, (system, seq) in enumerate(zip(systems, seqs)):
            if cursors[i] >= lengths[i]:
                continue
            data = seq.load(seq.items[cursors[i]])
            if system.sensor == STEREO:
                system.track_stereo(data[1], data[2], data[0])
            elif system.sensor == RGBD:
                system.track_rgbd(data[1], data[2], data[0])
            else:
                system.track_monocular(data[1], data[0])
            cursors[i] += 1
            since_ba += 1
        if since_ba >= args.joint_ba_every:
            run_joint_ba()
    run_joint_ba()  # the final polish over the complete maps
    wall = time.perf_counter() - t_start

    total = sum(lengths)
    log(f"[multi_seq] {total} frames total in {wall:.1f}s "
        f"({total / max(wall, 1e-9):.1f} fps aggregate)")
    medians, states = [], []
    for i, s in enumerate(systems):
        median = s.timing_stats().get("median_s", 0.0)
        medians.append(median)
        states.append(s.tracking_state)
        log(f"  seq {i}: median track {median * 1e3:.1f}ms state={s.tracking_state}")
        path = f"{args.traj_prefix}_{i}.txt"
        if args.kitti_traj:
            s.save_trajectory_kitti(path)
        else:
            s.save_trajectory_tum(path)
        s.shutdown()
    return {"frames": total, "wall_s": wall, "fps": total / max(wall, 1e-9),
            "joint_ba": ba_infos, "median_s": medians, "states": states}


def multi_seq_main(args) -> int:
    if args.multihost:
        from orb_slam2_test_tpu_torch.parallel.multihost import initialize_from_env

        initialize_from_env(device=args.device)
    dataset = MULTI_SEQ_DATASETS.get((args.dataset, args.sensor))
    if dataset is None:
        raise SystemExit(f"no {args.sensor} sequences in the {args.dataset} layout")
    systems, seqs = [], []
    for spec in args.seq:
        settings, _, seq_dir = spec.rpartition(":")
        if not settings:
            raise SystemExit(f"--seq must be SETTINGS:DIR, got {spec!r}")
        system = System(settings, args.sensor, vocabulary=args.vocabulary, device=args.device)
        seq_args = argparse.Namespace(sequence=seq_dir, associations=None, timestamps=None)
        systems.append(system)
        seqs.append(load_sequence(dataset, seq_args, system))
    summary = run_multi_seq(systems, seqs, args)
    if args.measure_scaling and summary["joint_ba"][-1]["n_cams"]:
        report = measure_scaling(
            [s.tracker.map for s in systems], [s.tracker.cam for s in systems],
            iters=args.joint_ba_iters, max_cams=args.max_cams,
            scale_factor=[s.tracker.cfg.scale_factor for s in systems])
        print(json.dumps(report))
    return 0


def dist_ba_scaling_main(args) -> int:
    """The distributed BA's strong scaling (`measure_scaling`) on map
    checkpoints (the port's or the JAX package's npz; one repeated
    stands for several maps) or on `utils.synthetic.synthetic_ba_problem`
    of C cameras, P points and O observations per point."""
    from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_test_tpu_torch.io.checkpoint import load_map
    from orb_slam2_test_tpu_torch.utils.synthetic import synthetic_ba_problem

    if args.synthetic:
        n_cams, n_pts, obs_per_pt = args.synthetic
        prob, cam = synthetic_ba_problem(n_cams, n_pts, obs_per_pt, device=args.device)
        report = measure_scaling_problem(prob, cam, iters=args.iters, repeats=args.repeats)
    else:
        maps, cams, sfs = [], [], []
        for path in args.checkpoints:
            m, cap, meta = load_map(path, args.device)
            maps.append(m)
            sfs.append(cap.scale_factor)
            c = meta.get("camera")
            # a checkpoint without its camera: KITTI 00-02's
            cams.append(PinholeCamera(**c) if c else PinholeCamera(
                fx=718.856, fy=718.856, cx=607.19, cy=185.22, width=1241, height=376,
                bf=718.856 * 0.53716))
            print(f"  {path}: {int(m.kf_valid.sum())} keyframes, {int(m.pt_valid.sum())} points")
        report = measure_scaling(maps, cams, iters=args.iters, max_cams=args.max_cams,
                                 repeats=args.repeats, scale_factor=sfs)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"written to {args.out}")
    return 0


def add_dist_ba_scaling_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoints", nargs="+", default=None,
                     help="map npz files (repeat one to stand for several maps)")
    src.add_argument("--synthetic", nargs=3, type=int, metavar=("C", "P", "O"), default=None,
                     help="a synthetic KITTI-shaped problem: cameras, points, "
                          "observations per point")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--max-cams", type=int, default=None)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--out", default=None, help="write the JSON report")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the CPU)")
    return p


def build_parser() -> argparse.ArgumentParser:
    """The parser of every subcommand."""
    p = argparse.ArgumentParser(
        prog="python -m orb_slam2_test_tpu_torch.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    for name in DATASETS:
        sp = add_common_args(sub.add_parser(name))
        if name.endswith("euroc"):
            sp.add_argument("--timestamps", default=None)
        if name == "rgbd_tum":
            sp.add_argument("--associations", default=None)
    for name in LIVE:
        add_live_args(sub.add_parser(name))
    add_ar_args(sub.add_parser("ar"))
    add_multi_seq_args(sub.add_parser("multi_seq"))
    add_dist_ba_scaling_args(sub.add_parser("dist_ba_scaling"))
    for name, tool in TOOLS.items():
        tool.add_args(sub.add_parser(name, description=tool.__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter))
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command in TOOLS:
        return TOOLS[args.command].main(args)
    if args.command == "multi_seq":
        return multi_seq_main(args)
    if args.command == "dist_ba_scaling":
        return dist_ba_scaling_main(args)
    if args.command in LIVE:
        return live_main(args)
    if args.command == "ar":
        run_ar(make_system(args, MONOCULAR), datasets.load_tum_mono(args.sequence), args)
        return 0
    system = make_system(args, DATASETS[args.command])
    seq = load_sequence(args.command, args, system)
    run(system, seq, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
