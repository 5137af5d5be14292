"""The port's multi-lap KITTI-geometry loop run on one GPU.

    python3 examples/kitti_loop_run.py [--frames 1200] [--radius 60]
        [--revolutions 2] [--max-keyframes 128] [--max-points 49152]
        [--workers N] [--out runs/kitti_loop_run]

Renders the stereo loop of examples/make_synth_data.py's `kitti` into
memory (1241x376, 6,000 textured quads lining a circular corridor, a
process per core), then drives it through the port's `cli.run` with the
packaged vocabulary and small starting capacities, so that loops close
and the map grows (`orb_slam2_test_tpu_torch.entry.kitti_loop_run`).
Prints the summary beside the JAX package's run at the same geometry:
frames, lost frames, loops and their frames, capacity growths,
keyframes, ATE against the rendered truth before the first loop and at
the end (rigid, and with a scale), the ATE over the frames so far before
and after each loop correction and each global BA's apply, median / p90 /
mean host ms a frame, each loop frame's ms, each loop correction's and
global-BA chunk's ms on CUDA events with the keyframe capacity it ran
at, both kernels' launches, and the card's name and power limit.

The instruments add no host sync to the frames they time: the stages'
CUDA events are read after the run (`utils.loop_probes.LoopTimes`), and
each correction and global-BA apply keeps a copy of its keyframe poses
on the card, from which the ATEs are computed after the run. After it,
the first correction runs again on its own inputs on the card, as
shipped and with its loop connections left out of the essential graph
(`utils.loop_probes.loop_connections_left_out`): the ATE over the frames
so far after each.

Writes to --out the summary (kitti_loop_run.json), the per-frame
diagnostics, the trajectories (before the first loop, at the end, the
truth) and the first correction's inputs with the relative trajectory
and truth of the frames so far (first_correction.npz, which
examples/long_loop_correction.py runs through both packages on the
CPU). It needs a CUDA card and exits non-zero without one.

The JAX references: runs/kitti00_full (1200 frames, radius 60 m, 2 laps;
the default) and, for `--frames 2600 --radius 130 --revolutions 2`,
runs/kitti_long_r05, which stopped after frame 226: its keyframes at
frames 50-226 and its median motion matches over frames 0-226.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the JAX package's runs by geometry (frames, radius, laps)
LONG_GEOMETRY = (2600, 130.0, 2.0)
LONG_REF_FRAMES = (50, 100, 150, 200, 226)  # runs/kitti_long_r05 stopped after 226


def _jax_long_reference() -> dict:
    """runs/kitti_long_r05's frames 0-226: states, keyframes at
    LONG_REF_FRAMES, the median of the motion matches."""
    with open(os.path.join(ROOT, "runs", "kitti_long_r05", "diag.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return _early_figures(rows)


def _early_figures(rows: list) -> dict:
    """Frames 0-226 of a diag file: their states, keyframes at
    LONG_REF_FRAMES and the median of the motion matches."""
    rows = [r for r in rows if r["frame"] <= LONG_REF_FRAMES[-1]]
    by_frame = {r["frame"]: r for r in rows}
    matches = [r["n_motion_matches"] for r in rows if "n_motion_matches" in r]
    return {"frames": len(rows),
            "ok": sum(r["state"] == "OK" for r in rows),
            "keyframes_at": {i: by_frame[i]["n_kf"] for i in LONG_REF_FRAMES if i in by_frame},
            "median_motion_matches": statistics.median(matches) if matches else None}


def _trajectory_figures(T_true: np.ndarray, before: np.ndarray, end: np.ndarray) -> dict:
    """ATE (rigid, SE3, and with a scale, Sim3) of the trajectory before
    the first loop over its frames, and of the end's trajectory over the
    same frames and over all; the path lengths of the truth and of the
    trajectory before the loop over those frames (the odometry's scale)."""
    from orb_slam2_test_tpu_torch.evaluation import absolute_trajectory_error

    def ate(Tcw, with_scale):
        est = [(i / 10.0, T) for i, T in enumerate(Tcw)]
        gt = [(i / 10.0, np.linalg.inv(T)) for i, T in enumerate(T_true[:len(Tcw)])]
        return absolute_trajectory_error(est, gt, with_scale=with_scale)["rmse"]

    def path(Tcw):
        c = -np.einsum("nji,nj->ni", Tcw[:, :3, :3].astype(np.float64), Tcw[:, :3, 3])
        return float(np.linalg.norm(np.diff(c, axis=0), axis=1).sum())

    n = len(before)
    out = {}
    for name, Tcw in (("before_first_loop", before), ("end_same_frames", end[:n]),
                      ("end", end)):
        out[name] = {"frames": len(Tcw), "se3": ate(Tcw, False), "sim3": ate(Tcw, True)}
    if n > 1:
        out["path_m"] = {"truth": path(T_true[:n]), "before_first_loop": path(before)}
    return out


def _print_trajectory_figures(fig: dict) -> None:
    for name in ("before_first_loop", "end_same_frames", "end"):
        x = fig[name]
        print(f"port ATE {name.replace('_', ' ')} ({x['frames']} frames): SE3 {x['se3']:.4f} m, "
              f"Sim3 {x['sim3']:.4f} m")
    if "path_m" in fig:
        p = fig["path_m"]
        print(f"port path over those frames: {p['before_first_loop']:.2f} m against the "
              f"truth's {p['truth']:.2f} m ({p['before_first_loop'] / p['truth'] - 1:+.3%})")


def _kf_poses(m) -> SimpleNamespace:
    """A copy of map m's keyframe poses and spanning tree, on its device."""
    return SimpleNamespace(**{f: getattr(m, f).clone()
                              for f in ("kf_Tcw", "kf_valid", "kf_parent", "kf_Tcp")})


def _first_correction_again(tracker, captured, n0: int, ate_on, in_run, T_true,
                            out: str) -> dict:
    """The run's first correction again on its captured inputs on the
    card, as shipped and with its loop connections left out: the ATE over
    the frames so far before and after each, and whether the shipped one
    gives the run's own poses. Saves its inputs, the relative trajectory
    and the truth of those frames to out/first_correction.npz."""
    import torch

    from orb_slam2_test_tpu_torch import entry
    from orb_slam2_test_tpu_torch.engine import loop_closing as lc
    from orb_slam2_test_tpu_torch.slam_map.mapstate import MapState
    from orb_slam2_test_tpu_torch.utils.loop_probes import loop_connections_left_out

    m0, kf_id, cand, S12, fix = captured
    m0 = MapState(*m0)
    cam = tracker.loop_closer.cam
    shipped = lc._correct_loop_device(cam, m0, kf_id, cand, S12, fix)
    with loop_connections_left_out(lc):
        left_out = lc._correct_loop_device(cam, m0, kf_id, cand, S12, fix)
    res = {"frames": n0, "K": m0.kf_valid.shape[0], "kf": int(kf_id), "cand": int(cand),
           "before": ate_on(n0, m0), "shipped": ate_on(n0, shipped),
           "left_out": ate_on(n0, left_out),
           "shipped_equals_run": bool(torch.equal(shipped.kf_Tcw, in_run.kf_Tcw))}
    rel = tracker.rel_trajectory[:n0]
    path = os.path.join(out, "first_correction.npz")
    np.savez_compressed(
        path, kf=int(kf_id), cand=int(cand), S12=S12.cpu().numpy(), fix_scale=fix,
        rel_t=np.array([t for t, _, _ in rel]), rel_ref=np.array([int(r) for _, r, _ in rel]),
        rel_T=np.stack([T for _, _, T in rel]), T_true=T_true[:n0],
        **{"cam_" + f: getattr(cam, f) for f in cam._fields}, **entry.map_to_numpy(m0))
    res["saved_mb"] = os.path.getsize(path) / 1e6
    return res


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
    from orb_slam2_test_tpu_torch.engine import loop_closing as lc
    from orb_slam2_test_tpu_torch.utils.loop_probes import LoopTimes, ate, trajectory_on
    from orb_slam2_test_tpu_torch.utils.precision import f32_matmuls

    f32_matmuls()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    os.makedirs(args.out, exist_ok=True)
    diag = os.path.join(args.out, "kitti_loop_run_diag.jsonl")
    hooks = {}

    def setup(system, seq):
        tracker = system.tracker
        times = LoopTimes(tracker.loop_closer, lc, sync=False)
        hooks.update(times=times, system=system, seq=seq, loop_log=[], gba_log=[])
        # each correction's and global BA apply's keyframe poses before
        # and after it, copied on the card (no host read in the frame)
        correct, apply = lc._correct_loop_device, lc._apply_gba_device

        def correct_logged(cam, m, kf_id, cand, *a, **k):
            before = _kf_poses(m)
            out = correct(cam, m, kf_id, cand, *a, **k)
            hooks["loop_log"].append((len(tracker.rel_trajectory), m.kf_valid.shape[0],
                                      kf_id.clone(), cand.clone(), before, _kf_poses(out)))
            return out

        def apply_logged(m, *a, **k):
            before = _kf_poses(m)
            out = apply(m, *a, **k)
            hooks["gba_log"].append((len(tracker.rel_trajectory), before, _kf_poses(out)))
            return out

        lc._correct_loop_device, lc._apply_gba_device = correct_logged, apply_logged
        hooks["restore"] = (correct, apply)

    try:
        summary = entry.kitti_loop_run(
            frames=args.frames, radius=args.radius, revolutions=args.revolutions,
            max_keyframes=args.max_keyframes, max_points=args.max_points,
            workers=args.workers, diag=diag, setup=setup)
    finally:
        if "restore" in hooks:
            lc._correct_loop_device, lc._apply_gba_device = hooks["restore"]
        if "times" in hooks:
            hooks["times"].restore()
    times, T_true, tracker = hooks["times"], hooks["seq"].T_true, hooks["system"].tracker
    rel = tracker.rel_trajectory

    def ate_on(n, poses) -> float:
        return ate(trajectory_on(rel[:n], poses), T_true[:n])["rmse"]

    loop_ate = [{"frames": n, "K": K, "kf": int(kf), "cand": int(c), "before": ate_on(n, b),
                 "corrected": ate_on(n, a)} for n, K, kf, c, b, a in hooks["loop_log"]]
    gba_ate = [{"frames": n, "before": ate_on(n, b), "after": ate_on(n, a)}
               for n, b, a in hooks["gba_log"]]
    traj_end = tracker.export_trajectory()
    trajs = {"T_true": T_true.astype(np.float32),
             "end": np.stack([T for _, T in traj_end]).astype(np.float32),
             "before_first_loop": np.zeros((0, 4, 4), np.float32)}
    first, before = None, None
    if hooks["loop_log"]:
        n0 = hooks["loop_log"][0][0]
        trajs["before_first_loop"] = np.stack(
            [T for _, T in trajectory_on(rel[:n0], hooks["loop_log"][0][4])]).astype(np.float32)
        before = {"frames": n0, "ate": loop_ate[0]["before"],
                  "ate_end_same_frames": ate(traj_end[:n0], T_true[:n0])["rmse"]}
        first = _first_correction_again(tracker, times.captured, n0, ate_on,
                                        hooks["loop_log"][0][5], T_true, args.out)
    np.savez_compressed(os.path.join(args.out, "kitti_loop_run_traj.npz"), **trajs)
    figures = _trajectory_figures(trajs["T_true"], trajs["before_first_loop"], trajs["end"])
    ms = summary["frame_ms"]
    with open(diag) as f:
        rows = [json.loads(line) for line in f]
    summary.update(
        card=card, median_track_ms=statistics.median(ms),
        p90_track_ms=float(np.percentile(ms, 90)), mean_track_ms=statistics.mean(ms),
        ate_before_first_loop=before, first_correction_again=first,
        correct_loop_ms=[{"K": k, "ms": x} for k, x in
                         zip(times.K["correct_loop_device"], times.ms["correct_loop_device"])],
        gba_chunk_ms=[{"K": k, "ms": x} for k, x in
                      zip(times.K["gba_chunk"], times.ms["gba_chunk"])],
        loop_flush_ms=[{"kf": kf, "flush": a, "compute_sim3": b - c, "correct": c}
                       for kf, a, b, c in times.loop_flush],
        launches=rows[-1]["launches"] if rows else None, early=_early_figures(rows),
        loop_ate=loop_ate, gba_ate=gba_ate, trajectory=figures)
    keys = ("frames", "lost_frames", "loops", "keyframes", "live_keyframes")
    print(f"port ({card}): " + ", ".join(f"{k} {summary.get(k)}" for k in keys)
          + f", ATE {summary.get('ate_rmse')} m")
    print(f"port growths: {summary['capacity_growth_events']}")
    print(f"port loop frames (index, host ms): "
          f"{[(x['frame'], round(x['ms'], 1)) for x in summary['loop_frames']]}")
    before = summary["ate_before_first_loop"]
    print(f"port ATE before the first loop: {before} ; at the end "
          f"{summary.get('ate_rmse')} m over {summary.get('ate_pairs')} pairs")
    print("port ATE over the frames so far, before / after each correction (K): "
          + ", ".join(f"{x['frames']}: {x['before']:.4f} / {x['corrected']:.4f} ({x['K']})"
                      for x in summary["loop_ate"]))
    print("port ATE over the frames so far, before / after each global BA's apply: "
          + ", ".join(f"{x['frames']}: {x['before']:.4f} / {x['after']:.4f}"
                      for x in summary["gba_ate"]))
    _print_trajectory_figures(figures)
    if first is not None:
        print(f"port first correction again on its inputs (keyframe {first['kf']} to "
              f"{first['cand']}, K {first['K']}), ATE over its {first['frames']} frames: before "
              f"{first['before']:.4f} m, as shipped {first['shipped']:.4f} m (the run's own poses: "
              f"{first['shipped_equals_run']}), loop connections left out "
              f"{first['left_out']:.4f} m; inputs saved, {first['saved_mb']:.1f} MB")
    print(f"port host ms a frame: median {summary['median_track_ms']:.1f}, p90 "
          f"{summary['p90_track_ms']:.1f}, mean {summary['mean_track_ms']:.1f}; render "
          f"{summary['render_s']:.1f} s ({card})")
    print("port corrections (K, CUDA-event ms): "
          f"{[(x['K'], round(x['ms'], 1)) for x in summary['correct_loop_ms']]}")
    print("port global-BA chunks (K, CUDA-event ms): "
          f"{[(x['K'], round(x['ms'], 1)) for x in summary['gba_chunk_ms']]}")
    print(f"port launches (patch_gather, pose_opt): {summary['launches']}")
    geometry = (args.frames, args.radius, args.revolutions)
    if geometry == LONG_GEOMETRY:
        ref = _jax_long_reference()
        print(f"port frames 0-{LONG_REF_FRAMES[-1]}: {summary['early']}")
        print(f"JAX runs/kitti_long_r05 (a TPU run, stopped after frame "
              f"{LONG_REF_FRAMES[-1]}; counts only): {ref}")
        summary["jax_reference"] = ref
    else:
        with open(os.path.join(ROOT, "runs", "kitti00_full", "summary.json")) as f:
            ref = json.load(f)
        ref_keys = ("frames", "lost_frames", "loops", "keyframes", "ate_rmse_m")
        print("JAX runs/kitti00_full (a TPU run; counts and ATE only): "
              + ", ".join(f"{k} {ref[k]}" for k in ref_keys)
              + f", growths {ref['capacity_growth_events']}")
    with open(os.path.join(args.out, "kitti_loop_run.json"), "w") as f:
        json.dump(summary, f)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
