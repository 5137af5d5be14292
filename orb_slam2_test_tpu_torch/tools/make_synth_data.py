"""Generate KITTI-scale synthetic datasets on disk.

The counterpart of the JAX package's examples/make_synth_data.py: the
same scenes, trajectories, files and settings, rendered by the port's
`utils/synthetic` (NumPy on the host) and written with OpenCV.

  python -m orb_slam2_test_tpu_torch.cli make_synth_data kitti \\
      --out /data/synth_kitti --frames 600 --workers 8  # stereo, 1241x376, loop
  python -m orb_slam2_test_tpu_torch.cli make_synth_data tum-mono --out /data/synth_tum
  python -m orb_slam2_test_tpu_torch.cli make_synth_data tum-rgbd --out /data/synth_rgbd
  python -m orb_slam2_test_tpu_torch.cli make_synth_data euroc --out /data/synth_euroc

Each writes the dataset in the reference's on-disk format (times.txt +
image_0/1, rgb.txt / depth.txt, or mav0/cam0/data.csv), a
reference-format settings.yaml and a TUM-format groundtruth.txt, so
`cli.py stereo_kitti <dir>/settings.yaml <dir> --groundtruth
<dir>/groundtruth.txt` runs on it as on real KITTI. `kitti` with
--workers > 1 (and no blackout) renders and writes chunks of 16 frames
in a pool of spawned processes; every other case renders the whole
sequence in this process and holds it in memory before writing (600
KITTI stereo frames: about 2.2 GB).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_test_tpu_torch.io import trajectory as traj_io
from orb_slam2_test_tpu_torch.tools import torch_device
from orb_slam2_test_tpu_torch.utils.synthetic import (
    _render_loop_chunk,
    loop_chunk_jobs,
    make_loop_trajectory,
    render_loop_sequence,
)

# per kind: frames, landmarks, radius, features, max_keyframes, max_points
DEFAULTS = {
    "kitti": (600, 6000, 60.0, 2000, 384, 131072),
    "euroc": (300, 3000, 15.0, 1000, 256, 65536),
    "tum": (240, 2500, 12.0, 1000, 192, 32768),
}


def full_step_revolutions(frames: int, full_frames: int, revolutions: float = 1.08) -> float:
    """The --revolutions at which `frames` frames move as far per frame
    as `full_frames` frames at `revolutions` laps: the first frames of
    the full-length trajectory, for a short dataset of the same scene."""
    return revolutions * (frames - 1) / (full_frames - 1)


def _write_png(path: str, img: np.ndarray) -> None:
    import cv2

    cv2.imwrite(path, np.clip(img, 0, 255).astype(np.uint8))


def _tracker_overrides(f, close_pts: bool) -> None:
    """Synthetic scenes carry fewer matchable blobs per frame than real
    imagery at the same feature budget; relax the init/track gates the
    same way the JAX package's test suite does."""
    f.write("Tracker.minInitMatches: 60\n")
    f.write("Tracker.minInitTriangulated: 40\n")
    f.write("Tracker.minLocalInliers: 20\n")
    # synthetic textures decay fast with viewpoint (planar quads under
    # affine warp): relocalization after a blackout only works if the
    # nearest keyframe is a few frames away, so cap the KF interval
    # tighter than the reference's fps default
    f.write("Tracker.maxFramesBetweenKF: 5\n")
    if close_pts:
        f.write("Tracker.minDepthInitPoints: 150\n")


def _write_header(f, args, cam: PinholeCamera, bf: bool = True) -> None:
    """The camera and extractor lines every settings file starts with."""
    f.write("%YAML:1.0\n")
    f.write(f"Camera.fx: {cam.fx}\nCamera.fy: {cam.fy}\n")
    f.write(f"Camera.cx: {cam.cx}\nCamera.cy: {cam.cy}\n")
    f.write("Camera.k1: 0.0\nCamera.k2: 0.0\n")
    f.write("Camera.p1: 0.0\nCamera.p2: 0.0\n")
    f.write(f"Camera.width: {cam.width}\nCamera.height: {cam.height}\n")
    f.write(f"Camera.fps: {args.fps}\n" + (f"Camera.bf: {cam.bf}\n" if bf else ""))


def _write_extractor(f, args) -> None:
    f.write(f"ORBextractor.nFeatures: {args.features}\n")
    f.write("ORBextractor.scaleFactor: 1.2\n")
    f.write("ORBextractor.nLevels: 8\n")
    f.write("ORBextractor.iniThFAST: 20\nORBextractor.minThFAST: 7\n")
    f.write(f"Map.maxKeyFrames: {args.max_keyframes}\n")
    f.write(f"Map.maxPoints: {args.max_points}\n")


def _write_kitti_yaml(args, cam: PinholeCamera, d: str) -> None:
    yaml = os.path.join(d, "settings.yaml")
    with open(yaml, "w") as f:
        _write_header(f, args, cam)
        f.write("Camera.RGB: 1\nThDepth: 35.0\n")
        _write_extractor(f, args)
        # dense stereo maps: 2000 feats x 16 covisible KFs exceed the
        # 4096-point default local-BA window
        f.write("Tracker.localPtCap: 8192\n")
        f.write("Tracker.baPtCap: 8192\n")
        _tracker_overrides(f, close_pts=True)
    print(f"settings: {yaml}")


def _write_kitti_chunk(job) -> int:
    """Worker: render the frames of one `loop_chunk_jobs` job and write
    them as image_0 / image_1 PNGs under the job's directory."""
    import cv2

    out_dir, render_job = job
    lo, chunk = _render_loop_chunk(render_job)
    for j, pair in enumerate(chunk):
        for side, img in zip(("image_0", "image_1"), pair):
            cv2.imwrite(os.path.join(out_dir, side, f"{lo + j:06d}.png"), img)
    return len(chunk)


def _blackout(args) -> tuple:
    if args.blackout_at < 0:
        return ()
    return tuple(range(args.blackout_at, args.blackout_at + args.blackout_len))


def gen_kitti(args) -> int:
    # KITTI 00 camera geometry (P0 of the odometry devkit)
    w, h = 1241, 376
    fx = 718.856
    baseline = 0.53716
    cam = PinholeCamera(fx=fx, fy=fx, cx=607.19, cy=185.22, width=w, height=h,
                        bf=fx * baseline)
    print(f"rendering {args.frames} stereo frames at {w}x{h} ...", flush=True)
    d = args.out
    os.makedirs(os.path.join(d, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(d, "image_1"), exist_ok=True)
    times = [i / args.fps for i in range(args.frames)]
    if args.workers > 1 and args.blackout_at < 0:
        # streaming: each spawned worker renders and writes its chunks
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        jobs = [(d, job) for job in loop_chunk_jobs(args.frames, cam, args.radius,
                                                     args.revolutions, args.landmarks,
                                                     args.seed)]
        with ProcessPoolExecutor(max_workers=args.workers,
                                 mp_context=mp.get_context("spawn")) as pool:
            done = 0
            for n in pool.map(_write_kitti_chunk, jobs):
                done += n
                if done % 100 < n:
                    print(f"  {done}/{args.frames} frames written", flush=True)
        poses = make_loop_trajectory(args.frames, args.radius, args.revolutions)
    else:
        seq = render_loop_sequence(
            np.random.default_rng(args.seed), args.frames, cam, n_landmarks=args.landmarks,
            radius=args.radius, baseline=baseline, blackout=_blackout(args),
            revolutions=args.revolutions,
        )
        for i in range(args.frames):
            _write_png(os.path.join(d, "image_0", f"{i:06d}.png"), seq["left"][i])
            _write_png(os.path.join(d, "image_1", f"{i:06d}.png"), seq["right"][i])
            if (i + 1) % 100 == 0:
                print(f"  {i + 1}/{args.frames} frames written", flush=True)
        poses = seq["poses"]
    with open(os.path.join(d, "times.txt"), "w") as f:
        f.write("\n".join(f"{t:.6e}" for t in times) + "\n")
    traj_io.save_trajectory_tum(os.path.join(d, "groundtruth.txt"),
                                [(times[i], poses[i]) for i in range(args.frames)])
    _write_kitti_yaml(args, cam, d)
    print(f"dataset at {d}")
    return 0


def gen_euroc(args) -> int:
    """EuRoC MAV on-disk layout: mav0/cam0/data/<ns>.png (+ cam1 for
    stereo) with nanosecond filenames, plus a reference-schema yaml.
    Zero distortion: rectification maps become identity, but the EuRoC
    command's rectification path still runs."""
    w, h = 752, 480  # EuRoC cam geometry
    baseline = 0.11
    cam = PinholeCamera(fx=458.654, fy=457.296, cx=367.215, cy=248.375, width=w, height=h,
                        bf=458.654 * baseline)
    print(f"rendering {args.frames} frames at {w}x{h} ...", flush=True)
    seq = render_loop_sequence(
        np.random.default_rng(args.seed), args.frames, cam, n_landmarks=args.landmarks,
        radius=args.radius, baseline=baseline, revolutions=args.revolutions,
    )
    d = args.out
    os.makedirs(os.path.join(d, "mav0", "cam0", "data"), exist_ok=True)
    os.makedirs(os.path.join(d, "mav0", "cam1", "data"), exist_ok=True)
    t0_ns = 1403636579763555584  # MH_01-style epoch
    stamps = [t0_ns + int(i * 1e9 / args.fps) for i in range(args.frames)]
    gt = []
    for i, ns in enumerate(stamps):
        _write_png(os.path.join(d, "mav0", "cam0", "data", f"{ns}.png"), seq["left"][i])
        _write_png(os.path.join(d, "mav0", "cam1", "data", f"{ns}.png"), seq["right"][i])
        gt.append((ns * 1e-9, seq["poses"][i]))
        if (i + 1) % 100 == 0:
            print(f"  {i + 1}/{args.frames} frames written", flush=True)
    with open(os.path.join(d, "mav0", "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for ns in stamps:
            f.write(f"{ns},{ns}.png\n")
    traj_io.save_trajectory_tum(os.path.join(d, "groundtruth.txt"), gt)
    yaml = os.path.join(d, "settings.yaml")
    with open(yaml, "w") as f:
        _write_header(f, args, cam)
        f.write("Camera.RGB: 1\nThDepth: 35.0\n")
        _write_extractor(f, args)
        _tracker_overrides(f, close_pts=False)
    print(f"dataset at {d} (settings: {yaml})")
    return 0


def write_rectified_settings(d: str) -> str:
    """Write `d`/settings_rectified.yaml, the EuRoC dataset's
    settings.yaml with LEFT.* / RIGHT.* rectification blocks, which the
    stereo_euroc command reads (the JAX script writes none). The images
    are rendered undistorted and rectified, so the blocks are the
    identity: the settings' K, no distortion, R = I and the projections
    [K | 0] and [K | (-bf, 0, 0)]. Returns the path."""
    from orb_slam2_test_tpu_torch.io.settings import load_settings

    src = os.path.join(d, "settings.yaml")
    s = load_settings(src)

    def matrix(name: str, rows: int, cols: int, data) -> str:
        return (f"{name}: !!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n   dt: d\n"
                f"   data: [{', '.join(repr(float(x)) for x in data)}]\n")

    K = [s.fx, 0.0, s.cx, 0.0, s.fy, s.cy, 0.0, 0.0, 1.0]
    blocks = []
    for side, tx in (("LEFT", 0.0), ("RIGHT", -s.bf)):
        blocks += [f"{side}.width: {s.width}\n{side}.height: {s.height}\n",
                   matrix(f"{side}.D", 1, 5, [0.0] * 5), matrix(f"{side}.K", 3, 3, K),
                   matrix(f"{side}.R", 3, 3, np.eye(3).ravel()),
                   matrix(f"{side}.P", 3, 4, [s.fx, 0.0, s.cx, tx, 0.0, s.fy, s.cy, 0.0,
                                              0.0, 0.0, 1.0, 0.0])]
    out = os.path.join(d, "settings_rectified.yaml")
    with open(src) as f:
        text = f.read()
    with open(out, "w") as f:
        f.write(text + "".join(blocks))
    return out


def gen_tum(args, rgbd: bool) -> int:
    w, h = 640, 480
    cam = PinholeCamera(
        fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=w, height=h,
        bf=(517.3 * 0.075 if rgbd else 0.0),  # TUM-like virtual baseline
    )
    print(f"rendering {args.frames} frames at {w}x{h} ...", flush=True)
    seq = render_loop_sequence(
        np.random.default_rng(args.seed), args.frames, cam, n_landmarks=args.landmarks,
        radius=args.radius, with_depth=rgbd, revolutions=args.revolutions,
        blackout=_blackout(args),
    )
    d = args.out
    os.makedirs(os.path.join(d, "rgb"), exist_ok=True)
    if rgbd:
        os.makedirs(os.path.join(d, "depth"), exist_ok=True)
    rows, drows = [], []
    for i in range(args.frames):
        ts = 1000.0 + i / args.fps
        p = f"rgb/{ts:.6f}.png"
        _write_png(os.path.join(d, p), seq["left"][i])
        rows.append(f"{ts:.6f} {p}")
        if rgbd:
            import cv2

            dp = f"depth/{ts:.6f}.png"
            d16 = np.clip(seq["depth"][i] * 5000.0, 0, 65535).astype(np.uint16)
            cv2.imwrite(os.path.join(d, dp), d16)
            drows.append(f"{ts:.6f} {dp}")
        if (i + 1) % 100 == 0:
            print(f"  {i + 1}/{args.frames} frames written", flush=True)
    with open(os.path.join(d, "rgb.txt"), "w") as f:
        f.write("# rgb\n# ts path\n" + "\n".join(rows) + "\n")
    if rgbd:
        with open(os.path.join(d, "depth.txt"), "w") as f:
            f.write("# depth\n# ts path\n" + "\n".join(drows) + "\n")
    traj_io.save_trajectory_tum(
        os.path.join(d, "groundtruth.txt"),
        [(1000.0 + i / args.fps, seq["poses"][i]) for i in range(args.frames)],
    )
    yaml = os.path.join(d, "settings.yaml")
    with open(yaml, "w") as f:
        _write_header(f, args, cam, bf=False)
        if rgbd:
            f.write(f"Camera.bf: {cam.bf}\n")
            f.write("DepthMapFactor: 5000.0\n")
        f.write("Camera.RGB: 1\nThDepth: 35.0\n")
        _write_extractor(f, args)
        _tracker_overrides(f, close_pts=rgbd)
    print(f"dataset at {d} (settings: {yaml})")
    return 0


def add_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("kind", choices=("kitti", "tum-mono", "tum-rgbd", "euroc"))
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--landmarks", type=int, default=None)
    p.add_argument("--radius", type=float, default=None)
    p.add_argument("--fps", type=float, default=10.0)
    p.add_argument("--features", type=int, default=None)
    p.add_argument("--max-keyframes", type=int, default=None)
    p.add_argument("--max-points", type=int, default=None)
    p.add_argument("--blackout-at", type=int, default=-1,
                   help="first frame of a blank-image segment "
                        "(forces LOST -> relocalization)")
    p.add_argument("--blackout-len", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=1,
                   help="parallel render processes (kitti only, without a blackout: "
                        "each renders and writes chunks of 16 frames); at 1, or with a "
                        "blackout, the whole sequence is rendered in this process and "
                        "held in memory before it is written (600 frames: ~2.2 GB)")
    p.add_argument("--revolutions", type=float, default=1.08,
                   help="loop laps: 1.08 = one lap + 8%% revisit; >2 "
                        "gives a full second lap of continuous revisit "
                        "(repeated loop-closure events)")
    p.add_argument("--device", default="cuda",
                   help="checked as the other tools check it (default cuda, which raises "
                        "without a card; cpu): the rendering is NumPy on the host on "
                        "either")
    return p


def main(args) -> int:
    torch_device(args.device)
    kind = "tum" if args.kind.startswith("tum") else args.kind
    frames, landmarks, radius, features, max_kf, max_pt = DEFAULTS[kind]
    args.frames = args.frames or frames
    args.landmarks = args.landmarks or landmarks
    args.radius = args.radius or radius
    args.features = args.features or features
    args.max_keyframes = args.max_keyframes or max_kf
    args.max_points = args.max_points or max_pt
    if kind == "kitti":
        return gen_kitti(args)
    if kind == "euroc":
        return gen_euroc(args)
    return gen_tum(args, rgbd=args.kind == "tum-rgbd")
