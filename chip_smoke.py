"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's per-frame tracking through its two hand-written CUDA
kernels (kernel 1 gathers every pyramid level of an image, or both
sides of the stereo SAD, in one launch; kernel 2 is one launch per pose
optimization) and checks each kernel and each path against their plain
PyTorch versions: the mono step of slice 1 (640x480 / 1000 features /
a 2048-point local map), the whole per-frame program
(`entry.track_frame_step`: stereo frame build, motion-model tracking,
local-map tracking, keyframe-decision counts) and the keyframe
insertion (`entry.grow_map_step`) at the KITTI configuration, 1241x376
/ 2000 features / a map of 384 keyframes and 131072 points, 200 and
110000 of them live. Phases, each of which raises on a failed check:

1. build both kernels from orb_slam2_test_tpu_torch/csrc (nvcc, sm_90a);
2. patch_gather vs its plain version on all 8 pyramid levels of a
   640x480 frame, in one launch and level by level: bit-exact;
3. pose_opt vs its plain version at 1000 observations: pose atol 1e-4,
   inlier agreement > 0.99, chi2 rtol 1e-3, n_inliers = its inlier count;
4. the tracking step on a scene its frame observes: 1 patch_gather
   launch and 1 pose_opt launch, translation error < 1 cm, inliers
   >= 80% of the map, the same step on the CPU within atol 1e-4 and 1%
   of the inliers, and at most 3 flipped descriptor bits between the
   card's bf16 BRIEF selection and the CPU's float32 one;
5. timing on the mono frame: each kernel alone (its C entry point on
   prepared buffers, 100 launches between two CUDA events after
   warm-up), per call through its wrapper and its plain version the
   same way; the step in ms per frame (CUDA events, median of 30);
6. the main path, one KITTI stereo frame through `track_frame_step` on
   `entry.kitti_scene`: exactly 3 patch_gather (left ORB, right ORB,
   both SAD sides) and 2 pose_opt launches, the local-map pose within
   1 cm of T_true, n_inliers >= 80% of the scene's points, a stereo
   depth on >= half the valid features,
   and the same frame on the CPU within pose atol 1e-4, 1% of the
   inliers and 1% of the features in the stereo-valid set;
7. both kernels on that frame's inputs: patch_gather bit-exact on the
   SAD coordinates of both sides in one 16-image launch (border-clipped
   windows included) and on each image's keypoints, pose_opt
   on its local-map problem with stereo rows (Tcw atol 1e-4, inlier
   agreement > 0.99, chi2 rtol 1e-3);
8. one RGB-D frame through `_build_and_track_device(sensor="rgbd")` at
   640x480 / 1000 features on a seeded depth map (untimed): 1 + 2
   launches, pose within 1 cm, the same frame on the CPU within atol
   1e-4 and 1% of the inliers;
9. KITTI timing, CUDA events (median of 30 after warm-up) and host wall:
   build_frame_stereo, _track_frame_device and track_frame_step; each
   kernel on that frame's inputs alone, per call through its wrapper,
   its plain version, for patch_gather the library call (indexing into
   `unfold` views at precomputed corners, which the port never calls),
   and pose_opt alone at O = 7 (the floor of its 40 dependent
   iterations); each kernel's bound (bytes over 3.35 TB/s or FLOP over
   67 TFLOP/s fp32, whichever is larger, from this run's inputs);
10. keyframe insertion on the main path, at full capacity on
   `entry.kitti_insert_scene` (four bands at 20-48 m, views 1.07 m
   apart): track view 1 -> full insert (`grow_map_step`, rebuild) ->
   track view 2 against the grown map -> light insert. Each tracked
   frame makes exactly 3 + 2 launches and lands within 1 cm of its true
   pose; the inserts launch neither kernel; the full insert creates
   points beyond its 100 depth points (triangulation); the caller's map
   and bitmap are unchanged; n_kf counts the live keyframes and no live
   link points at a dead slot; the full insert's bitmap has the
   incidence of `build_observer_bitmap` of its map; the first insert
   runs again under torch.cuda.set_sync_debug_mode("error") (no host
   sync); the same sequence on the CPU agrees: kf ids and culled equal,
   n_pt within 1%, links >= 99% equal. Each insert runs again on the
   CPU from the card's own inputs: kf ids and culled equal, n_pt within
   0.1%, links >= 99.9% equal. The inserted keyframes lie within 1 cm
   of their true poses. The live poses agree with the CPU's within
   INSERT_POSE_ATOL: 2e-3 for the sequence, and from the same inputs
   1e-4 (full) and 2e-3 (light, whose local BA is ill-conditioned in
   float32, in the JAX package alike). The run also prints how far the
   light insert's poses spread when the tracked pose moves by 1e-6 m,
   on the card and on the CPU, and how far the card's light insert
   lands from itself when repeated;
11. insertion timing at the JAX bench's inputs (the bench map at 200 /
   110000, a frame of two random images, T = I, random links,
   frame id 99): a full and a light insert, in turns, CUDA events and
   host wall (medians of 20 after warm-up), and the amortized KITTI ms/frame,
   track_frame_step + (full + 3 light) / 4 / KF_EVERY with KF_EVERY
   read from runs/kitti00_full/summary.json.

It imports only the port, numpy and the standard library. It needs one
CUDA card and exits non-zero, printing no result, without one. The last
line is the JSON object {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
N_TIMED = 30
N_WARMUP = 5


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def _cuda_ms(fn, n=N_TIMED, warmup=N_WARMUP) -> float:
    """Median device time of fn() in ms, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _loop_ms(fn, n=100, warmup=10) -> float:
    """Device ms per call of fn(): n calls back to back between two CUDA
    events, after warm-up. Where a call's host work outlasts its
    kernels, the events see the device wait for the host, so a call
    through a wrapper shows its host time too."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


# the card's peaks (NVIDIA's H100 SXM data sheet, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# card-vs-CPU bounds on the live keyframe poses after each insert of
# phase 10: (the whole sequence on each device, each insert from the
# card's inputs). The light insert's local BA is ill-conditioned in
# float32, in the JAX package alike (PERF.md): a 1e-6 m change of the
# tracked pose moves its free keyframes by 2e-3 to 1.1e-2, so a change
# of the code that moves its inputs by rounding can cross its 2e-3; the
# run prints that spread beside the gap
INSERT_POSE_ATOL = {"full": (2e-3, 1e-4), "light": (2e-3, 2e-3)}

# kernel 2's FLOP per valid observation: a residual is 42 (pose
# transform 18, projection and stereo column 12, residuals and chi2
# 12); a Gauss-Newton term adds the Huber weight and Jacobian rows
# (39) and 27 weighted sums of 3 products (189): 270
POSE_FLOP_RES = 42
POSE_FLOP_GN = 270


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of bytes over
    its memory rate and FLOP over its fp32 rate, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _gather_bytes(images, xy) -> int:
    """Kernel 1's bytes for one launch: each image and xy read once, the
    [N, 38, 38] float32 windows written once."""
    return 4 * (sum(i.numel() for i in images) + xy.numel() + xy.shape[0] * 38 * 38)


def _pose_bound(X, valid, rounds=4, iters=10) -> tuple[float, str]:
    """Kernel 2's bound on one problem: bytes of X, obs, inv_sigma2,
    valid and the pose in, the pose, inliers, chi2 and count out; FLOP
    of rounds x iters Gauss-Newton passes and rounds + 1 residual passes
    over the valid observations."""
    O = X.shape[0]
    nbytes = O * (12 + 12 + 4 + 1) + 64 + 64 + O * (1 + 4) + 4
    flops = int(valid.sum()) * (rounds * iters * POSE_FLOP_GN + (rounds + 1) * POSE_FLOP_RES)
    return _bound(nbytes, flops)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _bins(angle: np.ndarray) -> np.ndarray:
    return np.round(np.mod(angle, 2 * np.pi) * (30 / (2 * np.pi))).astype(int) % 30


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "one CUDA card", file=sys.stderr)
        return 1

    from orb_slam2_test_tpu_torch import entry
    from orb_slam2_test_tpu_torch.engine.frame import build_frame_mono, build_frame_stereo
    from orb_slam2_test_tpu_torch.ops import patches
    from orb_slam2_test_tpu_torch.ops.extractor import level_feature_budget
    from orb_slam2_test_tpu_torch.ops.pyramid import build_pyramid
    from orb_slam2_test_tpu_torch.solvers import pose_opt, pose_opt_cuda
    from orb_slam2_test_tpu_torch.utils import cuda_build
    from orb_slam2_test_tpu_torch.utils.precision import f32_matmuls

    t_run = time.perf_counter()
    dev = torch.device("cuda", 0)
    f32_matmuls()
    rng = np.random.default_rng(SEED)
    card = _card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} ({card})")

    # -- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    _, info = cuda_build.load_library()
    print(f"[1] build: {info.path.name} in {info.seconds:.2f} s nvcc "
          f"({time.perf_counter() - t0:.2f} s with load, cached={info.cached})")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print("    ptxas:", line.strip())

    # -- 2. patch_gather vs plain, all 8 levels of a 640x480 frame -------
    img = torch.from_numpy(entry.texture_image(rng, 480, 640)).to(dev).float()
    pyr = build_pyramid(img, entry.N_LEVELS, entry.SCALE_FACTOR)
    budgets = level_feature_budget(entry.N_FEATURES, entry.N_LEVELS, entry.SCALE_FACTOR)
    level_xy = []
    for level_img, n_l in zip(pyr, budgets):
        h, w = level_img.shape
        xy = np.stack([rng.uniform(-5, w + 5, n_l), rng.uniform(-5, h + 5, n_l)], 1)
        xy[: n_l // 4] = np.round(xy[: n_l // 4]) + 0.5  # half-way: rounds to even
        level_xy.append(torch.from_numpy(xy.astype(np.float32)).to(dev))
    mono_xy = torch.cat(level_xy)
    got = patches.extract_raw_patches_levels_cuda(pyr, mono_xy, budgets)
    ref = patches.extract_raw_patches_levels_plain(pyr, mono_xy, budgets)
    torch.cuda.synchronize()
    _check(torch.equal(got, ref), "patch_gather (8 levels, one launch) != plain")
    patch_err = float((got - ref).abs().max())
    for level_img, xy in zip(pyr, level_xy):
        got = patches.extract_raw_patches_cuda(level_img, xy)
        ref = patches.extract_raw_patches_plain(level_img, xy)
        torch.cuda.synchronize()
        _check(torch.equal(got, ref), f"patch_gather != plain at {tuple(level_img.shape)}")
        patch_err = max(patch_err, float((got - ref).abs().max()))
    print(f"[2] patch_gather: bit-exact on {len(pyr)} levels in one launch and level "
          f"by level, n_l={budgets}, shapes={[tuple(p.shape) for p in pyr]}")

    # -- 3. pose_opt vs plain at O = 1000 --------------------------------
    cam_p, T_true_p, T0_p, X_p, obs_p = entry.pose_problem(rng)
    O = X_p.shape[0]
    pose_args = (
        torch.from_numpy(T0_p).float().to(dev), torch.from_numpy(X_p).to(dev),
        torch.from_numpy(obs_p).to(dev), torch.ones(O, device=dev),
        torch.ones(O, dtype=torch.bool, device=dev),
    )
    k_T, k_inl, k_n, k_chi2 = pose_opt_cuda.pose_optimization_cuda(cam_p, *pose_args)
    ref = pose_opt._pose_optimization_plain(cam_p, *pose_args)
    torch.cuda.synchronize()
    pose_err = float((k_T - ref.Tcw).abs().max())
    agree = float((k_inl == ref.inliers).float().mean())
    chi2_ok = torch.allclose(k_chi2, ref.chi2, rtol=1e-3, atol=1e-3)
    print(f"[3] pose_opt: |T - plain| = {pose_err:.3e}, inlier agreement "
          f"{agree:.4f}, n_inliers {int(k_n)} (plain {int(ref.n_inliers)}), "
          f"|T - T_true| = {np.abs(k_T.cpu().numpy() - T_true_p).max():.3e}")
    _check(pose_err <= 1e-4, f"pose_opt Tcw differs from plain by {pose_err}")
    _check(agree > 0.99, f"pose_opt inlier agreement {agree}")
    _check(chi2_ok, "pose_opt chi2 differs from plain beyond rtol 1e-3")
    _check(int(k_n) == int(k_inl.sum()), "pose_opt n_inliers != its inlier count")

    # -- 4. the slice: tracking_step at 640x480 / 1000 / 2048 ------------
    cam = entry.CAM
    img_np, scene, T_true, T_pred = entry.example_scene(rng, dev)
    n_valid = int(scene[2].sum())
    state_card = entry.state_from_numpy(img_np, *scene, T_pred, device=dev)
    state_cpu = entry.state_from_numpy(img_np, *scene, T_pred, device="cpu")

    patches.PATCH_GATHER.launches = 0
    pose_opt_cuda.POSE_OPT.launches = 0
    Tcw, n_inl = entry.tracking_step(*state_card)
    torch.cuda.synchronize()
    launches = {"patch_gather": patches.PATCH_GATHER.launches,
                "pose_opt": pose_opt_cuda.POSE_OPT.launches}
    Tcw, n_inl = Tcw.cpu().numpy(), int(n_inl)
    print(f"[4] slice: launches {launches}, n_inliers {n_inl} of {n_valid} "
          f"valid map points")
    _check(launches == {"patch_gather": 1, "pose_opt": 1}, f"launches {launches}")
    _check(np.isfinite(Tcw).all(), "non-finite pose")
    t_err = float(np.abs(Tcw[:3, 3] - T_true[:3, 3]).max())
    print(f"    translation error {t_err:.3e} m, rotation error "
          f"{np.abs(Tcw[:3, :3] - T_true[:3, :3]).max():.3e}")
    _check(t_err < 1e-2, f"translation error {t_err} m")
    _check(n_inl >= 0.8 * n_valid, f"{n_inl} inliers of {n_valid}")

    Tcw_cpu, n_inl_cpu = entry.tracking_step(*state_cpu)
    Tcw_cpu, n_inl_cpu = Tcw_cpu.numpy(), int(n_inl_cpu)
    cpu_err = float(np.abs(Tcw - Tcw_cpu).max())
    print(f"    vs CPU: |T - T_cpu| = {cpu_err:.3e}, n_inliers {n_inl} vs {n_inl_cpu}")
    _check(cpu_err <= 1e-4, f"card vs CPU pose differs by {cpu_err}")
    _check(abs(n_inl - n_inl_cpu) <= 0.01 * max(n_inl, n_inl_cpu),
           f"n_inliers {n_inl} vs CPU {n_inl_cpu}")

    frame_card = build_frame_mono(torch.from_numpy(img_np).to(dev), 0.0, cam)
    frame_np = type(frame_card)(*[x.cpu().numpy() for x in frame_card])
    frame_cpu = build_frame_mono(torch.from_numpy(img_np), 0.0, cam)
    for field in ("uv", "level", "valid"):
        _check(np.array_equal(getattr(frame_np, field), getattr(frame_cpu, field).numpy()),
               f"card and CPU frames differ in {field}")
    valid = frame_np.valid
    a_card, a_cpu = frame_np.angle[valid], frame_cpu.angle.numpy()[valid]
    same_bin = _bins(a_card) == _bins(a_cpu)
    # a bin may differ only where the angle lies within 1e-3 rad of a
    # bin boundary (half-way between bin centres)
    frac = np.mod(a_cpu * 30 / (2 * np.pi), 1.0)
    near_edge = np.abs(frac - 0.5) * (2 * np.pi / 30) < 1e-3
    _check(bool(np.all(same_bin | near_edge)),
           "an angle-bin change away from a bin boundary")
    flips = np.unpackbits(
        (frame_np.desc[valid] ^ frame_cpu.desc.numpy()[valid]).view(np.uint8), axis=1
    ).sum(1)[same_bin]
    print(f"    bf16 vs fp32 BRIEF selection: flipped bits per descriptor mean "
          f"{flips.mean():.3f}, max {flips.max()}; angle max diff "
          f"{np.abs(a_card - a_cpu).max():.2e}; {int((~same_bin).sum())} bin changes")
    _check(flips.max() <= 3, f"{flips.max()} flipped bits")

    # -- 5. timing -------------------------------------------------------
    g_args, _ = patches.gather_launch_args(pyr, mono_xy, budgets)
    p_args, _ = pose_opt_cuda.pose_opt_launch_args(cam_p, *pose_args)
    times = {  # (alone, per call through the wrapper, plain)
        "patch_gather": (
            _loop_ms(lambda: patches.PATCH_GATHER(*g_args)),
            _loop_ms(lambda: patches.extract_raw_patches_levels(pyr, mono_xy, budgets)),
            _loop_ms(lambda: patches.extract_raw_patches_levels_plain(pyr, mono_xy, budgets)),
        ),
        "pose_opt": (
            _loop_ms(lambda: pose_opt_cuda.POSE_OPT(*p_args)),
            _loop_ms(lambda: pose_opt.pose_optimization(cam_p, *pose_args)),
            _loop_ms(lambda: pose_opt._pose_optimization_plain(cam_p, *pose_args),
                     n=5, warmup=1),
        ),
    }
    step_ms_mono = _cuda_ms(lambda: entry.tracking_step(*state_card))
    t0 = time.perf_counter()
    for _ in range(N_TIMED):
        entry.tracking_step(*state_card)
    torch.cuda.synchronize()
    step_wall_ms = (time.perf_counter() - t0) * 1e3 / N_TIMED
    bounds_mono = {"patch_gather": _bound(_gather_bytes(pyr, mono_xy), 0),
                   "pose_opt": _pose_bound(pose_args[1], pose_args[4])}
    for name, (k_ms, c_ms, p_ms) in times.items():
        b_ms, b_by = bounds_mono[name]
        print(f"[5] {name}: alone {k_ms:.4f} ms, per call {c_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms; bound {b_ms:.6f} ms ({b_by}), {b_ms / k_ms:.2%} of it "
              f"alone (one launch: the mono frame's 8 levels / O = {O}; {card})")
    print(f"[5] tracking_step: {step_ms_mono:.3f} ms/frame on CUDA events, "
          f"{step_wall_ms:.3f} ms/frame host wall ({card})")

    # -- 6. the main path: one KITTI stereo frame --------------------------
    from orb_slam2_test_tpu_torch.engine import tracking
    from orb_slam2_test_tpu_torch.ops import stereo
    from orb_slam2_test_tpu_torch.ops.extractor import extract_orb

    kcam, kcfg = entry.KITTI_CAM, entry.KITTI_CFG
    t0 = time.perf_counter()
    scene = entry.kitti_scene(np.random.default_rng(SEED + 1), dev)
    kin = entry.scene_inputs(scene, dev)
    torch.cuda.synchronize()
    print(f"[6] KITTI scene: {kcam.width}x{kcam.height}, {kcfg.n_features} features, "
          f"K={kcfg.max_keyframes} P={kcfg.max_points}, {entry.KITTI_N_KF} keyframes / "
          f"{entry.KITTI_N_PT} points live, {scene.n_scene} scene points, bitmap "
          f"{tuple(kin[1].shape)} {kin[1].dtype} ({time.perf_counter() - t0:.1f} s set-up)")

    patches.PATCH_GATHER.launches = 0
    pose_opt_cuda.POSE_OPT.launches = 0
    kframe, kouts = entry.track_frame_step(*kin)
    torch.cuda.synchronize()
    k_launches = {"patch_gather": patches.PATCH_GATHER.launches,
                  "pose_opt": pose_opt_cuda.POSE_OPT.launches}
    T_k = kouts[5].cpu().numpy()
    n_inl_k, n_valid_k = int(kouts[6]), int(kframe.valid.sum())
    stereo_k = kframe.ur.cpu().numpy() >= 0
    t_err_k = float(np.abs(T_k[:3, 3] - scene.T_true[:3, 3]).max())
    print(f"    launches {k_launches}; motion: {int(kouts[0])} matches, {int(kouts[1])} "
          f"inliers; local map: {n_inl_k} inliers of {scene.n_scene} scene points, "
          f"translation error {t_err_k:.3e} m; stereo depth on {int(stereo_k.sum())} "
          f"of {n_valid_k} valid features; close {int(kouts[10])} tracked / "
          f"{int(kouts[11])} untracked")
    _check(k_launches == {"patch_gather": 3, "pose_opt": 2}, f"launches {k_launches}")
    for i, o in enumerate(kouts):
        _check(bool(torch.isfinite(o.float()).all()), f"output {i} not finite")
    _check(t_err_k < 1e-2, f"KITTI translation error {t_err_k} m")
    _check(n_inl_k >= 0.8 * scene.n_scene, f"{n_inl_k} inliers of {scene.n_scene}")
    _check(stereo_k.sum() >= 0.5 * n_valid_k, f"stereo on {stereo_k.sum()} of {n_valid_k}")

    cframe, couts = entry.track_frame_step(*entry.scene_inputs(scene, "cpu"))
    cpu_err_k = float(np.abs(T_k - couts[5].numpy()).max())
    stereo_c = cframe.ur.numpy() >= 0
    n_xor = int((stereo_k ^ stereo_c).sum())
    print(f"    vs CPU: |T - T_cpu| = {cpu_err_k:.3e}, n_inliers {n_inl_k} vs "
          f"{int(couts[6])}, stereo-valid sets differ on {n_xor} features")
    _check(cpu_err_k <= 1e-4, f"KITTI card vs CPU pose differs by {cpu_err_k}")
    _check(abs(n_inl_k - int(couts[6])) <= 0.01 * max(n_inl_k, int(couts[6])),
           f"KITTI n_inliers {n_inl_k} vs CPU {int(couts[6])}")
    _check(n_xor <= 0.01 * kcfg.n_features, f"stereo-valid sets differ on {n_xor}")

    # -- 7. both kernels on that frame's inputs ------------------------------
    img_l, img_r = kin[2].float(), kin[3].float()
    lp = build_pyramid(img_l, kcfg.n_levels, kcfg.scale_factor)
    rp = build_pyramid(img_r, kcfg.n_levels, kcfg.scale_factor)
    kw = dict(n_features=kcfg.n_features, n_levels=kcfg.n_levels,
              scale_factor=kcfg.scale_factor)
    fl = extract_orb(img_l, pyramid=lp, **kw)
    fr = extract_orb(img_r, pyramid=rp, **kw)
    max_disp = kcam.bf / (kcam.bf / kcam.width)  # as stereo_match computes it
    _, j = stereo.associate(fl, fr, max_disp, kcfg.n_levels, kcfg.scale_factor)
    sc = stereo.sad_coordinates(fl, fr, j, **kw)
    left_levels = [lp[l] for l in sc.levels]
    right_levels = [rp[l] for l in sc.levels]
    # the 3 launches of one stereo frame: each image's keypoints (in level
    # coordinates) and the SAD windows of both sides
    frame_gathers = [
        (left_levels, sc.xy_l, sc.counts),
        (right_levels, fr.uv * sc.inv_s[:, None], sc.counts),
        (left_levels + right_levels, torch.cat([sc.xy_l, sc.xy_r]), sc.counts * 2),
    ]
    for images, xy, counts in frame_gathers:
        got = patches.extract_raw_patches_levels_cuda(images, xy, counts)
        ref = patches.extract_raw_patches_levels_plain(images, xy, counts)
        torch.cuda.synchronize()
        _check(torch.equal(got, ref), f"patch_gather != plain on {len(images)} images")
        patch_err = max(patch_err, float((got - ref).abs().max()))
    shapes = np.repeat([rp[l].shape for l in sc.levels], sc.counts, axis=0)
    corner = np.round(sc.xy_r.cpu().numpy()[:, ::-1]) - patches.PATCH_EX // 2  # (y0, x0)
    n_clipped = int(((corner < 0) | (corner > shapes - patches.PATCH_EX)).any(1).sum())
    print(f"[7] patch_gather: bit-exact on the SAD coordinates of both sides "
          f"({len(sc.levels)} levels x 2 images, one launch; {n_clipped} of "
          f"{kcfg.n_features} right windows clipped at a border) and on each "
          f"image's keypoints")

    m_k, bm_k = kin[0], kin[1]
    _, _, lm_feat = tracking._local_map_matches(
        kcam, kcfg, m_k, bm_k, kframe, kouts[2], kouts[13])
    X_k = m_k.pt_xyz[lm_feat.clamp(min=0).long()]
    lm_args = tracking._pose_inputs(kcfg, kframe, X_k, lm_feat >= 0)
    n_obs = int(lm_args[3].sum())
    n_stereo_rows = int((lm_args[3] & (lm_args[1][:, 2] >= 0)).sum())
    k2 = pose_opt.pose_optimization(kcam, kouts[2], *lm_args)
    k2_ref = pose_opt._pose_optimization_plain(kcam, kouts[2], *lm_args)
    torch.cuda.synchronize()
    pose_err_k = float((k2.Tcw - k2_ref.Tcw).abs().max())
    agree_k = float((k2.inliers == k2_ref.inliers).float().mean())
    print(f"    pose_opt on the local-map problem (O={lm_args[0].shape[0]}, {n_obs} "
          f"observations, {n_stereo_rows} stereo rows): |T - plain| = "
          f"{pose_err_k:.3e}, inlier agreement {agree_k:.4f}, |T - track| = "
          f"{float((k2.Tcw - kouts[5]).abs().max()):.3e}")
    _check(n_stereo_rows > 0.3 * n_obs, f"{n_stereo_rows} stereo rows of {n_obs}")
    _check(pose_err_k <= 1e-4, f"pose_opt (KITTI) differs from plain by {pose_err_k}")
    _check(agree_k > 0.99, f"pose_opt (KITTI) inlier agreement {agree_k}")
    _check(torch.allclose(k2.chi2, k2_ref.chi2, rtol=1e-3, atol=1e-3),
           "pose_opt (KITTI) chi2 differs from plain beyond rtol 1e-3")
    _check(int(k2.n_inliers) == int(k2.inliers.sum()), "pose_opt (KITTI) n_inliers")
    pose_err = max(pose_err, pose_err_k)

    # -- 8. one RGB-D frame at 640x480 / 1000 features -----------------------
    rcfg = tracking.TrackerConfig(n_features=1000)
    rscene = entry.tracking_scene(
        np.random.default_rng(SEED + 2), "rgbd", entry.RGBD_CAM, rcfg, 100, 20000, dev)
    rin = entry.scene_inputs(rscene, dev)
    patches.PATCH_GATHER.launches = 0
    pose_opt_cuda.POSE_OPT.launches = 0
    rframe, routs = tracking._build_and_track_device(entry.RGBD_CAM, rcfg, "rgbd", *rin)
    torch.cuda.synchronize()
    r_launches = {"patch_gather": patches.PATCH_GATHER.launches,
                  "pose_opt": pose_opt_cuda.POSE_OPT.launches}
    _, routs_c = tracking._build_and_track_device(
        entry.RGBD_CAM, rcfg, "rgbd", *entry.scene_inputs(rscene, "cpu"))
    T_r = routs[5].cpu().numpy()
    t_err_r = float(np.abs(T_r[:3, 3] - rscene.T_true[:3, 3]).max())
    cpu_err_r = float(np.abs(T_r - routs_c[5].numpy()).max())
    n_r, n_rc = int(routs[6]), int(routs_c[6])
    print(f"[8] RGB-D 640x480: launches {r_launches}, {n_r} inliers of "
          f"{rscene.n_scene} scene points, depth on {int((rframe.depth > 0).sum())} "
          f"features, translation error {t_err_r:.3e} m; vs CPU |T - T_cpu| = "
          f"{cpu_err_r:.3e}, n_inliers {n_r} vs {n_rc}")
    _check(r_launches == {"patch_gather": 1, "pose_opt": 2}, f"RGB-D launches {r_launches}")
    _check(t_err_r < 1e-2, f"RGB-D translation error {t_err_r} m")
    _check(cpu_err_r <= 1e-4, f"RGB-D card vs CPU pose differs by {cpu_err_r}")
    _check(abs(n_r - n_rc) <= 0.01 * max(n_r, n_rc), f"RGB-D n_inliers {n_r} vs {n_rc}")

    # -- 9. KITTI timing -------------------------------------------------------
    # kernel 1's library yardstick: one advanced index into the
    # [H-37, W-37, 38, 38] unfold view per image, at corners computed
    # beforehand (the port never calls it)
    library_gathers = []
    for images, xy, counts in frame_gathers:
        start = 0
        for img, n in zip(images, counts):
            h, w = img.shape
            seg = xy[start : start + n]
            start += n
            x0 = (torch.round(seg[:, 0]).long() - 19).clamp(0, w - 38)
            y0 = (torch.round(seg[:, 1]).long() - 19).clamp(0, h - 38)
            library_gathers.append((img.unfold(0, 38, 1).unfold(1, 38, 1), y0, x0))

    def library_frame():
        return [view[y0, x0] for view, y0, x0 in library_gathers]

    _check(torch.equal(torch.cat(library_frame()), torch.cat(
        [patches.extract_raw_patches_levels_plain(*g) for g in frame_gathers])),
        "the unfold indexing differs from the plain gather")
    gather_args = [patches.gather_launch_args(*g)[0] for g in frame_gathers]
    lm_launch, _ = pose_opt_cuda.pose_opt_launch_args(kcam, kouts[2], *lm_args)
    cam7, _, T0_7, X_7, obs_7 = entry.pose_problem(np.random.default_rng(SEED + 3), 7)
    args7 = (cam7, torch.from_numpy(T0_7).to(dev), torch.from_numpy(X_7).to(dev),
             torch.from_numpy(obs_7).to(dev), torch.ones(7, device=dev),
             torch.ones(7, dtype=torch.bool, device=dev))
    launch7, _ = pose_opt_cuda.pose_opt_launch_args(*args7)
    times_k = {
        "patch_gather": {
            "kernel_ms": _loop_ms(lambda: [patches.PATCH_GATHER(*a) for a in gather_args]),
            "call_ms": _loop_ms(lambda: [patches.extract_raw_patches_levels(*g)
                                         for g in frame_gathers]),
            "plain_ms": _loop_ms(lambda: [patches.extract_raw_patches_levels_plain(*g)
                                          for g in frame_gathers]),
            "library_ms": _loop_ms(library_frame),
        },
        "pose_opt": {
            "kernel_ms": _loop_ms(lambda: pose_opt_cuda.POSE_OPT(*lm_launch)),
            "call_ms": _loop_ms(lambda: pose_opt.pose_optimization(kcam, kouts[2], *lm_args)),
            "plain_ms": _loop_ms(
                lambda: pose_opt._pose_optimization_plain(kcam, kouts[2], *lm_args),
                n=5, warmup=1),
            "library_ms": None,
            "kernel_ms_O7": _loop_ms(lambda: pose_opt_cuda.POSE_OPT(*launch7)),
        },
    }
    bounds = {
        "patch_gather": _bound(sum(_gather_bytes(i, xy) for i, xy, _ in frame_gathers), 0),
        "pose_opt": _pose_bound(lm_args[0], lm_args[3]),
    }
    bound7 = _pose_bound(args7[2], args7[5])
    m_in, bm_in, img_a, img_b = kin[:4]
    track_args = (m_in, bm_in, kframe) + tuple(kin[5:])
    steps = {
        "build_frame_stereo": lambda: build_frame_stereo(
            img_a, img_b, 0.0, kcam, **kw),
        "_track_frame_device": lambda: tracking._track_frame_device(
            kcam, kcfg, *track_args),
        "track_frame_step": lambda: entry.track_frame_step(*kin),
    }
    step_ms = {}
    for name, fn in steps.items():
        ev = _cuda_ms(fn)
        t0 = time.perf_counter()
        for _ in range(N_TIMED):
            fn()
        torch.cuda.synchronize()
        step_ms[name] = (ev, (time.perf_counter() - t0) * 1e3 / N_TIMED)
        print(f"[9] {name}: {ev:.3f} ms/frame on CUDA events, "
              f"{step_ms[name][1]:.3f} ms/frame host wall ({card})")
    units = {"patch_gather": "the KITTI stereo frame's 3 launches",
             "pose_opt": f"one launch, the local-map problem at O = {lm_args[0].shape[0]}"}
    for name, t in times_k.items():
        b_ms, b_by = bounds[name]
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        print(f"[9] {name}: alone {t['kernel_ms']:.4f} ms, per call {t['call_ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, library {lib}; bound {b_ms:.5f} ms "
              f"({b_by}), {b_ms / t['kernel_ms']:.2%} of it alone ({units[name]}; {card})")
    print(f"[9] pose_opt at O = 7: alone {times_k['pose_opt']['kernel_ms_O7']:.4f} ms, "
          f"bound {bound7[0]:.6f} ms ({bound7[1]}): the floor of 40 dependent "
          f"iterations ({card})")

    # -- 10. keyframe insertion on the main path ---------------------------
    from orb_slam2_test_tpu_torch.slam_map.covisibility import build_observer_bitmap

    def counts():
        return {"patch_gather": patches.PATCH_GATHER.launches,
                "pose_opt": pose_opt_cuda.POSE_OPT.launches}

    def zero():
        patches.PATCH_GATHER.launches = 0
        pose_opt_cuda.POSE_OPT.launches = 0

    iscene = entry.kitti_insert_scene(np.random.default_rng(SEED + 1), dev)

    def insert_sequence(device):
        """track view 1 -> full insert -> track view 2 -> light insert,
        with the launch counts of each step."""
        m0 = entry.map_from_numpy(iscene.map, device)
        bm0 = build_observer_bitmap(m0)
        steps, launches = {}, {}
        zero()
        steps["track1"] = entry.track_insert_view(
            iscene, 1, m0, bm0, entry.frame_from_numpy(iscene.last_frame, device),
            torch.from_numpy(iscene.last_feat_pt).to(device),
            torch.zeros((), dtype=torch.int32, device=device))
        launches["track1"] = counts()
        f1, o1 = steps["track1"]
        zero()
        steps["full"] = entry.grow_map_step(
            m0, bm0, f1, o1[5], o1[7], 1.0, 1, iscene.close_depth, True)
        launches["full"] = counts()
        g1 = steps["full"]
        zero()
        steps["track2"] = entry.track_insert_view(iscene, 2, g1[0], g1[4], f1, o1[7], g1[1])
        launches["track2"] = counts()
        f2, o2 = steps["track2"]
        zero()
        steps["light"] = entry.grow_map_step(
            g1[0], g1[4], f2, o2[5], o2[7], 2.0, 2, iscene.close_depth, False)
        launches["light"] = counts()
        return (m0, bm0), steps, launches

    (m0, bm0), seq, ins_launches = insert_sequence(dev)
    torch.cuda.synchronize()
    print(f"[10] insert scene: {iscene.n_scene} points of view 0 in the bench map, "
          f"launches {ins_launches}")
    for step, want in (("track1", (3, 2)), ("full", (0, 0)), ("track2", (3, 2)),
                       ("light", (0, 0))):
        got = ins_launches[step]
        _check(got == dict(zip(("patch_gather", "pose_opt"), want)),
               f"{step} launches {got}")
    for i, step in ((1, "track1"), (2, "track2")):
        T = seq[step][1][5].cpu().numpy()
        err = float(np.abs(T[:3, 3] - iscene.T_true[i][:3, 3]).max())
        print(f"    {step}: {int(seq[step][1][6])} inliers, translation error {err:.3e} m")
        _check(err < 1e-2, f"{step} translation error {err} m")
    g1, g2 = seq["full"], seq["light"]
    n_before = int(iscene.map["n_pt"])
    created = int((g1[0].pt_valid & (g1[0].pt_first_kf == 1)).sum())
    print(f"    full insert: kf {int(g1[1])}, culled {int(g1[2])}, n_pt {n_before} -> "
          f"{int(g1[3])}, {created} points created (at most 100 from depth, so >= "
          f"{created - 100} triangulated); light insert: kf {int(g2[1])}, n_pt {int(g2[3])}")
    _check(created > 100, f"the full insert created {created} points: none triangulated")
    fresh = entry.map_from_numpy(iscene.map, dev)
    for name, a, b in zip(m0._fields, m0, fresh):
        _check(torch.equal(a, b), f"the inserts changed their input map: {name}")
    _check(torch.equal(bm0, build_observer_bitmap(fresh)), "the inserts changed their input bitmap")
    for name, g in (("full", g1), ("light", g2)):
        m = g[0]
        _check(int(m.n_kf) == int(m.kf_valid.sum()), f"{name}: n_kf != live keyframes")
        idx = m.kf_pt_idx[m.kf_valid]
        _check(bool(m.pt_valid[idx[idx >= 0].long()].all()), f"{name}: a link to a dead slot")
    _check(torch.equal(g1[4] > 0, build_observer_bitmap(g1[0]) > 0),
           "full insert's bitmap != build_observer_bitmap of its map")

    torch.cuda.set_sync_debug_mode("error")
    try:
        again = entry.grow_map_step(m0, bm0, seq["track1"][0], seq["track1"][1][5],
                                    seq["track1"][1][7], 1.0, 1, iscene.close_depth, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _check(int(again[1]) == int(g1[1]), "the insert under sync debug mode differs")
    print("    the full insert ran again under set_sync_debug_mode('error'): no host sync")

    def against(a, b):
        """(live poses' largest gap, the keyframe where it lies, share of
        equal links) between two inserts' maps."""
        A, B = entry.map_to_numpy(a[0]), entry.map_to_numpy(b[0])
        live = np.flatnonzero(A["kf_valid"])
        gaps = np.abs(A["kf_Tcw"][live] - B["kf_Tcw"][live]).reshape(len(live), -1).max(1)
        linked = (A["kf_pt_idx"] >= 0) | (B["kf_pt_idx"] >= 0)
        return (float(gaps.max()), int(live[gaps.argmax()]),
                float((A["kf_pt_idx"] == B["kf_pt_idx"])[linked].mean()))

    def on(x, device):
        return type(x)(*[t.to(device) for t in x])

    # each insert again from the card's own inputs: the gap that the
    # insertion program itself leaves between the two devices
    f1, o1 = seq["track1"]
    f2, o2 = seq["track2"]
    inputs = {"full": (m0, bm0, f1, o1[5], o1[7], 1.0, 1, iscene.close_depth, True),
              "light": (g1[0], g1[4], f2, o2[5], o2[7], 2.0, 2, iscene.close_depth, False)}

    def insert(name, device, dt=None):
        """The insert `name` from the card's inputs on `device`, with the
        tracked pose's translation moved by dt (m) if given."""
        m, bm, f, T, feat, *rest = inputs[name]
        T = T.to(device, copy=True)
        if dt is not None:
            T[:3, 3] += torch.tensor(dt, dtype=T.dtype, device=T.device)
        return entry.grow_map_step(on(m, device), bm.to(device), on(f, device), T,
                                   feat.to(device), *rest)

    same = {name: insert(name, "cpu") for name in inputs}
    # the light insert's spread under rounding: the same insert from the
    # tracked pose moved by 1e-6 m along x, y and z, on the card and on
    # the CPU (the JAX package's light insert moves as much; PERF.md)
    spread = {}
    for device, base in (("cuda", g2), ("cpu", same["light"])):
        outs = [base] + [insert("light", device, 1e-6 * (np.arange(3) == i)) for i in range(3)]
        spread[device] = max(against(a, b)[0] for i, a in enumerate(outs) for b in outs[i + 1:])
    repeat_gap = against(g2, insert("light", "cuda"))[0]
    print(f"    light insert from the tracked pose moved by 1e-6 m along x, y, z: live "
          f"poses spread {spread['cuda']:.3e} on the card, {spread['cpu']:.3e} on the CPU; "
          f"the card's light insert repeated: {repeat_gap:.3e}")
    _, cseq, _ = insert_sequence("cpu")
    same_gap = {}
    for name in ("full", "light"):
        a, b, s = seq[name], cseq[name], same[name]
        kf_err, kf_at, links = against(a, b)
        same_gap[name], same_at, same_links = against(a, s)
        # the scene's keyframes 200 and 201 are views 1 and 2
        live = a[0].kf_valid.cpu().numpy()
        Tk = a[0].kf_Tcw.cpu().numpy()
        truth = {kf: float(np.abs(Tk[kf][:3, 3] - iscene.T_true[v][:3, 3]).max())
                 for kf, v in ((int(g1[1]), 1), (int(g2[1]), 2)) if live[kf]}
        print(f"    {name} vs CPU: kf {int(a[1])}/{int(b[1])}, culled {int(a[2])}/{int(b[2])}, "
              f"n_pt {int(a[3])}/{int(b[3])}, live poses within {kf_err:.3e} (kf {kf_at}), "
              f"links equal {links:.5f}; from the card's inputs: n_pt {int(s[3])}, "
              f"live poses within {same_gap[name]:.3e} (kf {same_at}), links equal "
              f"{same_links:.5f}; keyframes from the truth (m): "
              + ", ".join(f"{kf} {e:.3e}" for kf, e in truth.items()))
        _check(int(a[1]) == int(b[1]) and int(a[2]) == int(b[2]), f"{name}: kf ids vs CPU")
        _check(abs(int(a[3]) - int(b[3])) <= 0.01 * int(b[3]), f"{name}: n_pt vs CPU")
        _check(links >= 0.99, f"{name}: links equal {links}")
        _check(int(s[1]) == int(a[1]) and int(s[2]) == int(a[2]),
               f"{name}: kf ids differ from the CPU on the same inputs")
        _check(abs(int(s[3]) - int(a[3])) <= 1e-3 * int(a[3]),
               f"{name}: n_pt {int(a[3])} vs {int(s[3])} on the CPU on the same inputs")
        _check(same_links >= 0.999, f"{name}: links equal {same_links} on the same inputs")
        _check(max(truth.values()) < 1e-2, f"{name}: keyframes from the truth {truth}")
        atol, same_atol = INSERT_POSE_ATOL[name]
        _check(kf_err <= atol, f"{name}: poses differ from the CPU by {kf_err}")
        _check(same_gap[name] <= same_atol,
               f"{name}: poses differ from the CPU on the same inputs by {same_gap[name]}")

    # -- 11. insertion timing at the bench's inputs -------------------------
    bmap = entry.map_from_numpy(entry.bench_map(kcfg, entry.KITTI_N_KF, entry.KITTI_N_PT), dev)
    bbm = build_observer_bitmap(bmap)
    brng = np.random.default_rng(0)  # bench.py's mk_args(0)
    bl = torch.tensor(brng.uniform(0, 255, (kcam.height, kcam.width)), dtype=torch.float32)
    br = torch.tensor(brng.uniform(0, 255, (kcam.height, kcam.width)), dtype=torch.float32)
    bfeat = torch.tensor(brng.integers(-1, 40000, kcfg.n_features), dtype=torch.int32).to(dev)
    bframe = build_frame_stereo(bl.to(dev), br.to(dev), 0.0, kcam, **kw)
    bcd = kcfg.th_depth * kcam.baseline
    eye = torch.eye(4, device=dev)
    insert_ms = {}
    grows = {name: (lambda rebuild=rebuild: entry.grow_map_step(
        bmap, bbm, bframe, eye, bfeat, 0.0, 99, bcd, rebuild))
        for name, rebuild in (("full", True), ("light", False))}
    for grow in grows.values():
        for _ in range(3):
            grow()
    # full and light in turns, so that the host's load falls on both alike
    times = {name: ([], []) for name in grows}
    for _ in range(20):
        for name, grow in grows.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            grow()
            end.record()
            end.synchronize()
            times[name][1].append((time.perf_counter() - t0) * 1e3)
            times[name][0].append(start.elapsed_time(end))
    for name, (ev, wall) in times.items():
        insert_ms[name] = (statistics.median(ev), statistics.median(wall))
        print(f"[11] {name} insert: {insert_ms[name][0]:.3f} ms on CUDA events, "
              f"{insert_ms[name][1]:.3f} ms host wall ({card})")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "runs", "kitti00_full", "summary.json")) as f:
        summary = json.load(f)
    kf_every = summary["frames"] / summary["keyframes"]
    R = kcfg.bm_rebuild_every
    amortized = {
        i: step_ms["track_frame_step"][i]
        + (insert_ms["full"][i] + (R - 1) * insert_ms["light"][i]) / R / kf_every
        for i in (0, 1)
    }
    print(f"[11] amortized KITTI: {amortized[0]:.3f} ms/frame on CUDA events, "
          f"{amortized[1]:.3f} ms/frame host wall (track_frame_step + (full + "
          f"{R - 1} light) / {R} / {kf_every:.4f}; {card})")
    run_s = time.perf_counter() - t_run
    print(f"[11] phases 1-11 took {run_s:.1f} s, the kernels' build included")

    kernels = []
    for name, source, replaces, err in (
        ("patch_gather", "orb_slam2_test_tpu_torch/csrc/patches.cu",
         "orb_slam2_test_tpu/ops/patches.py:61", patch_err),
        ("pose_opt", "orb_slam2_test_tpu_torch/csrc/pose_opt.cu",
         "orb_slam2_test_tpu/solvers/pose_opt_pallas.py:107", pose_err),
    ):
        t = times_k[name]
        # `launches` and `ms` are the line's standard keys; the same
        # numbers also stand under the names this port's PERF.md reads,
        # `launches_per_frame` and `kernel_ms` (see "aliases")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": k_launches[name], "launches_per_frame": k_launches[name],
            "max_abs_err": err, "ms": t["kernel_ms"], **t,
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "timed_on": units[name],
        })
    print(json.dumps({
        "kernels": kernels,
        "aliases": {"launches_per_frame": "launches: the KITTI stereo frame's count",
                    "kernel_ms": "ms: the kernel alone"},
        "launches_by_path": {"mono_tracking_step": launches,
                             "kitti_stereo": k_launches, "rgbd": r_launches,
                             "kitti_insert_sequence": ins_launches},
        "tracking_step_ms": step_ms_mono,
        "tracking_step_wall_ms": step_wall_ms,
        "kitti_stereo_ms": {k: v[0] for k, v in step_ms.items()},
        "kitti_stereo_wall_ms": {k: v[1] for k, v in step_ms.items()},
        "kf_insert_ms": {k: v[0] for k, v in insert_ms.items()},
        "kf_insert_wall_ms": {k: v[1] for k, v in insert_ms.items()},
        "kitti_amortized_ms_per_frame": amortized[0],
        "kitti_amortized_wall_ms_per_frame": amortized[1],
        "kf_every": kf_every,
        "light_insert_pose_spread_per_1e-6_m": spread,
        "insert_pose_gap_vs_cpu_same_inputs": same_gap,
        "light_insert_repeat_gap": repeat_gap,
        "run_s": run_s,
    }))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
