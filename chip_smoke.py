"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's per-frame tracking step (mono ORB extraction at
640x480 / 1000 features / 8 levels, projection matching of a
2048-point local map, motion-only BA) through its two hand-written
CUDA kernels, and checks each kernel and the step against their plain
PyTorch versions. Phases, each of which raises on a failed check:

1. build both kernels from orb_slam2_test_tpu_torch/csrc (nvcc, sm_90a);
2. patch_gather vs its plain version on all 8 pyramid levels: bit-exact;
3. pose_opt vs its plain version at 1000 observations: pose atol 1e-4,
   inlier agreement > 0.99, chi2 rtol 1e-3;
4. the tracking step on a scene its frame observes: 8 patch_gather
   launches and 1 pose_opt launch, translation error < 1 cm, inliers
   >= 80% of the map, the same step on the CPU within atol 1e-4 and 1%
   of the inliers, and at most 3 flipped descriptor bits between the
   card's bf16 BRIEF selection and the CPU's float32 one;
5. timing with CUDA events (median of 30 after warm-up): each kernel vs
   its plain version, and the step in ms per frame.

It imports only the port, numpy and the standard library. It needs one
CUDA card and exits non-zero, printing no result, without one. The last
line is the JSON object {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
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
    from orb_slam2_test_tpu_torch.engine.frame import build_frame_mono
    from orb_slam2_test_tpu_torch.ops import patches
    from orb_slam2_test_tpu_torch.ops.extractor import level_feature_budget
    from orb_slam2_test_tpu_torch.ops.pyramid import build_pyramid
    from orb_slam2_test_tpu_torch.solvers import pose_opt, pose_opt_cuda
    from orb_slam2_test_tpu_torch.utils import cuda_build
    from orb_slam2_test_tpu_torch.utils.precision import f32_matmuls

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
    patch_err = 0.0
    for level_img, xy in zip(pyr, level_xy):
        got = patches.extract_raw_patches_cuda(level_img, xy)
        ref = patches.extract_raw_patches_plain(level_img, xy)
        torch.cuda.synchronize()
        _check(torch.equal(got, ref), f"patch_gather != plain at {tuple(level_img.shape)}")
        patch_err = max(patch_err, float((got - ref).abs().max()))
    print(f"[2] patch_gather: bit-exact on {len(pyr)} levels, "
          f"n_l={budgets}, shapes={[tuple(p.shape) for p in pyr]}")

    # -- 3. pose_opt vs plain at O = 1000 --------------------------------
    cam_p, T_true_p, T0_p, X_p, obs_p = entry.pose_problem(rng)
    O = X_p.shape[0]
    pose_args = (
        torch.from_numpy(T0_p).float().to(dev), torch.from_numpy(X_p).to(dev),
        torch.from_numpy(obs_p).to(dev), torch.ones(O, device=dev),
        torch.ones(O, dtype=torch.bool, device=dev),
    )
    k_T, k_inl, k_chi2 = pose_opt_cuda.pose_optimization_cuda(cam_p, *pose_args)
    ref = pose_opt._pose_optimization_plain(cam_p, *pose_args)
    torch.cuda.synchronize()
    pose_err = float((k_T - ref.Tcw).abs().max())
    agree = float((k_inl == ref.inliers).float().mean())
    chi2_ok = torch.allclose(k_chi2, ref.chi2, rtol=1e-3, atol=1e-3)
    print(f"[3] pose_opt: |T - plain| = {pose_err:.3e}, inlier agreement "
          f"{agree:.4f}, |T - T_true| = {np.abs(k_T.cpu().numpy() - T_true_p).max():.3e}")
    _check(pose_err <= 1e-4, f"pose_opt Tcw differs from plain by {pose_err}")
    _check(agree > 0.99, f"pose_opt inlier agreement {agree}")
    _check(chi2_ok, "pose_opt chi2 differs from plain beyond rtol 1e-3")

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
    _check(launches == {"patch_gather": 8, "pose_opt": 1}, f"launches {launches}")
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
    def gather_all(fn):
        return lambda: [fn(p, xy) for p, xy in zip(pyr, level_xy)]

    times = {
        "patch_gather": (
            _cuda_ms(gather_all(patches.extract_raw_patches_cuda)),
            _cuda_ms(gather_all(patches.extract_raw_patches_plain)),
        ),
        "pose_opt": (
            _cuda_ms(lambda: pose_opt_cuda.pose_optimization_cuda(cam_p, *pose_args)),
            _cuda_ms(lambda: pose_opt._pose_optimization_plain(cam_p, *pose_args)),
        ),
    }
    step_ms = _cuda_ms(lambda: entry.tracking_step(*state_card))
    t0 = time.perf_counter()
    for _ in range(N_TIMED):
        entry.tracking_step(*state_card)
    torch.cuda.synchronize()
    step_wall_ms = (time.perf_counter() - t0) * 1e3 / N_TIMED
    for name, (k_ms, p_ms) in times.items():
        print(f"[5] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"(per frame's launches; {card})")
    print(f"[5] tracking_step: {step_ms:.3f} ms/frame on CUDA events, "
          f"{step_wall_ms:.3f} ms/frame host wall ({card})")

    kernels = [
        {"name": "patch_gather", "route": "cuda",
         "source": "orb_slam2_test_tpu_torch/csrc/patches.cu",
         "replaces": "orb_slam2_test_tpu/ops/patches.py:61",
         "launches": launches["patch_gather"], "max_abs_err": patch_err,
         "ms": times["patch_gather"][0], "plain_ms": times["patch_gather"][1]},
        {"name": "pose_opt", "route": "cuda",
         "source": "orb_slam2_test_tpu_torch/csrc/pose_opt.cu",
         "replaces": "orb_slam2_test_tpu/solvers/pose_opt_pallas.py:107",
         "launches": launches["pose_opt"], "max_abs_err": pose_err,
         "ms": times["pose_opt"][0], "plain_ms": times["pose_opt"][1]},
    ]
    print(json.dumps({"kernels": kernels, "tracking_step_ms": step_ms,
                      "tracking_step_wall_ms": step_wall_ms}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
