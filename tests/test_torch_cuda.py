"""The port's CUDA kernels against their plain versions, on a card.

Every test here but one needs a CUDA card and skips without one; the
exception checks that asking for the card where none is visible raises
(in a subprocess with CUDA_VISIBLE_DEVICES empty), and runs anywhere.
The file imports no JAX and uses no fixture of conftest.py, so it also
runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

Kernel 1 is a copy, held bit-exact: per image, over all 8 levels of an
image in one launch at mono (640x480) and KITTI (1241x376) sizes, and
on the stereo SAD coordinates of a KITTI frame (both sides, 16 images
in one launch; right candidates scaled to the left keypoint's level,
some clipped at the border). Kernel 2 sums in another order than the
plain PyTorch loop, held to pose atol 1e-4, inlier agreement > 0.99 and
chi2 rtol 1e-3, with n_inliers equal to the count of its inliers, at O
from 7 (one warp) to 60,000, above what its cluster stages on chip
(8 CTAs x (256 in registers + 6,144 in shared memory) = 51,200), half
of them stereo rows. `_track_frame_device` on the card
is held to the port on the CPU on the same frame: poses atol 1e-4,
counts within 1%, links equal on >= 99% of the features. Five frames
of `entry.kitti_sequence` through `System` on the card: 3 kernel-1
launches on the initializing frame, 3 + 2 on every tracked one.
Place recognition: `transform` on the packaged L6 vocabulary equals the
CPU's words and nodes, and adaptive PnP RANSAC at 25% inliers on the
card equals the CPU's on the same recorded samples (pose atol 1e-3,
inliers >= 99%), though the SVD signs differ.
Loop correction: `_correct_loop_device` and one global BA chunk on
`entry.synthetic_loop_map` on the card against the CPU port from the
same inputs (poses atol 1e-3 and 5e-3 after the chunk, links >= 99%
equal, points within 1e-2 on >= 99%), both again under
set_sync_debug_mode("error").
The distributed BA (parallel/dist_ba.py) on the card against the CPU
port at 1 and 4 shards (poses atol 1e-3), with 15 collectives per LM
iteration and no host sync; a 1-rank NCCL group equal to the
one-process form under deterministic index adds.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.ops import patches
from orb_slam2_test_tpu_torch.ops.extractor import level_feature_budget
from orb_slam2_test_tpu_torch.ops.pyramid import build_pyramid
from orb_slam2_test_tpu_torch.solvers import pose_opt, pose_opt_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _level_keypoints(rng, pyr, budgets, dev):
    """Per level n_l keypoints spread past the borders (so some windows
    clip), a quarter of them half-way between pixels (round to even)."""
    out = []
    for level_img, n_l in zip(pyr, budgets):
        h, w = level_img.shape
        xy = np.stack([rng.uniform(-5, w + 5, n_l), rng.uniform(-5, h + 5, n_l)], 1)
        xy[: n_l // 4] = np.round(xy[: n_l // 4]) + 0.5
        out.append(torch.from_numpy(xy.astype(np.float32)).to(dev))
    return out


def test_patch_gather_matches_plain_on_all_levels(dev):
    rng = np.random.default_rng(0)
    img = torch.from_numpy(entry.texture_image(rng, 480, 640)).to(dev).float()
    pyr = build_pyramid(img, 8, 1.2)
    budgets = level_feature_budget(1000, 8, 1.2)
    for level_img, xy in zip(pyr, _level_keypoints(rng, pyr, budgets, dev)):
        before = patches.PATCH_GATHER.launches
        got = patches.extract_raw_patches(level_img, xy)
        assert patches.PATCH_GATHER.launches == before + 1
        ref = patches.extract_raw_patches_plain(level_img, xy)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("h,w,n_features", [(480, 640, 1000), (376, 1241, 2000)])
def test_patch_gather_all_levels_in_one_launch(dev, h, w, n_features):
    rng = np.random.default_rng(1)
    img = torch.from_numpy(entry.texture_image(rng, h, w)).to(dev).float()
    pyr = build_pyramid(img, 8, 1.2)
    budgets = level_feature_budget(n_features, 8, 1.2)
    xy = torch.cat(_level_keypoints(rng, pyr, budgets, dev))
    before = patches.PATCH_GATHER.launches
    got = patches.extract_raw_patches_levels(pyr, xy, budgets)
    assert patches.PATCH_GATHER.launches == before + 1
    assert got.shape == (n_features, 38, 38)
    assert torch.equal(got, patches.extract_raw_patches_levels_plain(pyr, xy, budgets))


def test_patch_gather_rejects_what_it_does_not_take(dev):
    img = torch.zeros((64, 64), device=dev)
    xy = torch.full((3, 2), 32.0, device=dev)
    with pytest.raises(ValueError):
        patches.extract_raw_patches_cuda(img.double(), xy)
    with pytest.raises(ValueError):
        patches.extract_raw_patches_cuda(img, xy.cpu())
    with pytest.raises(ValueError):
        patches.extract_raw_patches_cuda(img[:, :37], xy)
    with pytest.raises(ValueError):  # 33 images
        patches.extract_raw_patches_levels_cuda([img] * 33, xy, [3] + [0] * 32)
    with pytest.raises(ValueError):  # an image on the CPU
        patches.extract_raw_patches_levels_cuda([img, img.cpu()], xy, [1, 2])
    with pytest.raises(ValueError):  # counts that do not sum to N
        patches.extract_raw_patches_levels_cuda([img, img], xy, [1, 1])
    with pytest.raises(ValueError):  # a non-contiguous image
        patches.extract_raw_patches_levels_cuda([img.t()], xy, [3])


def _pose_args(dev, O, seed):
    cam, T_true, T0, X, obs = entry.pose_problem(np.random.default_rng(seed), O)
    valid = torch.ones(O, dtype=torch.bool, device=dev)
    valid[::7] = False
    return T_true, (cam, torch.from_numpy(T0).to(dev), torch.from_numpy(X).to(dev),
                    torch.from_numpy(obs).to(dev), torch.ones(O, device=dev), valid)


@pytest.mark.parametrize("O", [7, 300, 1000, 2000, 2500, 10000, 60000])
def test_pose_opt_matches_plain(dev, O):
    T_true, args = _pose_args(dev, O, 1)
    assert (args[3][:, 2] >= 0).float().mean() > 0.4  # about half stereo rows
    before = pose_opt_cuda.POSE_OPT.launches
    got = pose_opt.pose_optimization(*args)
    assert pose_opt_cuda.POSE_OPT.launches == before + 1
    ref = pose_opt._pose_optimization_plain(*args)
    torch.testing.assert_close(got.Tcw, ref.Tcw, atol=1e-4, rtol=0)
    assert (got.inliers == ref.inliers).float().mean() > 0.99
    torch.testing.assert_close(got.chi2, ref.chi2, rtol=1e-3, atol=1e-3)
    assert got.inliers.dtype == torch.bool and got.n_inliers.dtype == torch.int32
    assert int(got.n_inliers) == int(got.inliers.sum())
    assert not bool((got.inliers & ~args[5]).any())  # inliers are valid
    if O >= 300:
        assert np.abs(got.Tcw.cpu().numpy() - T_true).max() < 5e-3


def test_pose_opt_rejects_what_it_does_not_take(dev):
    cam, _, T0, X, obs = entry.pose_problem(np.random.default_rng(2), 10)
    T0 = torch.from_numpy(T0)
    args = [cam, T0.to(dev), torch.from_numpy(X).to(dev),
            torch.from_numpy(obs).to(dev), torch.ones(10, device=dev),
            torch.ones(10, dtype=torch.bool, device=dev)]
    for i, bad in [(1, args[1].double()), (1, args[1].t()),
                   (2, args[2].double()), (3, args[3][:, :2]),
                   (4, args[4].cpu()), (5, args[5].float()), (5, args[5][:9]),
                   (2, args[2].t().contiguous().t())]:
        broken = list(args)
        broken[i] = bad
        with pytest.raises(ValueError):
            pose_opt_cuda.pose_optimization_cuda(*broken)


def test_tracking_step_launches_each_kernel(dev):
    img, scene, T_true, T_pred = entry.example_scene(np.random.default_rng(3), dev)
    state = entry.state_from_numpy(img, *scene, T_pred, device=dev)
    patches.PATCH_GATHER.launches = 0
    pose_opt_cuda.POSE_OPT.launches = 0
    Tcw, n_inl = entry.tracking_step(*state)
    torch.cuda.synchronize()
    assert patches.PATCH_GATHER.launches == 1
    assert pose_opt_cuda.POSE_OPT.launches == 1
    assert np.abs(Tcw.cpu().numpy() - T_true)[:3, 3].max() < 1e-2
    assert int(n_inl) >= 0.8 * scene[2].sum()


def test_pose_opt_with_stereo_rows_at_kitti_width(dev):
    cam, T_true, T0, X, obs = entry.pose_problem(
        np.random.default_rng(5), 2000, stereo_frac=0.5
    )
    args = (cam, torch.from_numpy(T0).to(dev), torch.from_numpy(X).to(dev),
            torch.from_numpy(obs).to(dev), torch.ones(2000, device=dev),
            torch.ones(2000, dtype=torch.bool, device=dev))
    assert 900 < (obs[:, 2] >= 0).sum() <= 1000  # about half stereo rows
    got = pose_opt.pose_optimization(*args)
    ref = pose_opt._pose_optimization_plain(*args)
    torch.testing.assert_close(got.Tcw, ref.Tcw, atol=1e-4, rtol=0)
    assert (got.inliers == ref.inliers).float().mean() > 0.99
    torch.testing.assert_close(got.chi2, ref.chi2, rtol=1e-3, atol=1e-3)
    assert int(got.n_inliers) == int(got.inliers.sum())


def _kitti_small(dev, seed):
    """A stereo KITTI-geometry scene with a reduced map (K = 48,
    P = 16384), built on the card."""
    import dataclasses

    cfg = dataclasses.replace(entry.KITTI_CFG, max_keyframes=48, max_points=16384)
    return cfg, entry.kitti_scene(np.random.default_rng(seed), dev, cfg, 40, 12000)


def test_patch_gather_on_stereo_sad_coordinates(dev):
    from orb_slam2_test_tpu_torch.engine.frame import build_frame_stereo
    from orb_slam2_test_tpu_torch.ops import stereo
    from orb_slam2_test_tpu_torch.ops.extractor import extract_orb

    cfg, scene = _kitti_small(dev, 4)
    cam = entry.KITTI_CAM
    kw = dict(n_features=cfg.n_features, n_levels=cfg.n_levels,
              scale_factor=cfg.scale_factor)
    left = torch.from_numpy(scene.img_a).to(dev).float()
    right = torch.from_numpy(scene.img_b).to(dev).float()
    lp, rp = build_pyramid(left, 8, 1.2), build_pyramid(right, 8, 1.2)
    fl = extract_orb(left, pyramid=lp, **kw)
    fr = extract_orb(right, pyramid=rp, **kw)
    _, j = stereo.associate(fl, fr, float(cam.width), 8, 1.2)
    sc = stereo.sad_coordinates(fl, fr, j, **kw)
    images = [lp[l] for l in sc.levels] + [rp[l] for l in sc.levels]
    xy = torch.cat([sc.xy_l, sc.xy_r])
    got = patches.extract_raw_patches_levels(images, xy, sc.counts * 2)
    assert torch.equal(got, patches.extract_raw_patches_levels_plain(images, xy, sc.counts * 2))
    x0 = torch.round(sc.xy_r[:, 0]) - 19
    widths = torch.tensor([rp[l].shape[1] for l, n in zip(sc.levels, sc.counts)
                           for _ in range(n)], device=dev)
    assert int(((x0 < 0) | (x0 > widths - 38)).sum()) > 0  # clipped windows too

    patches.PATCH_GATHER.launches = 0
    build_frame_stereo(left, right, 0.0, cam, **kw)
    assert patches.PATCH_GATHER.launches == 3  # left ORB, right ORB, SAD


def test_track_frame_device_matches_cpu(dev):
    from orb_slam2_test_tpu_torch.engine import tracking

    cfg, scene = _kitti_small(dev, 6)
    cam = entry.KITTI_CAM
    outs = {}
    for where in (dev, "cpu"):
        a = entry.scene_inputs(scene, where)
        patches.PATCH_GATHER.launches = 0
        pose_opt_cuda.POSE_OPT.launches = 0
        outs[str(where)] = [x.cpu() for x in tracking._track_frame_device(
            cam, cfg, a[0], a[1], a[8], *a[5:])]
        launches = (patches.PATCH_GATHER.launches, pose_opt_cuda.POSE_OPT.launches)
        assert launches == ((0, 2) if where == dev else (0, 0))
    card, cpu = outs[str(dev)], outs["cpu"]
    for i in (2, 5, 9, 12):  # poses
        torch.testing.assert_close(card[i], cpu[i], atol=1e-4, rtol=0)
    for i in (0, 1, 6, 14):  # counts
        assert abs(int(card[i]) - int(cpu[i])) <= 0.01 * int(cpu[i])
    for i in (7, 13):  # links
        assert (card[i] == cpu[i]).float().mean() >= 0.99
    assert int(card[4]) == int(cpu[4]) == 0
    assert np.abs(card[5].numpy() - scene.T_true)[:3, 3].max() < 1e-2


def test_kitti_sequence_through_system_launches_each_kernel(dev):
    seq = entry.kitti_sequence(np.random.default_rng(7), 5, dev)
    system = entry.kitti_system(dev)
    launches = []
    for frame in seq.frames:
        patches.PATCH_GATHER.launches = 0
        pose_opt_cuda.POSE_OPT.launches = 0
        entry.sequence_step(system, frame)
        launches.append((patches.PATCH_GATHER.launches, pose_opt_cuda.POSE_OPT.launches))
    system.shutdown()
    assert launches == [(3, 0)] + [(3, 2)] * 4
    tr = system.tracker
    assert tr.state == "OK" and tr.stats["lost_frames"] == 0 and tr.stats["n_kf"] >= 2
    for i, (_, T) in enumerate(tr.export_trajectory()):
        assert np.abs(T - seq.T_true[i])[:3, 3].max() < 2e-2, i


def test_transform_matches_cpu_on_the_default_vocabulary(dev):
    from orb_slam2_test_tpu_torch.bow.vocabulary import default_vocabulary, transform

    voc = default_vocabulary()
    rng = np.random.default_rng(3)
    desc = torch.from_numpy(rng.integers(0, 2**32, (2000, 8), dtype=np.uint32).view(np.int32))
    valid = torch.from_numpy(rng.uniform(size=2000) < 0.95)
    w_card, n_card = transform(voc, desc.to(dev), valid.to(dev))
    w_cpu, n_cpu = transform(voc, desc, valid)
    assert torch.equal(w_card.cpu(), w_cpu) and torch.equal(n_card.cpu(), n_cpu)
    assert (w_cpu[valid] >= 0).all() and (w_cpu[~valid] == -1).all()


def test_pnp_on_the_card_matches_cpu_with_the_same_samples(dev):
    """At 25% inliers: the card's SVD signs differ from LAPACK's, the
    sign-free extraction makes the same samples give the same pose."""
    from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_test_tpu_torch.solvers import pnp
    from orb_slam2_test_tpu_torch.solvers.initializer import sample_indices

    cam = PinholeCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
    rng = np.random.default_rng(0)
    t_true = np.array([0.3, -0.1, 0.5])
    X_in = rng.uniform([-2, -2, 4], [2, 2, 10], (40, 3))
    pc = X_in + t_true
    uv_in = 500.0 * pc[:, :2] / pc[:, 2:] + [320.0, 240.0] + rng.normal(0, 0.3, (40, 2))
    X = np.concatenate([X_in, rng.uniform([-2, -2, 4], [2, 2, 10], (120, 3))])
    uv = np.concatenate([uv_in, rng.uniform([0, 0], [640, 480], (120, 2))])
    X, uv = (torch.from_numpy(a.astype(np.float32)) for a in (X, uv))
    valid = torch.ones(160, dtype=torch.bool)
    gen = torch.Generator().manual_seed(0)
    log = []

    def record(v, n):
        log.append(sample_indices(v, n, pnp.SAMPLE, gen).cpu())
        return log[-1].to(v.device)

    card, s_card = pnp.pnp_ransac_adaptive(cam, X.to(dev), uv.to(dev), valid.to(dev), record,
                                           batch=512, max_hypotheses=32768)
    replay = iter(log)
    cpu, s_cpu = pnp.pnp_ransac_adaptive(cam, X, uv, valid, lambda v, n: next(replay),
                                         batch=512, max_hypotheses=32768)
    assert bool(card.success) and bool(cpu.success) and s_card.rounds == s_cpu.rounds
    assert np.abs(card.Tcw.cpu().numpy() - cpu.Tcw.numpy()).max() < 1e-3
    assert (card.inliers.cpu() == cpu.inliers).float().mean() >= 0.99
    assert np.linalg.norm(card.Tcw.cpu().numpy()[:3, 3] - t_true) < 0.05


def test_system_on_cuda_raises_without_a_card():
    code = (
        "from orb_slam2_test_tpu_torch.io.settings import SlamSettings\n"
        "from orb_slam2_test_tpu_torch.system import System\n"
        "try:\n"
        "    System(SlamSettings(), 'monocular', device='cuda')\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised:") and "CUDA card" in out.stdout


def test_loop_correction_on_the_card_matches_cpu(dev):
    from orb_slam2_test_tpu_torch.engine import loop_closing as lc
    from orb_slam2_test_tpu_torch.solvers import ba_core
    from orb_slam2_test_tpu_torch.utils.precision import f32_matmuls

    f32_matmuls()
    m_np, T_true = entry.synthetic_loop_map()
    cam = entry.LOOP_MAP_CAM
    S12 = torch.from_numpy((T_true[21] @ np.linalg.inv(T_true[1])).astype(np.float32))
    kf, cand = torch.tensor(21), torch.tensor(1)
    out = {}
    for d in (dev, torch.device("cpu")):
        m = entry.map_from_numpy(m_np, d)
        # the inputs go to the device before the sync check: a copy from
        # the host synchronizes
        kf_d, cand_d, S12_d = kf.to(d), cand.to(d), S12.to(d)
        corrected = lc._correct_loop_device(cam, m, kf_d, cand_d, S12_d, True)
        prob = lc.LoopCloser._build_gba_prob(corrected)
        lam = torch.full((), 1e-4, device=d)
        cost0 = ba_core._robust_cost(prob, cam)
        chunk = ba_core.bundle_adjust_partial(prob, cam, lam, cost0,
                                              torch.ones_like(prob.obs_valid), iters=4)
        out[d.type] = (entry.map_to_numpy(corrected), chunk[0].cam_Tcw.cpu(),
                       chunk[0].pt_xyz.cpu())
        if d.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                again = lc._correct_loop_device(cam, m, kf_d, cand_d, S12_d, True)
                ba_core.bundle_adjust_partial(prob, cam, lam, cost0,
                                              torch.ones_like(prob.obs_valid), iters=4)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            # the pose graph's sums run in a fixed order: the same inputs
            # give the same poses on every run
            torch.testing.assert_close(again.kf_Tcw, corrected.kf_Tcw, rtol=0, atol=0)
    A, B = out["cuda"][0], out["cpu"][0]
    live = A["kf_valid"]
    pose_gap = np.abs(A["kf_Tcw"][live] - B["kf_Tcw"][live]).max()
    links = (A["kf_pt_idx"][live] == B["kf_pt_idx"][live]).mean()
    pv = A["pt_valid"]
    pt_share = (np.abs(A["pt_xyz"][pv] - B["pt_xyz"][pv]).max(-1) <= 1e-2).mean()
    chunk_gap = float((out["cuda"][1] - out["cpu"][1]).abs().max())
    chunk_pts = float(((out["cuda"][2] - out["cpu"][2]).abs().max(-1).values <= 1e-2)
                      .float().mean())
    print(f"correction: poses {pose_gap:.2e}, links {links:.4f}, points {pt_share:.4f}; "
          f"chunk: poses {chunk_gap:.2e}, points {chunk_pts:.4f}")
    assert pose_gap <= 1e-3 and links >= 0.99 and pt_share >= 0.99
    np.testing.assert_array_equal(A["kf_loop_edge"], B["kf_loop_edge"])
    # the chunk's bound is chip_smoke.py's GBA_POSE_ATOL
    assert chunk_gap <= 5e-3 and chunk_pts >= 0.99


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_dist_bundle_adjust_on_the_card_matches_cpu(dev):
    """The distributed BA on the KITTI-shaped synthetic problem, 1 and 4
    shards in one process, on the card against the CPU port (poses atol
    1e-3: float32 index adds in another order on each device), 15
    collectives per LM iteration, and no host sync."""
    from orb_slam2_test_tpu_torch.parallel import dist_ba
    from orb_slam2_test_tpu_torch.utils.precision import f32_matmuls
    from orb_slam2_test_tpu_torch.utils.synthetic import synthetic_ba_problem

    f32_matmuls()
    out = {}
    for d in (dev, torch.device("cpu")):
        prob, cam = synthetic_ba_problem(64, 4000, 5, seed=3, device=d)
        for n in (1, 4):
            sprob = dist_ba.shard_problem(prob, n)
            mesh = dist_ba.make_ba_mesh(n, d)
            dist_ba.PSUM.calls = 0
            out[d.type, n] = [x.cpu() for x in dist_ba.dist_bundle_adjust(sprob, cam, mesh,
                                                                          iters=4)]
            assert dist_ba.PSUM.calls == 4 * 15
            if d.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    dist_ba.dist_bundle_adjust(sprob, cam, mesh, iters=4)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
    for n in (1, 4):
        gap = float((out["cuda", n][0] - out["cpu", n][0]).abs().max())
        print(f"{n} shards: card vs CPU poses {gap:.2e}")
        assert gap <= 1e-3
        np.testing.assert_allclose(float(out["cuda", n][2]), float(out["cpu", n][2]), rtol=1e-3)


def test_nccl_one_rank_matches_one_process(dev):
    """A 1-rank NCCL group against the one-process form: equal, with
    deterministic index adds on both sides (the all-reduce of one rank
    returns its input)."""
    import torch.distributed as dist

    from orb_slam2_test_tpu_torch.parallel import dist_ba, multihost
    from orb_slam2_test_tpu_torch.utils.synthetic import synthetic_ba_problem

    prob, cam = synthetic_ba_problem(32, 2000, 5, seed=4, device=dev)
    sprob = dist_ba.shard_problem(prob, 1)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        one = dist_ba.dist_bundle_adjust(sprob, cam, dist_ba.make_ba_mesh(1, dev), iters=4)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)
        try:
            mesh = multihost.global_ba_mesh(dev)
            assert mesh.distributed and mesh.size == 1
            got = dist_ba.dist_bundle_adjust(multihost.make_global_problem(sprob, mesh), cam,
                                             mesh, iters=4)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(got, one):
        assert torch.equal(a, b)
