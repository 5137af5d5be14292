"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card and skips without one. The file
imports no JAX and uses no fixture of conftest.py, so it also runs on a
machine without JAX:

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
counts within 1%, links equal on >= 99% of the features.
"""

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
