"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card and skips without one. The file
imports no JAX and uses no fixture of conftest.py, so it also runs on a
machine without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

Kernel 1 is a copy, held bit-exact; kernel 2 sums in another order than
the plain PyTorch loop, held to pose atol 1e-4 and chi2 rtol 1e-3.
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


def test_patch_gather_matches_plain_on_all_levels(dev):
    rng = np.random.default_rng(0)
    img = torch.from_numpy(entry.texture_image(rng, 480, 640)).to(dev).float()
    budgets = level_feature_budget(1000, 8, 1.2)
    for level_img, n_l in zip(build_pyramid(img, 8, 1.2), budgets):
        h, w = level_img.shape
        xy = np.stack([rng.uniform(-5, w + 5, n_l), rng.uniform(-5, h + 5, n_l)], 1)
        xy[: n_l // 4] = np.round(xy[: n_l // 4]) + 0.5
        xy = torch.from_numpy(xy.astype(np.float32)).to(dev)
        before = patches.PATCH_GATHER.launches
        got = patches.extract_raw_patches(level_img, xy)
        assert patches.PATCH_GATHER.launches == before + 1
        ref = patches.extract_raw_patches_plain(level_img, xy)
        assert torch.equal(got, ref)


def test_patch_gather_rejects_what_it_does_not_take(dev):
    img = torch.zeros((64, 64), device=dev)
    xy = torch.full((3, 2), 32.0, device=dev)
    with pytest.raises(ValueError):
        patches.extract_raw_patches_cuda(img.double(), xy)
    with pytest.raises(ValueError):
        patches.extract_raw_patches_cuda(img, xy.cpu())
    with pytest.raises(ValueError):
        patches.extract_raw_patches_cuda(img[:, :37], xy)


@pytest.mark.parametrize("O", [7, 300, 1000, 2500])
def test_pose_opt_matches_plain(dev, O):
    cam, T_true, T0, X, obs = entry.pose_problem(np.random.default_rng(1), O)
    T0 = torch.from_numpy(T0)
    valid = torch.ones(O, dtype=torch.bool, device=dev)
    valid[::7] = False
    args = (cam, T0.to(dev), torch.from_numpy(X).to(dev),
            torch.from_numpy(obs).to(dev), torch.ones(O, device=dev), valid)
    before = pose_opt_cuda.POSE_OPT.launches
    got = pose_opt.pose_optimization(*args)
    assert pose_opt_cuda.POSE_OPT.launches == before + 1
    ref = pose_opt._pose_optimization_plain(*args)
    torch.testing.assert_close(got.Tcw, ref.Tcw, atol=1e-4, rtol=0)
    assert (got.inliers == ref.inliers).float().mean() > 0.99
    torch.testing.assert_close(got.chi2, ref.chi2, rtol=1e-3, atol=1e-3)
    if O >= 300:
        assert np.abs(got.Tcw.cpu().numpy() - T_true).max() < 5e-3


def test_pose_opt_rejects_what_it_does_not_take(dev):
    cam, _, T0, X, obs = entry.pose_problem(np.random.default_rng(2), 10)
    T0 = torch.from_numpy(T0)
    args = [cam, T0.to(dev), torch.from_numpy(X).to(dev),
            torch.from_numpy(obs).to(dev), torch.ones(10, device=dev),
            torch.ones(10, dtype=torch.bool, device=dev)]
    for i, bad in [(2, args[2].double()), (3, args[3][:, :2]),
                   (4, args[4].cpu()), (5, args[5].float()),
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
    assert patches.PATCH_GATHER.launches == 8
    assert pose_opt_cuda.POSE_OPT.launches == 1
    assert np.abs(Tcw.cpu().numpy() - T_true)[:3, 3].max() < 1e-2
    assert int(n_inl) >= 0.8 * scene[2].sum()
