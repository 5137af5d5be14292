"""The batched callers of the port's two kernels, on the CPU.

Kernel 1 now takes up to 32 images per launch; its plain version does
the same segment by segment. Held here, with the JAX package as the
reference:
- `extract_raw_patches_levels_plain` on an 8-level pyramid, keypoints
  half-way between pixels and clipped at every border: exactly the
  concatenated per-level JAX `extract_raw_patches(..., interpret=True)`
  (a copy, so bit-equal);
- the image table the kernel receives (`pack_levels`): pointers, sizes
  and segment offsets; and what the wrapper refuses (more than 32
  images, images on another device, no image, non-contiguous inputs,
  counts that do not cover xy);
- `extract_orb`, now one gather and one ORB pass over all levels, and
  `stereo_match`, now one gather and one SAD pass over all slots (at
  8 and at 9 levels both sides fit one launch): the
  tolerances of tests/test_torch_frontend.py and test_torch_stereo.py
  (keypoints equal, angles 2e-4, at most 2 flipped bits; stereo sets
  within 1%, ur 1e-3 px on 99%, depth rtol 1e-4);
- the SAD coordinates: bit-equal to the per-level products they
  replace (the kernel's bit-exactness on the card depends on it);
- the entry points default to the card and build on the CPU when asked.
"""

import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.ops import extractor as jext
from orb_slam2_test_tpu.ops import patches as jpatches
from orb_slam2_test_tpu.ops import pyramid as jpyr
from orb_slam2_test_tpu.ops import stereo as jstereo
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.engine import tracking as ttracking
from orb_slam2_test_tpu_torch.ops import extractor as text
from orb_slam2_test_tpu_torch.ops import patches as tpatches
from orb_slam2_test_tpu_torch.ops import stereo as tstereo

torch.set_num_threads(2)

W, H, BF = 320, 240, 260.0 * 0.54  # the small stereo camera of test_torch_stereo.py
ENTRY_POINTS = ("state_from_numpy", "example_scene", "map_from_numpy",
                "frame_from_numpy", "tracking_scene", "insert_scene",
                "kitti_insert_scene", "kitti_scene", "scene_inputs")


def _flipped_bits(a, b):
    a = np.asarray(a).view(np.uint32)
    b = np.asarray(b).view(np.uint32)
    return np.unpackbits((a ^ b).view(np.uint8), axis=-1).sum(axis=-1)


def _pyramid_keypoints(rng, shapes, n_per_level):
    """Per level n keypoints: inside, half-way between pixels (rounding
    to even), and beyond every border (clipped windows)."""
    out = []
    for h, w in shapes:
        xy = np.stack([rng.uniform(-6, w + 6, n_per_level),
                       rng.uniform(-6, h + 6, n_per_level)], 1)
        xy[:3] = np.round(xy[:3]) + 0.5
        xy[3:7] = [[-4.0, 5.0], [w + 3.0, 7.0], [9.0, -2.5], [w / 2, h + 0.5]]
        out.append(xy.astype(np.float32))
    return out


def test_levels_plain_equals_jax_per_level(rng):
    img = rng.uniform(0, 255, (240, 320)).astype(np.float32)
    jp = jpyr.build_pyramid(jnp.asarray(img), 8, 1.2)
    pyr = [np.array(p) for p in jp]
    xys = _pyramid_keypoints(rng, [p.shape for p in pyr], 12)
    want = np.concatenate([
        np.asarray(jpatches.extract_raw_patches(jnp.asarray(p), jnp.asarray(xy),
                                                interpret=True))
        for p, xy in zip(pyr, xys)
    ])
    got = tpatches.extract_raw_patches_levels(
        [torch.from_numpy(p) for p in pyr], torch.from_numpy(np.concatenate(xys)),
        [len(xy) for xy in xys])
    assert got.shape == (8 * 12, 38, 38)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pack_levels_table():
    images = [torch.zeros((40 + i, 50 + 2 * i)) for i in range(5)]
    counts = [3, 0, 7, 1, 4]
    lv = tpatches.pack_levels(images, counts)
    assert lv.n_img == 5
    assert list(lv.seg) == [0, 3, 3, 10, 11] + [15] * (tpatches.MAX_IMAGES + 1 - 5)
    for i, img in enumerate(images):
        assert lv.img[i] == img.data_ptr()
        assert (lv.h[i], lv.w[i]) == tuple(img.shape)
    assert all(lv.img[i] is None for i in range(5, tpatches.MAX_IMAGES))
    # the table's C layout: 32 pointers, 32 + 32 ints, 33 offsets, n_img
    assert tpatches.PatchLevels.seg.offset == 8 * 32 + 4 * 64
    assert tpatches.PatchLevels.n_img.offset == 8 * 32 + 4 * 97


def test_levels_gather_rejects_what_it_does_not_take():
    img = torch.zeros((64, 64))
    xy = torch.full((3, 2), 32.0)
    fn = tpatches.extract_raw_patches_levels
    bad = [
        ([img] * 33, xy, [3] + [0] * 32),  # more than 32 images
        ([], xy, []),  # no image
        ([img, torch.zeros((64, 64), device="meta")], xy, [1, 2]),  # another device
        ([img.t()], xy, [3]),  # a non-contiguous image
        ([img], torch.full((2, 3), 32.0)[:, :2], [3]),  # non-contiguous xy
        ([img], xy, [2]),  # counts short of N
        ([img, img], xy, [3]),  # one count for two images
        ([img], xy.double(), [3]),
        ([img[:37]], xy, [3]),  # smaller than a window
    ]
    for images, x, counts in bad:
        with pytest.raises(ValueError):
            fn(images, x, counts)
    with pytest.raises(ValueError, match="CUDA"):
        tpatches.extract_raw_patches_levels_cuda([img], xy, [3])
    assert tpatches.PATCH_GATHER.launches == 0


def test_batched_extract_orb_matches_jax(rng):
    # a noise image, as in test_torch_frontend.py (on the seeded texture
    # both the batched and the per-level form reach 2.3e-4 rad at level >= 1)
    img = rng.integers(0, 256, (H, W)).astype(np.uint8)
    j = jext.extract_orb(jnp.asarray(img, jnp.float32), n_features=500)
    t = text.extract_orb(torch.from_numpy(img).float(), n_features=500)
    for field in ("uv", "level", "valid"):
        np.testing.assert_array_equal(
            getattr(t, field).numpy(), np.asarray(getattr(j, field)), err_msg=field)
    level = t.level.numpy()
    err = np.abs(t.angle.numpy() - np.asarray(j.angle))
    assert err[level == 0].max() <= 1e-5 and err.max() <= 2e-4
    assert _flipped_bits(t.desc.numpy(), j.desc).max() <= 2


@pytest.mark.parametrize("n_levels", [8, 9])
def test_batched_stereo_match_matches_jax(rng, n_levels):
    left = entry.texture_image(rng, H, W)
    right = np.ascontiguousarray(left[:, np.minimum(np.arange(W) + 7, W - 1)])
    kw = dict(n_features=300, n_levels=n_levels)
    jl = jext.extract_orb(jnp.asarray(left, jnp.float32), **kw)
    jr = jext.extract_orb(jnp.asarray(right, jnp.float32), **kw)
    lp = [np.array(p) for p in jpyr.build_pyramid(jnp.asarray(left, jnp.float32),
                                                  n_levels, 1.2)]
    rp = [np.array(p) for p in jpyr.build_pyramid(jnp.asarray(right, jnp.float32),
                                                  n_levels, 1.2)]
    j_ur, j_depth = jstereo.stereo_match(jl, jr, tuple(map(jnp.asarray, lp)),
                                         tuple(map(jnp.asarray, rp)), BF, 300,
                                         n_levels=n_levels)

    def feats(f):
        arrs = [np.array(x) for x in f]
        arrs[4] = arrs[4].view(np.int32)
        return text.Features(*[torch.from_numpy(a) for a in arrs])

    t_ur, t_depth = tstereo.stereo_match(
        feats(jl), feats(jr), [torch.from_numpy(p) for p in lp],
        [torch.from_numpy(p) for p in rp], BF, 300, n_levels=n_levels)
    j_ur, t_ur = np.asarray(j_ur), t_ur.numpy()
    jv, tv = j_ur >= 0, t_ur >= 0
    assert (jv ^ tv).sum() <= 0.01 * j_ur.size
    both = jv & tv
    assert both.sum() > 0.3 * j_ur.size
    assert (np.abs(j_ur - t_ur)[both] <= 1e-3).mean() >= 0.99
    np.testing.assert_allclose(t_depth.numpy()[both], np.asarray(j_depth)[both], rtol=1e-4)


def test_sad_coordinates_equal_the_per_level_products(rng):
    n = 300
    budgets = text.level_feature_budget(n, 8, 1.2)
    level = np.repeat(np.arange(8), budgets).astype(np.int32)
    uv = rng.uniform(0, 320, (n, 2)).astype(np.float32)
    f = text.Features(torch.from_numpy(uv), torch.from_numpy(level),
                      torch.zeros(n), torch.zeros(n), torch.zeros((n, 8), dtype=torch.int32),
                      torch.ones(n, dtype=torch.bool))
    j = torch.from_numpy(rng.permutation(n))
    sc = tstereo.sad_coordinates(f, f, j, n, 8, 1.2)
    assert sc.levels == list(range(8)) and sc.counts == budgets
    start = 0
    for l, n_l in zip(sc.levels, sc.counts):
        inv_s = 1.0 / float(1.2**l)
        sl = slice(start, start + n_l)
        assert torch.equal(sc.xy_l[sl], f.uv[sl] * inv_s)
        assert torch.equal(sc.xy_r[sl], f.uv[j[sl]] * inv_s)
        assert torch.equal(sc.inv_s[sl], torch.full((n_l,), inv_s))
        start += n_l


def test_entry_points_default_to_the_card():
    for name in ENTRY_POINTS:
        assert inspect.signature(getattr(entry, name)).parameters["device"].default == "cuda"
    cfg = ttracking.TrackerConfig(n_features=64, max_keyframes=8, max_points=256)
    m = entry.map_from_numpy(entry.bench_map(cfg, 4, 100), device="cpu")
    assert all(x.device.type == "cpu" for x in m)
    cam = entry.CAM._replace(width=W, height=H, cx=160.0, cy=120.0)
    scene = entry.tracking_scene(np.random.default_rng(0), "mono", cam, cfg, 4, 100,
                                 device="cpu")
    args = entry.scene_inputs(scene, "cpu")
    assert all(x.device.type == "cpu" for x in args if isinstance(x, torch.Tensor))
    assert args[8].uv.device.type == "cpu"
