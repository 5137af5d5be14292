"""Parity of the PyTorch port's stereo and RGB-D frames with the JAX package.

Seeded numpy inputs go through both packages. Tolerances and why:
- nanmedian: exact, the mean of the two middle values on an even count
  (torch.nanmedian returns the lower one);
- _sad_refine: exact on integer-valued patches (level 0 of a uint8
  image: every SAD is an integer sum below 2^24); on float patches
  (levels >= 1) torch and XLA sum the 121 terms in other orders, so
  best_sad rtol 1e-5 and delta atol 1e-4 on patches without near-ties;
- stereo_match and build_frame_stereo (here at 320x240, and at KITTI
  geometry in tests/test_torch_tracking.py): keypoints equal; the stereo-valid
  sets differ on at most 1% of the features (measured: equal at 320x240
  and at KITTI geometry); ur within 1e-3 px on >= 99% of the features
  valid in both (measured: all, largest gap 1.2e-4 px, from the float
  pyramid levels), depth rtol 1e-4 there;
- build_frame_rgbd: keypoints equal, the depth-valid set equal (the
  lookup and the 3x3 min/max are exact), ur rtol 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.engine import frame as jframe
from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu.ops import extractor as jext
from orb_slam2_test_tpu.ops import pyramid as jpyr
from orb_slam2_test_tpu.ops import stereo as jstereo
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.engine import frame as tframe
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera as TCam
from orb_slam2_test_tpu_torch.ops import extractor as text
from orb_slam2_test_tpu_torch.ops import stereo as tstereo

torch.set_num_threads(2)

SMALL = TCam(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240,
             bf=260.0 * 0.54)


def _jcam(cam):
    return JCam(**cam._asdict())


def _pair(rng, cam, disparity):
    """A seeded texture and its copy shifted by `disparity` pixels."""
    left = entry.texture_image(rng, cam.height, cam.width)
    cols = np.minimum(np.arange(cam.width) + disparity, cam.width - 1)
    return left, np.ascontiguousarray(left[:, cols])


def _t_features(f):
    """JAX Features -> the port's Features (descriptors as int32)."""
    arrs = [np.array(x) for x in f]
    arrs[4] = arrs[4].view(np.int32)
    return text.Features(*[torch.from_numpy(a) for a in arrs])


def _assert_stereo_close(j_ur, j_depth, t_ur, t_depth):
    j_ur, t_ur = np.asarray(j_ur), np.asarray(t_ur)
    jv, tv = j_ur >= 0, t_ur >= 0
    assert (jv ^ tv).sum() <= 0.01 * j_ur.size
    both = jv & tv
    assert both.sum() > 0.3 * j_ur.size  # the pair really has stereo
    gap = np.abs(j_ur - t_ur)[both]
    assert (gap <= 1e-3).mean() >= 0.99, gap.max()
    np.testing.assert_allclose(
        np.asarray(t_depth)[both], np.asarray(j_depth)[both], rtol=1e-4
    )


@pytest.mark.parametrize(
    "x", [[1.0, 2.0, 3.0, 4.0, np.nan], [5.0, np.nan, 1.0, 3.0],
          [2.0, 9.0, 4.0], [np.nan, np.nan], [7.0]],
)
def test_nanmedian_is_jax_nanmedian(x):
    x = np.asarray(x, np.float32)
    got = float(tstereo.nanmedian(torch.from_numpy(x)))
    want = float(jnp.nanmedian(jnp.asarray(x)))
    np.testing.assert_equal(got, want)
    if x.size == 5:  # the even-count case that torch.nanmedian gets wrong
        assert got == 2.5 and float(torch.from_numpy(x).nanmedian()) == 2.0


@pytest.mark.parametrize("integer", [True, False])
def test_sad_refine(rng, integer):
    n = 400
    base = rng.uniform(0, 255, (n, 32, 40))
    if integer:
        base = np.round(base)
    # the right patch sees the left one shifted by 0..4 px plus noise
    shift = rng.integers(-4, 5, n)
    lp = base[:, :, 4:36]
    rp = np.stack([b[:, 4 + s : 36 + s] for b, s in zip(base, shift)])
    rp = rp + (0 if integer else rng.normal(0, 2.0, rp.shape))
    lp = lp.reshape(n, -1).astype(np.float32)
    rp = rp.reshape(n, -1).astype(np.float32)
    jd, js = jstereo._sad_refine(jnp.asarray(lp), jnp.asarray(rp))
    td, ts = tstereo._sad_refine(torch.from_numpy(lp), torch.from_numpy(rp))
    if integer:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    else:
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    # the best slide undoes the shift
    assert (np.round(td.numpy()) == -shift).mean() > 0.95


def test_stereo_match_on_the_same_features(rng):
    """stereo_match alone: the JAX package's features and pyramids go to
    both sides."""
    left, right = _pair(rng, SMALL, 7)
    jl = jext.extract_orb(jnp.asarray(left, jnp.float32), n_features=300)
    jr = jext.extract_orb(jnp.asarray(right, jnp.float32), n_features=300)
    lp = tuple(jpyr.build_pyramid(jnp.asarray(left, jnp.float32), 8, 1.2))
    rp = tuple(jpyr.build_pyramid(jnp.asarray(right, jnp.float32), 8, 1.2))
    j_ur, j_depth = jstereo.stereo_match(jl, jr, lp, rp, SMALL.bf, 300)
    t_ur, t_depth = tstereo.stereo_match(
        _t_features(jl), _t_features(jr),
        [torch.from_numpy(np.array(x)) for x in lp],
        [torch.from_numpy(np.array(x)) for x in rp], SMALL.bf, 300,
    )
    _assert_stereo_close(j_ur, j_depth, t_ur.numpy(), t_depth.numpy())


def check_build_frame_stereo(cam, n_features, disparity, seed):
    """build_frame_stereo of both packages on one shifted pair; returns
    the JAX frame."""
    left, right = _pair(np.random.default_rng(seed), cam, disparity)
    j = jframe.build_frame_stereo(
        jnp.asarray(left), jnp.asarray(right), 0.0, _jcam(cam), n_features=n_features
    )
    t = tframe.build_frame_stereo(
        torch.from_numpy(left), torch.from_numpy(right), 0.0, cam,
        n_features=n_features,
    )
    for field in ("uv", "level", "valid"):
        np.testing.assert_array_equal(
            getattr(t, field).numpy(), np.asarray(getattr(j, field)), err_msg=field
        )
    _assert_stereo_close(j.ur, j.depth, t.ur.numpy(), t.depth.numpy())
    # the right image is the left shifted: the disparity is recovered
    ok = t.ur.numpy() >= 0
    disp = t.uv.numpy()[ok, 0] - t.ur.numpy()[ok]
    assert np.median(np.abs(disp - disparity)) < 0.25
    return j


def test_build_frame_stereo():
    """320x240 / 300 features; the KITTI-geometry case is in
    tests/test_torch_tracking.py, where its compiled JAX program serves
    the tracking test too."""
    check_build_frame_stereo(SMALL, 300, 7, 3)


def test_build_frame_rgbd(rng):
    cam = SMALL
    img = entry.texture_image(rng, cam.height, cam.width)
    depth = entry._depth_map(rng, cam.height, cam.width, 2.0)
    j = jframe.build_frame_rgbd(
        jnp.asarray(img), jnp.asarray(depth), 0.0, _jcam(cam), n_features=300
    )
    t = tframe.build_frame_rgbd(
        torch.from_numpy(img), torch.from_numpy(depth), 0.0, cam, n_features=300
    )
    for field in ("uv", "level", "valid"):
        np.testing.assert_array_equal(
            getattr(t, field).numpy(), np.asarray(getattr(j, field)), err_msg=field
        )
    j_ur, t_ur = np.asarray(j.ur), t.ur.numpy()
    np.testing.assert_array_equal(t_ur >= 0, j_ur >= 0)
    np.testing.assert_array_equal(t.depth.numpy(), np.asarray(j.depth))
    np.testing.assert_allclose(t_ur, j_ur, rtol=1e-5)
    # the depth-edge gate and the holes drop some keypoints, not most
    has = t.depth.numpy() > 0
    assert 0.5 * t.valid.sum() < has.sum() < t.valid.sum()
