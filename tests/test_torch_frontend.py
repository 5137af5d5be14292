"""Parity of the PyTorch port's mono frame build with the JAX package.

Seeded numpy images go through both packages. Tolerances and why:
- copied NumPy constants: array_equal (the same code on the same seed);
- pyramid: atol 1e-3 at the 0..255 scale, 20x the measured gap of
  4.6e-5 (torch and XLA sum the matmuls in other orders);
- FAST at level 0, keypoint selection, patch gather: exact (integer or
  copied values; the stable sort reproduces top_k's tie order);
- IC_Angle: atol 1e-5 where the patch values are integers (level 0 of
  a uint8 image), since every partial sum of the moments is then an
  integer below 2^24 and exact in any order. On float-valued patches
  (levels >= 1) the moments are float32 sums of 1444 terms taken in
  another order by torch and XLA: measured up to 2.7e-5 rad on random
  patches and 1.0e-4 rad on a 300-feature frame, so atol 2e-4 there;
- descriptors: at most 2 flipped bits per descriptor (float association
  at near-ties, the bound of tests/test_pallas_kernels.py);
- build_frame_mono: keypoints (uv, level, valid) equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_test_tpu.engine import frame as jframe
from orb_slam2_test_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_test_tpu.ops import brief as jbrief
from orb_slam2_test_tpu.ops import extractor as jext
from orb_slam2_test_tpu.ops import fast as jfast
from orb_slam2_test_tpu.ops import patches as jpatches
from orb_slam2_test_tpu.ops import pyramid as jpyr
from orb_slam2_test_tpu_torch.engine import frame as tframe
from orb_slam2_test_tpu_torch.geometry.camera import PinholeCamera as TCam
from orb_slam2_test_tpu_torch.ops import brief as tbrief
from orb_slam2_test_tpu_torch.ops import extractor as text
from orb_slam2_test_tpu_torch.ops import fast as tfast
from orb_slam2_test_tpu_torch.ops import patches as tpatches
from orb_slam2_test_tpu_torch.ops import pyramid as tpyr

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flipped_bits(a, b):
    a = np.asarray(a).view(np.uint32)
    b = np.asarray(b).view(np.uint32)
    return np.unpackbits((a ^ b).view(np.uint8), axis=-1).sum(axis=-1)


@pytest.mark.parametrize(
    "name,args",
    [
        ("brief_pattern", ()),
        ("_binned_pattern_indices", ()),
    ],
)
def test_copied_brief_constants(name, args):
    np.testing.assert_array_equal(
        getattr(tbrief, name)(*args), getattr(jbrief, name)(*args)
    )
    for const in ("PATCH_RADIUS", "PATTERN_RADIUS", "N_BITS", "EDGE_MARGIN",
                  "N_ANGLE_BINS", "PATCH"):
        assert getattr(tbrief, const) == getattr(jbrief, const)


@pytest.mark.parametrize(
    "name", ["_selection_matrix", "_moment_operator_38", "_blur_band"]
)
def test_copied_patch_operators(name):
    np.testing.assert_array_equal(
        getattr(tpatches, name)(), getattr(jpatches, name)()
    )


@pytest.mark.parametrize("n_in,n_out", [(480, 400), (640, 533), (161, 134), (7, 3)])
def test_copied_pyramid_operators(n_in, n_out):
    np.testing.assert_array_equal(
        tpyr._resize_operator(n_in, n_out), jpyr._resize_operator(n_in, n_out)
    )
    np.testing.assert_array_equal(
        tpyr._blur_operator(n_in, 2.0, 7), jpyr._blur_operator(n_in, 2.0, 7)
    )
    for level in range(8):
        assert tpyr.level_shape(480, 640, level, 1.2) == jpyr.level_shape(
            480, 640, level, 1.2
        )
    assert text.level_feature_budget(1000, 8, 1.2) == jext.level_feature_budget(
        1000, 8, 1.2
    )


def test_pack_bits(rng):
    bits = rng.integers(0, 2, (5, 256)).astype(bool)
    j = np.asarray(jbrief.pack_bits(jnp.asarray(bits)))
    t = tbrief.pack_bits(_t(bits))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy().view(np.uint32), j)


def test_pyramid(rng):
    img = rng.uniform(0, 255, (240, 320)).astype(np.float32)
    j = jpyr.build_pyramid(jnp.asarray(img), 8, 1.2)
    t = tpyr.build_pyramid(_t(img), 8, 1.2)
    for a, b in zip(j, t):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)


@pytest.mark.parametrize("threshold", [7.0, 20.0])
def test_fast_level0_exact(rng, threshold):
    img = rng.integers(0, 256, (96, 128)).astype(np.float32)
    jc, js = jfast.fast_response(jnp.asarray(img), threshold)
    tc, ts = tfast.fast_response(_t(img), threshold)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tfast.nms_3x3(ts).numpy(), np.asarray(jfast.nms_3x3(js))
    )
    np.testing.assert_array_equal(
        tfast.border_mask(96, 128, 19).numpy(),
        np.asarray(jfast.border_mask(96, 128, 19)),
    )


@pytest.mark.parametrize("kind", ["ties", "sparse", "continuous"])
def test_select_level_keypoints(rng, kind):
    h, w, n_keep = 100, 150, 60
    if kind == "ties":  # small integers: most candidates tie
        score = rng.integers(0, 4, (h, w)).astype(np.float32)
    elif kind == "sparse":  # fewer corners than slots: -inf keys tie
        score = np.zeros((h, w), np.float32)
        score[rng.integers(0, h, 25), rng.integers(0, w, 25)] = 5.0
    else:
        score = rng.uniform(0, 50, (h, w)).astype(np.float32)
        score[score < 30] = 0.0
    j = jext._select_level_keypoints(jnp.asarray(score), n_keep)
    t = text._select_level_keypoints(_t(score), n_keep)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_patch_gather_plain_matches_pallas_interpret(rng):
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    xy = np.stack([rng.uniform(0, 159, 37), rng.uniform(0, 119, 37)], -1)
    xy = xy.astype(np.float32)
    xy[:4] = [[20.5, 30.5], [21.5, 31.5], [0.0, 0.0], [159.0, 119.0]]  # half-even, clip
    j = jpatches.extract_raw_patches(jnp.asarray(img), jnp.asarray(xy), interpret=True)
    t = tpatches.extract_raw_patches(_t(img), _t(xy))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_patch_gather_cuda_wrapper_rejects_cpu_tensors():
    img = torch.zeros((64, 64))
    xy = torch.full((3, 2), 32.0)
    with pytest.raises(ValueError, match="CUDA"):
        tpatches.extract_raw_patches_cuda(img, xy)
    assert tpatches.PATCH_GATHER.launches == 0


@pytest.mark.parametrize("values,atol", [("integer", 1e-5), ("float", 2e-4)])
def test_orb_from_patches(rng, values, atol):
    img = rng.uniform(0, 255, (240, 320)).astype(np.float32)
    if values == "integer":
        img = np.round(img)
    xy = np.stack([rng.uniform(25, 290, 64), rng.uniform(25, 210, 64)], -1)
    raw = np.asarray(
        jpatches.extract_raw_patches(jnp.asarray(img), jnp.asarray(xy, jnp.float32))
    )
    ja, jd = jpatches.orb_from_patches(jnp.asarray(raw))
    ta, td = tpatches.orb_from_patches(_t(raw))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=atol)
    assert _flipped_bits(td.numpy(), jd).max() <= 2


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(3)
    h, w = 240, 320
    img = rng.integers(0, 256, (h, w)).astype(np.uint8)
    kw = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=w, height=h)
    j = jframe.build_frame_mono(jnp.asarray(img), 0.0, JCam(**kw), n_features=300)
    t = tframe.build_frame_mono(_t(img), 0.0, TCam(**kw), n_features=300)
    return j, t


def test_build_frame_mono_keypoints(frames):
    j, t = frames
    for field in ("uv", "uv_raw", "level", "valid", "ur", "depth"):
        np.testing.assert_array_equal(
            getattr(t, field).numpy(), np.asarray(getattr(j, field)), err_msg=field
        )
    assert t.valid.sum() == 300


def test_build_frame_mono_orientation_and_descriptors(frames):
    j, t = frames
    level = t.level.numpy()
    err = np.abs(t.angle.numpy() - np.asarray(j.angle))
    assert err[level == 0].max() <= 1e-5
    assert err.max() <= 2e-4
    assert t.desc.dtype == torch.int32
    assert _flipped_bits(t.desc.numpy(), j.desc).max() <= 2
