"""The port's BRIEF bits: a gather of each keypoint's own tap pairs,
held to the JAX package's signed selection product.

The JAX package reads the 256 bits of a keypoint from one product of
the blurred, mean-centered patches with `_selection_matrix()` [1024,
7680] over all 30 angle bins, one bf16 pass on a TPU and float32 on the
CPU. Each column of that matrix holds one +1 and one -1 (none where a
pair's two taps fall on one pixel), so its float32 entries are exactly
a - b, and the port's gather (`ops.patches.
brief_bits`) must give the same bits with 0 mismatches: exact ties and
1-ulp near-ties included. The port runs this one float32 path on every
device; the frame build's modules hold no reduced-precision dtype.
chip_smoke.py holds the card's bits to the CPU port's on the card's own
patches, allowing a flip only at a near-tie of its two taps within
FLIP_TIE_RATIO of the patch's blur peak (`_flip_tie_ratio`): on the
scenes of its [4], float32 rounding of the blur stays far inside that
bound, and a bf16 selection or a TF32 blur does not. The SVD helper that
the card routes the initialization's three 3x3 SVDs through (`geometry.linalg.svd`) is
torch.linalg.svd bit for bit on the CPU.
"""

import importlib.util
import inspect
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_test_tpu.ops import patches as jpatches
from orb_slam2_test_tpu_torch import entry
from orb_slam2_test_tpu_torch.engine import frame as tframe
from orb_slam2_test_tpu_torch.ops import brief as tbrief
from orb_slam2_test_tpu_torch.ops import extractor as text
from orb_slam2_test_tpu_torch.ops import patches as tpatches

torch.set_num_threads(2)

N_PATCHES = 4000
N_BINS = 30


def _product_bits(blurred: np.ndarray) -> np.ndarray:
    """[N, 30, 256] bool: the JAX package's all-bin selection product
    (its CPU precision, float32), read as `orb_from_patches` reads it."""
    vals = jax.lax.dot_general(
        jnp.asarray(blurred), jnp.asarray(jpatches._selection_matrix()),
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT)
    return np.asarray(vals).reshape(blurred.shape[0], N_BINS, 256) < 0.0


def _gather_bits(blurred: np.ndarray) -> np.ndarray:
    """[N, 30, 256] bool: the port's gather, once for every bin."""
    t = torch.from_numpy(blurred)
    return np.stack([
        tpatches.brief_bits(t, torch.full((t.shape[0],), b, dtype=torch.int64)).numpy()
        for b in range(N_BINS)], axis=1)


def _selection_inputs(rng) -> np.ndarray:
    """[4000, 1024] float32 mean-centered blurred patches: a quarter
    blurred from random raw patches, a quarter integer-valued before the
    centering (ties by the hundred), a quarter with exact ties planted on the taps of every
    bin, a quarter with 1-ulp near-ties planted there (either side)."""
    q = N_PATCHES // 4
    raw = rng.uniform(0, 255, (q, 38, 38)).astype(np.float32)
    A = tpatches._blur_band()
    blurred = np.einsum("oi,nij,pj->nop", A, raw, A).reshape(q, -1).astype(np.float32)
    integer = rng.integers(-8, 9, (q, 1024)).astype(np.float32)
    taps = tbrief._binned_pattern_indices().reshape(-1, 2)
    tied = rng.normal(0, 20, (q, 1024)).astype(np.float32)
    near = rng.normal(0, 20, (q, 1024)).astype(np.float32)
    for i in range(q):
        a, b = taps[rng.choice(len(taps), 64, replace=False)].T
        tied[i, b] = tied[i, a]
        near[i, b] = np.nextafter(near[i, a], np.where(rng.random(64) < 0.5, -np.inf, np.inf)
                                  ).astype(np.float32)
    out = np.concatenate([blurred, integer, tied, near])
    return (out - out.mean(1, keepdims=True)).astype(np.float32)


def test_gather_bits_equal_the_selection_product(rng):
    blurred = _selection_inputs(rng)
    taps = tbrief._binned_pattern_indices().reshape(-1, 2)
    diff = blurred[:, taps[:, 0]] - blurred[:, taps[:, 1]]
    # the planted ties and near-ties are there, on both sides of zero
    assert (diff == 0).sum() > 10_000
    assert (np.abs(diff[2000:]) < 1e-5).sum() > 10_000
    product, gather = _product_bits(blurred), _gather_bits(blurred)
    assert int((product != gather).sum()) == 0
    assert 0.3 < gather.mean() < 0.7


@pytest.mark.parametrize("values", ["integer", "float"])
def test_orb_from_patches_equals_jax_exactly(rng, values):
    # the inputs of tests/test_torch_frontend.py::test_orb_from_patches
    img = rng.uniform(0, 255, (240, 320)).astype(np.float32)
    if values == "integer":
        img = np.round(img)
    xy = np.stack([rng.uniform(25, 290, 64), rng.uniform(25, 210, 64)], -1)
    raw = np.array(
        jpatches.extract_raw_patches(jnp.asarray(img), jnp.asarray(xy, jnp.float32))
    )
    _, jd = jpatches.orb_from_patches(jnp.asarray(raw))
    _, td = tpatches.orb_from_patches(torch.from_numpy(raw))
    np.testing.assert_array_equal(td.numpy().view(np.uint32), np.asarray(jd))


@pytest.mark.parametrize("module", [tpatches, text, tbrief, tframe])
def test_frame_build_has_one_float32_path(module):
    src = inspect.getsource(module)
    for dtype in ("bfloat16", "float16", ".half(", ".bfloat16("):
        assert dtype not in src, f"{module.__name__} names {dtype}"
    body = inspect.getsource(tpatches.orb_from_patches) + inspect.getsource(
        tpatches.brief_bits)
    for branch in ("is_cuda", "device.type", "select_dtype"):
        assert branch not in body


@pytest.mark.parametrize("shape,full_matrices", [
    ((200, 3, 3), True), ((3, 3), True), ((200, 16, 9), True), ((16, 9), False)])
def test_svd_helper_is_torch_svd_on_the_cpu(rng, shape, full_matrices):
    from orb_slam2_test_tpu_torch.geometry import linalg

    A = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    for a, b in zip(linalg.svd(A, full_matrices), torch.linalg.svd(A, full_matrices)):
        assert torch.equal(a, b)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke_patches():
    """The raw patches [N, 38, 38] of chip_smoke.py [4]'s frame at two
    scene seeds, as the port's mono frame build gathers them on the CPU."""
    raws = []
    orb = text.orb_from_patches

    def recorded(raw):
        raws.append(raw.clone())
        return orb(raw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(text, "orb_from_patches", recorded)
        for seed in range(2):
            img, *_ = entry.example_scene(np.random.default_rng(seed), "cpu")
            tframe.build_frame_mono(torch.from_numpy(img), 0.0, entry.CAM)
    return torch.cat(raws)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa (nearest, ties away)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _blur_bits(raw, variant: str, bin_id) -> tuple[torch.Tensor, torch.Tensor]:
    """A variant of orb_from_patches's blur and BRIEF read on the same
    bins: (uncentered blur [N, 1024] float64, bits [N, 256])."""
    n = raw.shape[0]
    _, A, AT, taps = tpatches._operators(torch.device("cpu"))
    if variant == "float64 blur":
        blur = (A.double() @ raw.double()) @ AT.double()
    elif variant == "reordered float32 blur":
        blur = A @ (raw @ AT)
    elif variant == "TF32 blur":
        blur = (_tf32(A) @ _tf32(raw)) @ _tf32(AT)
    else:
        blur = (A @ raw) @ AT
    blur = blur.reshape(n, -1)
    centered = blur - blur.mean(dim=1, keepdim=True)
    if variant != "bf16 selection":
        return blur.double(), tpatches.brief_bits(centered, bin_id)
    # the JAX package's all-bin product, one bf16 pass as on a TPU
    D = torch.from_numpy(jpatches._selection_matrix()).to(torch.bfloat16)
    vals = (centered.to(torch.bfloat16) @ D).float().reshape(n, N_BINS, 256)
    return blur.double(), vals[torch.arange(n), bin_id] < 0.0


@pytest.mark.parametrize("variant", [
    "float64 blur", "reordered float32 blur", "bf16 selection", "TF32 blur"])
def test_flip_tie_bound_separates_float32_from_reduced_precision(smoke_patches, variant):
    cs = _chip_smoke()
    raw = smoke_patches
    n = raw.shape[0]
    angle, desc = tpatches.orb_from_patches(raw)
    bin_id = (torch.round(torch.remainder(angle, 2 * math.pi) * (N_BINS / (2 * math.pi)))
              .to(torch.int64) % N_BINS)
    blur, bits = _blur_bits(raw, variant, bin_id)
    ref = np.unpackbits(desc.numpy().view(np.uint8), axis=1, bitorder="little").astype(bool)
    flipped = bits.numpy() != ref
    ratios = cs._flip_tie_ratio(raw, bin_id.numpy(), flipped)
    f32 = ((tpatches._operators(torch.device("cpu"))[1] @ raw) @
           tpatches._operators(torch.device("cpu"))[2]).reshape(n, -1).double()
    moved = float(((blur - f32).abs() / f32.abs().amax(1, keepdim=True)).max())
    print(f"{variant}: {int(flipped.sum())} of {flipped.size} bits flipped, the blur moved "
          f"{moved:.2e} of its peak, {int((ratios > cs.FLIP_TIE_RATIO).sum())} flips beyond "
          f"FLIP_TIE_RATIO")
    if variant in ("float64 blur", "reordered float32 blur"):
        # float32 rounding: a flip, if any, lies far inside the bound
        assert moved < cs.FLIP_TIE_RATIO / 4
        assert ratios.size == 0 or ratios.max() <= cs.FLIP_TIE_RATIO
    else:
        assert flipped.sum() >= 100
        assert (ratios > cs.FLIP_TIE_RATIO).mean() > 0.5
