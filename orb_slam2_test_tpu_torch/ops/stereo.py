"""Stereo scanline matching: left/right ORB association + SAD subpixel.

Port of orb_slam2_test_tpu/ops/stereo.py (reference:
Frame::ComputeStereoMatches). Every left keypoint takes the best right
keypoint on its scanline (row band +-2 px scaled by octave) within the
disparity range, through one masked [Nl, Nr] Hamming matrix; the
disparity is refined by an 11x11 SAD search over a +-5 px slide on the
pyramid-level images, and matches whose SAD exceeds the robust median
gate are dropped.

The SAD windows are cut from the 32x32 core of the raw patches that
kernel 1 (`ops.patches.extract_raw_patches_levels`) gathers: one launch
for every level of both pyramids (16 images at 8 levels; the kernel's
table takes 32), and one SAD pass over all slots.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_test_tpu_torch.ops.brief import PATCH
from orb_slam2_test_tpu_torch.ops.extractor import Features, level_feature_budget
from orb_slam2_test_tpu_torch.ops.matching import best_two, masked_hamming_matrix
from orb_slam2_test_tpu_torch.ops.patches import CORE_OFF, extract_raw_patches_levels

TH_ORB = 75  # (TH_HIGH + TH_LOW) / 2, reference thOrbDist
SAD_W = 5  # 11x11 window
SAD_L = 5  # +-5 px slide


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of a 1-D tensor, as jnp.nanmedian:
    the mean of the two middle values for an even count (torch.nanmedian
    returns the lower one), NaN when every entry is NaN. No host sync."""
    s = torch.sort(x).values  # NaN sorts last
    n = (~torch.isnan(x)).sum()
    lo = torch.div(n - 1, 2, rounding_mode="floor").clamp(min=0)
    hi = torch.div(n, 2, rounding_mode="floor")
    return (s[lo] + s[hi]) * 0.5


def _sad_refine(
    lpatch: torch.Tensor,  # [N, PATCH*PATCH] left patches (level coords)
    rpatch: torch.Tensor,  # [N, PATCH*PATCH] right patches at candidate
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best slide offset + subpixel delta by SAD parabola.

    Returns (delta_r [N], the refinement to ADD to the right x
    coordinate, best_sad [N]). Windows are intensity-normalized by their
    center pixel, as in the reference."""
    N = lpatch.shape[0]
    lp = lpatch.reshape(N, PATCH, PATCH)
    rp = rpatch.reshape(N, PATCH, PATCH)
    c = PATCH // 2
    rows = slice(c - SAD_W, c + SAD_W + 1)
    lwin = lp[:, rows, c - SAD_W : c + SAD_W + 1]
    lwin = lwin - lwin[:, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]

    sads = []
    for dx in range(-SAD_L, SAD_L + 1):
        rwin = rp[:, rows, c - SAD_W + dx : c + SAD_W + 1 + dx]
        rwin = rwin - rwin[:, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]
        sads.append((lwin - rwin).abs().sum(dim=(1, 2)))
    sad = torch.stack(sads, dim=1)  # [N, 11]

    best = sad.argmin(dim=1)  # the first minimum, as jnp.argmin
    best_c = best.clamp(1, 2 * SAD_L - 1)  # need neighbors for the parabola
    n0 = sad.gather(1, (best_c - 1)[:, None])[:, 0]
    n1 = sad.gather(1, best_c[:, None])[:, 0]
    n2 = sad.gather(1, (best_c + 1)[:, None])[:, 0]
    denom = torch.clamp(n0 + n2 - 2.0 * n1, min=1e-6)
    sub = torch.clamp((n0 - n2) / (2.0 * denom), -1.0, 1.0)
    delta = (best_c - SAD_L).to(torch.float32) + sub
    return delta, n1


def associate(
    fl: Features, fr: Features, max_disp: float, n_levels: int, scale_factor: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best right keypoint per left keypoint on the masked [Nl, Nr]
    Hamming matrix (levels within 1, the row band, the disparity range).
    Returns (matched [Nl] bool, j [Nl] int64 right index, 0 if none)."""
    scales = torch.tensor(
        [scale_factor**l for l in range(n_levels)], dtype=torch.float32,
        device=fl.uv.device,
    )
    d = masked_hamming_matrix(fl.desc, fr.desc, fl.valid, fr.valid)
    lvl_ok = (fl.level[:, None] - fr.level[None, :]).abs() <= 1
    band = scales[fr.level.clamp(0, n_levels - 1).to(torch.int64)] * 2.0
    row_ok = (fl.uv[:, None, 1] - fr.uv[None, :, 1]).abs() <= band[None, :]
    disp = fl.uv[:, None, 0] - fr.uv[None, :, 0]
    disp_ok = (disp >= -3.0) & (disp <= max_disp)
    d = torch.where(lvl_ok & row_ok & disp_ok, d, 512)
    best_idx, best, _ = best_two(d)
    return (best <= TH_ORB) & fl.valid, best_idx.clamp(min=0).to(torch.int64)


@functools.lru_cache(maxsize=None)
def _row_inv_scale(
    device: torch.device, counts: tuple[int, ...], levels: tuple[int, ...],
    scale_factor: float,
) -> torch.Tensor:
    """[N] float32 1 / scale of each feature slot's level (slots are in
    level order, counts[i] of them at levels[i]), made once per device."""
    inv = np.repeat([1.0 / float(scale_factor**l) for l in levels], counts)
    return torch.from_numpy(inv.astype(np.float32)).to(device)


class SadCoordinates(NamedTuple):
    """Kernel 1's inputs for the SAD, every level at once: the levels
    with keypoints and their slot counts (slots are in level order), and
    per slot 1 / scale of its level, the left keypoint [N, 2] and its
    right candidate [N, 2] in that level's coordinates. The right
    candidate is scaled to the LEFT keypoint's level."""

    levels: list[int]
    counts: list[int]
    inv_s: torch.Tensor
    xy_l: torch.Tensor
    xy_r: torch.Tensor


def sad_coordinates(
    fl: Features, fr: Features, j: torch.Tensor, n_features: int, n_levels: int,
    scale_factor: float,
) -> SadCoordinates:
    """The SAD's window centres; see `SadCoordinates`."""
    budgets = level_feature_budget(n_features, n_levels, scale_factor)
    levels = [l for l, n_l in enumerate(budgets) if n_l > 0]
    counts = [budgets[l] for l in levels]
    inv_s = _row_inv_scale(fl.uv.device, tuple(counts), tuple(levels), scale_factor)
    return SadCoordinates(
        levels, counts, inv_s, fl.uv * inv_s[:, None], fr.uv[j] * inv_s[:, None]
    )


def stereo_match(
    fl: Features,
    fr: Features,
    left_pyr: list[torch.Tensor],  # per-level left images
    right_pyr: list[torch.Tensor],  # per-level right images
    bf: float,
    n_features: int,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    min_z: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Associate left -> right features and compute (ur [N], depth [N]);
    -1 where no stereo match."""
    if min_z is None:
        min_z = bf / left_pyr[0].shape[1]  # baseline (reference minZ = b)
    max_disp = bf / min_z
    matched, j = associate(fl, fr, max_disp, n_levels, scale_factor)

    # SAD subpixel refinement of every slot at once: the windows of both
    # sides on every level come from one kernel-1 launch
    sc = sad_coordinates(fl, fr, j, n_features, n_levels, scale_factor)
    n = sc.xy_l.shape[0]
    images = [left_pyr[l] for l in sc.levels] + [right_pyr[l] for l in sc.levels]
    raw = extract_raw_patches_levels(images, torch.cat([sc.xy_l, sc.xy_r]), sc.counts * 2)
    co = CORE_OFF
    core = raw[:, co : co + PATCH, co : co + PATCH].reshape(2 * n, PATCH * PATCH)
    delta, sad_all = _sad_refine(core[:n], core[n:])
    # refined right u in full-resolution coordinates
    ur = (torch.round(sc.xy_r[:, 0]) + delta) / sc.inv_s

    disp_final = fl.uv[:, 0] - ur
    ok = matched & (disp_final > 0.0) & (disp_final <= max_disp)
    # near-zero disparity clamp like the reference (disparity <= 0 drops)
    depth = torch.where(ok, bf / torch.clamp(disp_final, min=1e-6), -1.0)

    # robust SAD gate: keep sad <= 1.5 * 1.4 * median (reference)
    med = nanmedian(torch.where(ok, sad_all, torch.nan))
    keep = ok & (sad_all <= 2.1 * med)
    return torch.where(keep, ur, -1.0), torch.where(keep, depth, -1.0)
