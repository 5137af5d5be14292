"""ORB feature extraction — pyramid FAST + oriented BRIEF, end to end.

Port of orb_slam2_test_tpu/ops/extractor.py (reference:
ORBextractor::operator(), ComputeKeyPointsOctTree, DistributeOctTree).
One dense FAST pass at the low threshold plus a bonus for corners that
pass the high one; a per-cell rank penalty spreads the keypoints over
the image; per-level budgets follow the reference's geometric split.
Each level yields exactly n_l keypoint slots, masked where fewer
corners exist.

The JAX package selects with `jax.lax.top_k`, which returns tied
values lowest index first. `torch.topk` does not promise that order,
so both selections here take a stable descending sort, which does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_test_tpu_torch.ops.brief import EDGE_MARGIN
from orb_slam2_test_tpu_torch.ops.fast import border_mask, fast_response, nms_3x3
from orb_slam2_test_tpu_torch.ops.patches import extract_raw_patches, orb_from_patches
from orb_slam2_test_tpu_torch.ops.pyramid import build_pyramid

HIGH_TH_BONUS = 1.0e5  # ranking bonus for corners passing iniThFAST
RANK_PENALTY = 1.0e6  # per-cell-rank lexicographic penalty
CELL = 32  # selection cell size (reference uses ~30 px cells)
CANDS_PER_CELL = 8  # per-cell candidates entering global selection


class Features(NamedTuple):
    """Extracted features, fixed capacity N (= nfeatures).

    uv       [N, 2] float32 — (x, y) in level-0 pixel coords
    level    [N] int32      — pyramid level (octave)
    angle    [N] float32    — orientation, radians
    response [N] float32    — FAST response score
    desc     [N, 8] int32   — packed 256-bit descriptors (bit patterns)
    valid    [N] bool
    """

    uv: torch.Tensor
    level: torch.Tensor
    angle: torch.Tensor
    response: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor


def level_feature_budget(
    n_features: int, n_levels: int, scale_factor: float
) -> list[int]:
    """Per-level feature counts (reference ORBextractor ctor:
    mnFeaturesPerLevel, geometric with remainder to the last level)."""
    f = 1.0 / scale_factor
    first = n_features * (1.0 - f) / (1.0 - f**n_levels)
    counts = []
    acc = 0
    for l in range(n_levels - 1):
        c = int(round(first * f**l))
        counts.append(c)
        acc += c
    counts.append(max(n_features - acc, 0))
    return counts


def _top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, ties lowest index first (jax.lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _select_level_keypoints(
    score: torch.Tensor, n_keep: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spatially distributed top-n_keep selection from a response map.

    Returns (xy [n_keep, 2] float32, response [n_keep], valid [n_keep]).
    """
    h, w = score.shape
    ph = -(-h // CELL) * CELL
    pw = -(-w // CELL) * CELL
    padded = torch.zeros((ph, pw), dtype=score.dtype, device=score.device)
    padded[:h, :w] = score

    ncy, ncx = ph // CELL, pw // CELL
    cells = padded.reshape(ncy, CELL, ncx, CELL).permute(0, 2, 1, 3)
    cells = cells.reshape(ncy * ncx, CELL * CELL)

    # per-cell top candidates, rank = position in the cell's ordering
    cvals, cidx = _top_k_stable(cells, CANDS_PER_CELL)  # [nc, cands]
    rank = torch.arange(CANDS_PER_CELL, dtype=torch.float32, device=score.device)
    neg_inf = torch.full((), -torch.inf, dtype=score.dtype, device=score.device)
    key = torch.where(cvals > 0.0, cvals - rank * RANK_PENALTY, neg_inf)

    top_keys, flat_pos = _top_k_stable(key.reshape(-1), n_keep)
    cell_id = flat_pos // CANDS_PER_CELL
    slot = flat_pos % CANDS_PER_CELL
    inner = cidx[cell_id, slot]  # position within the cell
    cy, cx = cell_id // ncx, cell_id % ncx
    y = cy * CELL + inner // CELL
    x = cx * CELL + inner % CELL

    resp = cvals[cell_id, slot]
    valid = top_keys > -torch.inf
    xy = torch.stack([x, y], dim=-1).to(torch.float32)
    return xy, torch.where(valid, resp, torch.zeros_like(resp)), valid


def extract_orb(
    img: torch.Tensor,
    n_features: int = 1000,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    ini_th: float = 20.0,
    min_th: float = 7.0,
) -> Features:
    """Full ORB extraction on a float32 [H, W] grayscale image (0..255),
    with keypoints in level-0 pixel coordinates."""
    pyr = build_pyramid(img, n_levels, scale_factor)
    budgets = level_feature_budget(n_features, n_levels, scale_factor)

    outs = {k: [] for k in Features._fields}
    for l, (level_img, n_l) in enumerate(zip(pyr, budgets)):
        if n_l == 0:
            continue
        h, w = level_img.shape
        corner_lo, score_lo = fast_response(level_img, min_th)
        corner_hi, _ = fast_response(level_img, ini_th)
        eff = score_lo + corner_hi.to(score_lo.dtype) * HIGH_TH_BONUS
        eff = torch.where(
            border_mask(h, w, EDGE_MARGIN, img.device), eff, torch.zeros_like(eff)
        )
        eff = nms_3x3(eff)

        xy, resp, valid = _select_level_keypoints(eff, n_l)

        # kernel 1 gathers the windows; moments, blur and BRIEF follow
        raw = extract_raw_patches(level_img, xy)
        angle, desc = orb_from_patches(raw)

        outs["uv"].append(xy * scale_factor**l)
        outs["level"].append(
            torch.full((n_l,), l, dtype=torch.int32, device=img.device)
        )
        outs["angle"].append(angle)
        # strip the high-threshold bonus back out of the reported response
        outs["response"].append(
            torch.where(resp >= HIGH_TH_BONUS, resp - HIGH_TH_BONUS, resp)
        )
        outs["desc"].append(desc)
        outs["valid"].append(valid)

    return Features(**{k: torch.cat(v, dim=0) for k, v in outs.items()})
