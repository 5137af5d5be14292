"""Robust-loss constants and the Huber IRLS weight.

Port of orb_slam2_test_tpu/geometry/robust.py (reference: Optimizer.cc
thHuberMono / thHuberStereo and the 5.991 / 7.815 chi2 gates).
"""

from __future__ import annotations

import torch

# 95% chi-square quantiles used throughout ORB-SLAM2.
CHI2_MONO = 5.991  # 2 dof (u, v)
CHI2_STEREO = 7.815  # 3 dof (u, v, u_r)

HUBER_MONO = CHI2_MONO ** 0.5
HUBER_STEREO = CHI2_STEREO ** 0.5


def huber_weight(chi2: torch.Tensor, delta) -> torch.Tensor:
    """IRLS weight for the Huber loss: 1 for |r| <= delta, else delta/|r|."""
    r = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.clamp(delta / r, max=1.0)


def huber_loss(chi2: torch.Tensor, delta) -> torch.Tensor:
    """rho(chi2), the robustified cost: chi2 for |r| <= delta, else
    2 delta |r| - delta^2."""
    r = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(r <= delta, chi2, 2.0 * delta * r - delta * delta)
