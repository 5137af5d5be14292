"""Matmul precision for geometry-critical code.

The counterpart of orb_slam2_test_tpu/utils/precision.f32_matmuls. On
the card, float32 products run in full float32 only while TF32 is off:
PyTorch defaults cuBLAS matmuls to float32 but cuDNN convolutions to
TF32 (about three decimal digits), which would break pixel-level
geometry. The port's entry points call `f32_matmuls()` to state both
settings. The one product that runs in bf16 on purpose, the BRIEF
selection in ops/patches.py, casts its inputs explicitly and must
accumulate in float32, as the TPU's one bf16 pass does.
"""

from __future__ import annotations

import torch


def f32_matmuls() -> None:
    """Make float32 matmuls and convolutions run in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
