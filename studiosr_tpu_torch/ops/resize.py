"""Bicubic resize with PyTorch's semantics on NHWC maps.

Port of ``studiosr_tpu/ops/resize.py`` (which the JAX package writes as two
matrix products, since ``jax.image.resize`` uses another kernel): the Keys
cubic with A = -0.75, half-pixel sampling (source = (dst + 0.5) * in / out -
0.5), the four taps clamped at the edges. That is
``F.interpolate(mode="bicubic", align_corners=False)`` at a given output
size, which this module calls on a channels-last view. SRCNN and VDSR
upsample their input with it. The output keeps the input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["bicubic_resize", "bicubic_upsample"]


def bicubic_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bicubic resize of NHWC ``x`` to (out_h, out_w)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w), mode="bicubic", align_corners=False)
    return y.permute(0, 2, 3, 1)


def bicubic_upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer-factor bicubic upsample (``nn.Upsample(scale_factor=s)``)."""
    return bicubic_resize(x, x.shape[1] * scale, x.shape[2] * scale)
