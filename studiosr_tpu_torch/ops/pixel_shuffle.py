"""Depth-to-space (pixel shuffle) for NHWC tensors.

Port of ``studiosr_tpu/ops/pixel_shuffle.py``. Channel order follows
PyTorch's ``nn.PixelShuffle``: input channel ``k*r*r + a*r + b`` goes to
output pixel ``(h*r + a, w*r + b)`` of channel ``k``.
"""

from __future__ import annotations

import torch

__all__ = ["pixel_shuffle"]


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(N, H, W, C*r^2) -> (N, H*r, W*r, C) with torch channel ordering."""
    n, h, w, c = x.shape
    r = scale
    oc = c // (r * r)
    x = x.reshape(n, h, w, oc, r, r).permute(0, 1, 4, 2, 5, 3)  # (N, H, r_a, W, r_b, C)
    return x.reshape(n, h * r, w * r, oc)
