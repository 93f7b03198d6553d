"""Shared NHWC building blocks (subset), PyTorch.

Port of ``studiosr_tpu/models/blocks.py``. Modules carry the same names as
the flax paths, which are the reference checkpoints' torch key prefixes
(``upsample.0``, ``conv_before_upsample.0`` ...), so a state_dict key here
is the joined flax path with torch leaf names.

* GELU is the exact (erf) variant.
* LayerNorm eps is 1e-5.
* Convolutions store torch OIHW weights and take NHWC activations: the input
  is handed to ``F.conv2d`` as a channels-last view (``permute(0, 3, 1, 2)``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from studiosr_tpu_torch.ops.pixel_shuffle import pixel_shuffle

__all__ = ["DEFAULT_RGB_MEAN", "Normalizer", "Conv", "conv", "gelu", "LayerNorm", "Mlp", "Upsampler"]

# DIV2K RGB mean, the normalization constant of the reference models.
DEFAULT_RGB_MEAN = (0.4488, 0.4371, 0.4040)


class Normalizer:
    """Mean-subtract / re-add helper. Stateless."""

    def __init__(self, img_range: float = 1.0) -> None:
        self.img_range = img_range

    def _mean(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tensor(DEFAULT_RGB_MEAN, dtype=x.dtype, device=x.device)

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return x / self.img_range - self._mean(x)

    def unnormalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x + self._mean(x)) * self.img_range


class Conv(nn.Conv2d):
    """NHWC conv with torch-style ``k//2`` zero padding (OIHW weights)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3) -> None:
        super().__init__(in_features, features, kernel_size, padding=kernel_size // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def conv(in_features: int, features: int, kernel_size: int = 3) -> Conv:
    return Conv(in_features, features, kernel_size)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) GELU."""
    return F.gelu(x)


def LayerNorm(features: int) -> nn.LayerNorm:
    """LayerNorm with torch eps (the flax port sets the same 1e-5)."""
    return nn.LayerNorm(features, eps=1e-5)


class Mlp(nn.Module):
    """Linear-GELU-Linear feed-forward (eval: no dropout)."""

    def __init__(self, in_features: int, hidden_features: Optional[int] = None, out_features: Optional[int] = None):
        super().__init__()
        hidden = hidden_features or in_features
        out = out_features or in_features
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class Upsampler(nn.Module):
    """conv -> PixelShuffle ladder.

    * ``num_out_ch`` set: one conv to ``s^2 * num_out_ch`` then shuffle
      ("pixelshuffledirect");
    * power-of-two scale: log2 ladder of (conv 4x, shuffle 2);
    * otherwise (x3): one conv to ``s^2 * n_feats`` then shuffle.

    Convs are named by torch Sequential index ("0", "2", ...); the shuffles
    hold the odd slots and no parameters.
    """

    def __init__(self, scale: int, n_feats: int, num_out_ch: Optional[int] = None) -> None:
        super().__init__()
        s = scale
        self.scale = s
        self.direct = num_out_ch is not None
        if self.direct:
            self.add_module("0", conv(n_feats, s * s * num_out_ch))
        elif (s & (s - 1)) == 0:
            for i in range(int(math.log2(s))):
                self.add_module(str(2 * i), conv(n_feats, 4 * n_feats))
        else:
            self.add_module("0", conv(n_feats, s * s * n_feats))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.scale
        if self.direct or (s & (s - 1)) != 0:
            return pixel_shuffle(self._modules["0"](x), s)
        for i in range(int(math.log2(s))):
            x = pixel_shuffle(self._modules[str(2 * i)](x), 2)
        return x
