"""ESPCN — efficient sub-pixel convolutional network (NHWC, PyTorch).

Port of ``studiosr_tpu/models/espcn.py``: tanh feature maps in LR space, a
last conv to s^2 n_colors channels, PixelShuffle, mean normalisation; the
reference's init (normal, std 0.001 after the 32-channel layer, else
sqrt(2 / (out k^2)), zero biases). Module names are the flax paths
(``feature_maps.0``, ``feature_maps.2``, ``sub_pixel.0``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from studiosr_tpu_torch._device import resolve_device
from studiosr_tpu_torch.models.base import Model
from studiosr_tpu_torch.models.blocks import Normalizer, conv, slots
from studiosr_tpu_torch.ops.pixel_shuffle import pixel_shuffle

__all__ = ["ESPCN", "ESPCNModule"]

_TRAINING_CONFIG: Dict[str, Any] = dict(
    batch_size=32, learning_rate=0.0002, beta1=0.9, beta2=0.99, weight_decay=0.0, max_iters=500000, gamma=0.5,
    milestones=[250000, 400000, 450000, 475000],
)


class ESPCNModule(nn.Module):
    def __init__(self, scale: int = 4, n_colors: int = 3, img_range: float = 1.0, channels: int = 64) -> None:
        super().__init__()
        self.scale = scale
        self.normalizer = Normalizer(img_range)
        hidden = channels // 2
        self.feature_maps = slots({"0": conv(n_colors, channels, 5), "2": conv(channels, hidden, 3)})
        self.sub_pixel = slots({"0": conv(hidden, n_colors * scale**2, 3)})

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC forward; ``generator`` (the Trainer's draws) is unused: no layer is stochastic."""
        fm = self.feature_maps._modules
        x = torch.tanh(fm["2"](torch.tanh(fm["0"](self.normalizer.normalize(x)))))
        return self.normalizer.unnormalize(pixel_shuffle(self.sub_pixel._modules["0"](x), self.scale))


def _init_weights(module: ESPCNModule, generator: torch.Generator) -> None:
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                k = m.kernel_size[0]
                std = 0.001 if m.in_channels == 32 else math.sqrt(2.0 / (m.out_channels * k * k))
                nn.init.normal_(m.weight, std=std, generator=generator)
                nn.init.zeros_(m.bias)


class ESPCN(Model):
    _training_config = _TRAINING_CONFIG

    @classmethod
    def build(cls, scale: int = 4, n_colors: int = 3, img_range: float = 1.0, channels: int = 64, seed: int = 0,
              device=None) -> "ESPCN":
        """Seeded ESPCN on ``device`` (default ``cuda``), in eval mode."""
        dev = resolve_device(device)
        config = dict(scale=scale, n_colors=n_colors, img_range=img_range, channels=channels)
        module = ESPCNModule(**config)
        _init_weights(module, torch.Generator().manual_seed(seed))
        return cls(module.to(dev).eval(), config, dev)
