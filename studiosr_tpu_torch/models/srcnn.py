"""SRCNN — the three-layer SR CNN (NHWC, PyTorch).

Port of ``studiosr_tpu/models/srcnn.py``: bicubic upsample
(``ops/resize.py``), 9-5-5 convs with ReLU, an optional global residual,
mean normalisation. Module names are the flax paths (``layers.0``,
``layers.2``, ``layers.4``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from studiosr_tpu_torch._device import resolve_device
from studiosr_tpu_torch.models.base import Model
from studiosr_tpu_torch.models.blocks import Normalizer, conv, flax_default_init, slots
from studiosr_tpu_torch.ops.resize import bicubic_upsample

__all__ = ["SRCNN", "SRCNNModule"]

_TRAINING_CONFIG: Dict[str, Any] = dict(
    batch_size=32, learning_rate=0.0002, beta1=0.9, beta2=0.99, weight_decay=0.0, max_iters=500000, gamma=0.5,
    milestones=[250000, 400000, 450000, 475000],
)


class SRCNNModule(nn.Module):
    def __init__(self, scale: int = 4, n_colors: int = 3, img_range: float = 1.0, residual: bool = False) -> None:
        super().__init__()
        self.scale, self.residual = scale, residual
        self.normalizer = Normalizer(img_range)
        self.layers = slots({"0": conv(n_colors, 64, 9), "2": conv(64, 32, 5), "4": conv(32, n_colors, 5)})

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC forward; ``generator`` (the Trainer's draws) is unused: no layer is stochastic."""
        layers = self.layers._modules
        u = bicubic_upsample(self.normalizer.normalize(x), self.scale)
        y = layers["4"](F.relu(layers["2"](F.relu(layers["0"](u)))))
        if self.residual:
            y = y + u
        return self.normalizer.unnormalize(y)


class SRCNN(Model):
    _training_config = _TRAINING_CONFIG

    @classmethod
    def build(cls, scale: int = 4, n_colors: int = 3, img_range: float = 1.0, residual: bool = False, seed: int = 0,
              device=None) -> "SRCNN":
        """Seeded SRCNN on ``device`` (default ``cuda``), in eval mode."""
        dev = resolve_device(device)
        config = dict(scale=scale, n_colors=n_colors, img_range=img_range, residual=residual)
        module = SRCNNModule(**config)
        flax_default_init(module, torch.Generator().manual_seed(seed))
        return cls(module.to(dev).eval(), config, dev)
