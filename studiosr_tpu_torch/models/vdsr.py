"""VDSR — Very Deep Super-Resolution (NHWC, PyTorch).

Port of ``studiosr_tpu/models/vdsr.py``: bicubic upsample to the target size
(``ops/resize.py``), ``n_layers + 2`` 3x3 convs with ReLU between them, a
global residual, mean normalisation; the reference's init (normal, std
sqrt(2 / (9 in_channels)), zero biases). Module names are the flax paths
(``layers.0``, ``layers.2``, ..., ``layers.{2 (n_layers + 1)}``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from studiosr_tpu_torch._device import resolve_device
from studiosr_tpu_torch.models.base import Model
from studiosr_tpu_torch.models.blocks import Normalizer, conv, slots
from studiosr_tpu_torch.ops.resize import bicubic_upsample

__all__ = ["VDSR", "VDSRModule"]

_TRAINING_CONFIG: Dict[str, Any] = dict(
    batch_size=32, learning_rate=0.0002, beta1=0.9, beta2=0.99, weight_decay=0.0, max_iters=500000, gamma=0.5,
    milestones=[250000, 400000, 450000, 475000],
)


class VDSRModule(nn.Module):
    def __init__(self, scale: int = 4, n_colors: int = 3, img_range: float = 1.0, channels: int = 64,
                 n_layers: int = 18) -> None:
        super().__init__()
        self.scale, self.n_layers = scale, n_layers
        self.normalizer = Normalizer(img_range)
        layers = {"0": conv(n_colors, channels)}
        layers.update({str(2 * (i + 1)): conv(channels, channels) for i in range(n_layers)})
        layers[str(2 * (n_layers + 1))] = conv(channels, n_colors)
        self.layers = slots(layers)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC forward; ``generator`` (the Trainer's draws) is unused: no layer is stochastic."""
        layers = self.layers._modules
        u = bicubic_upsample(self.normalizer.normalize(x), self.scale)
        y = u
        for i in range(self.n_layers + 1):
            y = F.relu(layers[str(2 * i)](y))
        return self.normalizer.unnormalize(layers[str(2 * (self.n_layers + 1))](y) + u)


def _init_weights(module: VDSRModule, generator: torch.Generator) -> None:
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.normal_(m.weight, std=math.sqrt(2.0 / (9 * m.in_channels)), generator=generator)
                nn.init.zeros_(m.bias)


class VDSR(Model):
    _training_config = _TRAINING_CONFIG

    @classmethod
    def build(cls, scale: int = 4, n_colors: int = 3, img_range: float = 1.0, channels: int = 64, n_layers: int = 18,
              seed: int = 0, device=None) -> "VDSR":
        """Seeded VDSR on ``device`` (default ``cuda``), in eval mode."""
        dev = resolve_device(device)
        config = dict(scale=scale, n_colors=n_colors, img_range=img_range, channels=channels, n_layers=n_layers)
        module = VDSRModule(**config)
        _init_weights(module, torch.Generator().manual_seed(seed))
        return cls(module.to(dev).eval(), config, dev)

    @classmethod
    def from_pretrained(cls, scale: int = 4, device=None) -> "VDSR":
        """The published ``VDSRx{scale}`` checkpoints (x2, x3, x4) from
        ``./pretrained`` (downloaded there on first use), every parameter
        required."""
        from studiosr_tpu_torch.zoo import fetch, load_torch_state_dict, translate_state_dict

        file_ids = {
            2: "1eQnGseT3SqQirB5ueAFfsClhLlpeoUOX",
            3: "1wXOnLFf7rWglzzVMzYSVrb5Po79vUUq3",
            4: "1Q5DKy7oAQbgGqxI-unxPy9X3GcHwZokC",
        }
        if scale not in file_ids:
            raise ValueError(f"VDSR.from_pretrained: no release at scale {scale}")
        model = cls.build(scale=scale, device=device)
        path = fetch(f"VDSRx{scale}.pth", gdrive_id=file_ids[scale])
        translate_state_dict(load_torch_state_dict(path), model.module)
        return model
