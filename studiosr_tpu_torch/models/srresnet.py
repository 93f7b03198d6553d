"""SRResNet — the SRGAN generator (NHWC, PyTorch).

Port of ``studiosr_tpu/models/srresnet.py``: a 9x9 head conv with PReLU,
``num_rcb`` residual blocks (conv, BatchNorm, PReLU, conv, BatchNorm), a
bias-free conv + BatchNorm joined to the head, a PixelShuffle ladder with
PReLU, a 9x9 tail; scales 2, 4 and 8. BatchNorm follows flax's arithmetic
(``models/blocks.py::BatchNorm``); its running statistics come back from a
JAX checkpoint's ``batch_stats`` through the weight bridge. Module names
are the flax paths (``conv1.0``, ``trunk.i.rcb.{0..4}``,
``upsampling.i.upsample_block.{0,2}``, ``conv3``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from studiosr_tpu_torch._device import resolve_device
from studiosr_tpu_torch.models.base import Model
from studiosr_tpu_torch.models.blocks import BatchNorm, Normalizer, PReLU, conv, flax_default_init, slots
from studiosr_tpu_torch.ops.pixel_shuffle import pixel_shuffle

__all__ = ["SRResNet", "SRResNetModule"]

_TRAINING_CONFIG: Dict[str, Any] = dict(
    batch_size=16, learning_rate=0.0001, beta1=0.9, beta2=0.99, weight_decay=0.0, max_iters=1000000, milestones=[],
    loss_function="mse", bfloat16=False,
)


class _ResidualConvBlock(nn.Module):
    def __init__(self, channels: int) -> None:
        super().__init__()
        self.rcb = slots({"0": conv(channels, channels, bias=False), "1": BatchNorm(channels), "2": PReLU(),
                          "3": conv(channels, channels, bias=False), "4": BatchNorm(channels)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.rcb._modules
        return x + r["4"](r["3"](r["2"](r["1"](r["0"](x)))))


class SRResNetModule(nn.Module):
    def __init__(self, scale: int = 4, n_colors: int = 3, img_range: float = 1.0, channels: int = 64,
                 num_rcb: int = 16) -> None:
        super().__init__()
        if scale not in (2, 4, 8):
            raise NotImplementedError(f"scale `{scale}` is not supported.")
        self.normalizer = Normalizer(img_range)
        self.conv1 = slots({"0": conv(n_colors, channels, 9), "1": PReLU()})
        self.trunk = slots({str(i): _ResidualConvBlock(channels) for i in range(num_rcb)})
        self.conv2 = slots({"0": conv(channels, channels, bias=False), "1": BatchNorm(channels)})
        self.upsampling = slots({
            str(i): slots({"upsample_block": slots({"0": conv(channels, 4 * channels), "2": PReLU()})})
            for i in range(int(math.log2(scale)))
        })
        self.conv3 = conv(channels, n_colors, 9)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC forward; ``generator`` (the Trainer's draws) is unused: no layer is stochastic."""
        c1, c2 = self.conv1._modules, self.conv2._modules
        head = c1["1"](c1["0"](self.normalizer.normalize(x)))
        y = head
        for block in self.trunk.children():
            y = block(y)
        y = c2["1"](c2["0"](y)) + head
        for up in self.upsampling.children():
            u = up.upsample_block._modules
            y = u["2"](pixel_shuffle(u["0"](y), 2))
        return self.normalizer.unnormalize(self.conv3(y))


class SRResNet(Model):
    _training_config = _TRAINING_CONFIG

    @classmethod
    def build(cls, scale: int = 4, n_colors: int = 3, img_range: float = 1.0, channels: int = 64, num_rcb: int = 16,
              seed: int = 0, device=None) -> "SRResNet":
        """Seeded SRResNet on ``device`` (default ``cuda``), in eval mode."""
        dev = resolve_device(device)
        config = dict(scale=scale, n_colors=n_colors, img_range=img_range, channels=channels, num_rcb=num_rcb)
        module = SRResNetModule(**config)
        flax_default_init(module, torch.Generator().manual_seed(seed))
        return cls(module.to(dev).eval(), config, dev)
