"""IMDN — information multi-distillation network (NHWC, PyTorch).

Port of ``studiosr_tpu/models/imdn.py``: a head conv, ``n_modules`` IMD
modules (three distill / remain channel splits with LeakyReLU 0.05, a
fourth conv, contrast-aware channel attention, a 1x1 fusion, the residual),
a 1x1 fusion of all module outputs, a conv joined to the head, and a
PixelShuffle tail. No mean normalisation, as in the reference. Module names
are the flax paths (``fea_conv``, ``IMDB{i}.c{1..5}``, ``IMDB{i}.cca``,
``c.0``, ``LR_conv``, ``upsampler.0``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from studiosr_tpu_torch._device import resolve_device
from studiosr_tpu_torch.models.base import Model
from studiosr_tpu_torch.models.blocks import conv, flax_default_init, slots
from studiosr_tpu_torch.ops.pixel_shuffle import pixel_shuffle

__all__ = ["IMDN", "IMDNModule", "CCALayer", "IMDModule"]


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.05)


class CCALayer(nn.Module):
    """Contrast-aware channel attention: the gate of (spatial std + mean)."""

    def __init__(self, channel: int, reduction: int = 16) -> None:
        super().__init__()
        self.conv_du = slots({"0": conv(channel, channel // reduction, 1), "2": conv(channel // reduction, channel, 1)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(1, 2), keepdim=True)
        y = torch.sqrt((x - mean).square().mean(dim=(1, 2), keepdim=True)) + mean
        du = self.conv_du._modules
        return x * torch.sigmoid(du["2"](F.relu(du["0"](y))))


class IMDModule(nn.Module):
    def __init__(self, in_channels: int, distillation_rate: float = 0.25) -> None:
        super().__init__()
        self.dc = dc = int(in_channels * distillation_rate)
        rc = in_channels - dc
        self.c1, self.c2, self.c3 = conv(in_channels, in_channels), conv(rc, in_channels), conv(rc, in_channels)
        self.c4 = conv(rc, dc)
        self.cca = CCALayer(4 * dc)
        self.c5 = conv(4 * dc, in_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dc = self.dc
        out1 = _lrelu(self.c1(x))
        out2 = _lrelu(self.c2(out1[..., dc:]))
        out3 = _lrelu(self.c3(out2[..., dc:]))
        out = torch.cat([out1[..., :dc], out2[..., :dc], out3[..., :dc], self.c4(out3[..., dc:])], dim=-1)
        return self.c5(self.cca(out)) + x


class IMDNModule(nn.Module):
    def __init__(self, scale: int = 4, n_colors: int = 3, img_range: float = 1.0, n_feats: int = 64,
                 n_modules: int = 6) -> None:
        super().__init__()
        self.scale = scale
        self.fea_conv = conv(n_colors, n_feats)
        for i in range(n_modules):
            self.add_module(f"IMDB{i + 1}", IMDModule(n_feats))
        self.n_modules = n_modules
        self.c = slots({"0": conv(n_modules * n_feats, n_feats, 1)})
        self.LR_conv = conv(n_feats, n_feats)
        self.upsampler = slots({"0": conv(n_feats, n_colors * scale**2)})

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC forward; ``generator`` (the Trainer's draws) is unused: no layer is stochastic."""
        fea = self.fea_conv(x)
        outputs, h = [], fea
        for i in range(self.n_modules):
            h = self._modules[f"IMDB{i + 1}"](h)
            outputs.append(h)
        out = self.LR_conv(_lrelu(self.c._modules["0"](torch.cat(outputs, dim=-1)))) + fea
        return pixel_shuffle(self.upsampler._modules["0"](out), self.scale)


class IMDN(Model):
    @classmethod
    def build(cls, scale: int = 4, n_colors: int = 3, img_range: float = 1.0, n_feats: int = 64, n_modules: int = 6,
              seed: int = 0, device=None) -> "IMDN":
        """Seeded IMDN on ``device`` (default ``cuda``), in eval mode."""
        dev = resolve_device(device)
        config = dict(scale=scale, n_colors=n_colors, img_range=img_range, n_feats=n_feats, n_modules=n_modules)
        module = IMDNModule(**config)
        flax_default_init(module, torch.Generator().manual_seed(seed))
        return cls(module.to(dev).eval(), config, dev)

    @classmethod
    def from_pretrained(cls, scale: int = 4, device=None) -> "IMDN":
        """The published ``IMDN_x{scale}`` checkpoints (x2, x3, x4) from
        ``./pretrained`` (downloaded there on first use), their ``module.``
        prefixes stripped, every parameter required."""
        from studiosr_tpu_torch.zoo import fetch, load_torch_state_dict, translate_state_dict

        if scale not in (2, 3, 4):
            raise ValueError(f"IMDN.from_pretrained: no release at scale {scale}")
        model = cls.build(scale=scale, device=device)
        path = fetch(f"IMDN_x{scale}.pth",
                     url=f"https://github.com/Zheng222/IMDN/raw/master/checkpoints/IMDN_x{scale}.pth")
        translate_state_dict(load_torch_state_dict(path), model.module)
        return model
