"""HAN — Holistic Attention Network (NHWC, PyTorch).

Port of ``studiosr_tpu/models/han.py``: RCAN's trunk (``models/rcan.py``)
with a layer attention (LAM) over the stack of the ``n_resgroups + 1``
trunk outputs, newest first, and a channel-spatial attention (CSAM) on the
last, fused by two convs, then RCAN's tail. CSAM's gate is the reference's
3x3x3 Conv3d over the (C, H, W) volume (its parameter ``csa.conv.weight``
(1, 1, 3, 3, 3), OIDHW); it is computed, as the JAX package's default
``CSAM_IMPL = "banded"`` does (``studiosr_tpu/models/han.py:63-110``), as
one 2-D 3x3 conv whose (C, C) weight carries the kernel's channel taps on
three diagonals: a plain cuDNN conv, the same sums.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from studiosr_tpu_torch._device import resolve_device
from studiosr_tpu_torch.models.base import Model
from studiosr_tpu_torch.models.blocks import Upsampler, conv, flax_default_init, mean_shift, slots
from studiosr_tpu_torch.models.rcan import _TRAINING_CONFIG, ResidualGroup

__all__ = ["HAN", "HANModule", "LAM", "CSAM", "banded_csam_weight"]


class LAM(nn.Module):
    """Layer attention over the (B, N, H, W, C) stack: energy = <layer_i,
    layer_j>, softmax of rowmax - energy, the stack re-mixed and blended by
    ``gamma``."""

    def __init__(self) -> None:
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, stack: torch.Tensor) -> torch.Tensor:
        b, n = stack.shape[:2]
        flat = stack.reshape(b, n, -1)
        energy = torch.bmm(flat, flat.transpose(1, 2))
        energy = energy.amax(dim=-1, keepdim=True) - energy
        out = torch.bmm(torch.softmax(energy, dim=-1), flat).reshape(stack.shape)
        return self.gamma.to(stack.dtype) * out + stack


def banded_csam_weight(kernel: torch.Tensor, c: int) -> torch.Tensor:
    """The (C, C, 3, 3) OIHW weight of the 2-D conv that computes the 3x3x3
    single-channel conv ``kernel`` (kc, kh, kw) over the channel axis:
    out[co] += kernel[kc, kh, kw] x[ci] where ci = co + kc - 1."""
    i = torch.arange(c, device=kernel.device)
    band = torch.stack([(i[:, None] == i[None, :] + kc - 1) for kc in range(3)]).to(kernel.dtype)  # [kc, ci, co]
    return torch.einsum("khw,kio->oihw", kernel, band)


class CSAM(nn.Module):
    """Channel-spatial attention: x + x * gamma * sigmoid(conv3d(x))."""

    def __init__(self) -> None:
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))
        self.conv = nn.Conv3d(1, 1, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = banded_csam_weight(self.conv.weight[0, 0].to(x.dtype), x.shape[-1])
        gate = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1) + self.conv.bias.to(x.dtype)
        return x * (torch.sigmoid(gate) * self.gamma.to(x.dtype)) + x


class HANModule(nn.Module):
    def __init__(self, scale: int = 4, n_colors: int = 3, img_range: float = 1.0, n_feats: int = 64,
                 n_resblocks: int = 20, n_resgroups: int = 10, reduction: int = 16) -> None:
        super().__init__()
        self.img_range, self.n_resgroups = img_range, n_resgroups
        self.head = slots({"0": conv(n_colors, n_feats)})
        body = {str(g): ResidualGroup(n_feats, 3, reduction, n_resblocks) for g in range(n_resgroups)}
        body[str(n_resgroups)] = conv(n_feats, n_feats)
        self.body = slots(body)
        self.la = LAM()
        self.last_conv = conv((n_resgroups + 1) * n_feats, n_feats)
        self.csa = CSAM()
        self.last = conv(2 * n_feats, n_feats)
        self.tail = slots({"0": Upsampler(scale, n_feats), "1": conv(n_feats, n_colors)})

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC forward; ``generator`` (the Trainer's draws) is unused: no layer is stochastic."""
        x = self.head._modules["0"](mean_shift(x, self.img_range, sign=-1))
        res, collected = x, []
        for block in self.body.children():
            res = block(res)
            collected.append(res)
        # newest first, as the reference prepends each output: the fusion
        # conv's input channels are layer-major in that order
        mixed = self.la(torch.stack(collected[::-1], dim=1))
        b, n, h, w, c = mixed.shape
        out2 = self.last_conv(mixed.permute(0, 2, 3, 1, 4).reshape(b, h, w, n * c))
        res = self.last(torch.cat([self.csa(res), out2], dim=-1)) + x
        tail = self.tail._modules
        return mean_shift(tail["1"](tail["0"](res)), self.img_range, sign=1)


class HAN(Model):
    _training_config = _TRAINING_CONFIG

    @classmethod
    def build(cls, scale: int = 4, n_colors: int = 3, img_range: float = 1.0, n_feats: int = 64,
              n_resblocks: int = 20, n_resgroups: int = 10, reduction: int = 16, seed: int = 0,
              device=None) -> "HAN":
        """Seeded HAN on ``device`` (default ``cuda``), in eval mode."""
        dev = resolve_device(device)
        config = dict(scale=scale, n_colors=n_colors, img_range=img_range, n_feats=n_feats, n_resblocks=n_resblocks,
                      n_resgroups=n_resgroups, reduction=reduction)
        module = HANModule(**config)
        flax_default_init(module, torch.Generator().manual_seed(seed))
        return cls(module.to(dev).eval(), config, dev)
