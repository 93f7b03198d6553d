"""Shared NHWC building blocks (subset), PyTorch.

Port of ``studiosr_tpu/models/blocks.py``. Modules carry the same names as
the flax paths, which are the reference checkpoints' torch key prefixes
(``upsample.0``, ``conv_before_upsample.0`` ...), so a state_dict key here
is the joined flax path with torch leaf names.

* GELU is the exact (erf) variant.
* LayerNorm eps is 1e-5.
* Convolutions store torch OIHW weights and take NHWC activations: the input
  is handed to ``F.conv2d`` as a channels-last view (``permute(0, 3, 1, 2)``).
* BatchNorm follows flax's ``nn.BatchNorm`` (the JAX package's
  ``BatchNorm``): statistics in f32, the biased batch variance for both the
  normalisation and the running update, momentum 0.1 in torch's convention
  (flax's 0.9), eps 1e-5.
* The conv families' pieces (``mean_shift``, ``ResBlock``,
  ``ChannelAttention``, ``PReLU``) keep the flax names (``body.0``,
  ``conv_du.2``) and run on ``torch.nn.functional``'s convolutions
  (cuDNN on the card), as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from studiosr_tpu_torch.ops.pixel_shuffle import pixel_shuffle

__all__ = [
    "DEFAULT_RGB_MEAN",
    "Normalizer",
    "Conv",
    "conv",
    "BatchNorm",
    "slots",
    "gelu",
    "LayerNorm",
    "Mlp",
    "Upsampler",
    "drop_path_scales",
    "drop_path",
    "dropout",
    "DropPath",
    "mean_shift",
    "ResBlock",
    "ChannelAttention",
    "PReLU",
    "flax_default_init",
]

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
    """NHWC conv with torch-style ``k//2`` zero padding (OIHW weights);
    ``groups=features`` makes it depthwise."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3, groups: int = 1,
                 bias: bool = True) -> None:
        super().__init__(in_features, features, kernel_size, padding=kernel_size // 2, groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def conv(in_features: int, features: int, kernel_size: int = 3, groups: int = 1, bias: bool = True) -> Conv:
    return Conv(in_features, features, kernel_size, groups, bias)


def mean_shift(x: torch.Tensor, img_range: float, sign: int = -1, rgb_mean=DEFAULT_RGB_MEAN,
               rgb_std=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """The frozen 1x1 MeanShift conv as its affine map, x / std + sign *
    range * mean / std, in ``x.dtype``."""
    std = torch.tensor(rgb_std, dtype=x.dtype, device=x.device)
    mean = torch.tensor(rgb_mean, dtype=x.dtype, device=x.device)
    return x / std + sign * img_range * mean / std


class ResBlock(nn.Module):
    """conv-ReLU-conv with the residual scaled: x + res_scale * body(x)."""

    def __init__(self, n_feats: int, kernel_size: int = 3, res_scale: float = 1.0) -> None:
        super().__init__()
        self.res_scale = res_scale
        self.body = slots({"0": conv(n_feats, n_feats, kernel_size), "2": conv(n_feats, n_feats, kernel_size)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        body = self.body._modules
        return x + body["2"](F.relu(body["0"](x))) * self.res_scale


class ChannelAttention(nn.Module):
    """Squeeze-excite gate: mean pool, 1x1 squeeze conv, ReLU, 1x1 excite
    conv, sigmoid, times x."""

    def __init__(self, channel: int, reduction: int = 16) -> None:
        super().__init__()
        self.conv_du = slots({"0": conv(channel, channel // reduction, 1), "2": conv(channel // reduction, channel, 1)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        du = self.conv_du._modules
        return x * torch.sigmoid(du["2"](F.relu(du["0"](x.mean(dim=(1, 2), keepdim=True)))))


class PReLU(nn.PReLU):
    """``nn.PReLU`` (its ``weight``, init 0.25) on an NHWC map: one slope, or
    one a channel along the last axis; x where x >= 0, else slope * x."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


def slots(modules: Dict[str, nn.Module]) -> nn.Module:
    """A parameter holder whose children carry ``modules``' names, for the
    torch ``Sequential`` index paths (``fn.0``, ``to_out.0`` ...) of modules
    that are called one by one."""
    holder = nn.Module()
    for name, module in modules.items():
        holder.add_module(name, module)
    return holder


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over the channels of an NHWC map with flax's arithmetic.

    Training mode normalises with the batch mean and the biased batch
    variance, E[x^2] - E[x]^2 clipped at 0, in f32, and moves the running
    statistics by 0.1 towards them (torch's own BatchNorm2d moves
    ``running_var`` towards the unbiased variance); eval mode uses the
    running statistics. The output has the input's dtype."""

    def __init__(self, features: int) -> None:
        super().__init__(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 1, 2))
            var = torch.clamp(torch.square(xf).mean(dim=(0, 1, 2)) - torch.square(mean), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean.detach().to(self.running_mean.dtype), alpha=m)
                self.running_var.mul_(1.0 - m).add_(var.detach().to(self.running_var.dtype), alpha=m)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.float()) + self.bias.float()
        return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) GELU."""
    return F.gelu(x)


def LayerNorm(features: int) -> nn.LayerNorm:
    """LayerNorm with torch eps (the flax port sets the same 1e-5)."""
    return nn.LayerNorm(features, eps=1e-5)


class Mlp(nn.Module):
    """Linear-GELU-Linear feed-forward; in training mode ``drop`` applies
    dropout after the GELU and after fc2, as the reference's ``Mlp``."""

    def __init__(
        self, in_features: int, hidden_features: Optional[int] = None, out_features: Optional[int] = None,
        drop: float = 0.0,
    ):
        super().__init__()
        hidden = hidden_features or in_features
        out = out_features or in_features
        self.drop = drop
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(gelu(self.fc1(x)), self.drop, self.training, generator)
        return dropout(self.fc2(x), self.drop, self.training, generator)


def dropout(
    x: torch.Tensor, rate: float, training: bool, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Element-wise dropout (flax ``nn.Dropout``): each element kept with
    probability 1 - rate and divided by it, the rest zero; the identity out
    of training mode or at rate 0. The bits are drawn on ``x``'s device from
    a generator seeded by one draw of ``generator`` (the step's explicit
    generator; the global one when None), so a step's draws are a function
    of its generator's seed."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    bits = torch.rand(x.shape, generator=torch.Generator(device=x.device).manual_seed(seed), device=x.device) < keep
    return torch.where(bits, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path_scales(
    batch: int, rate: float, generator: Optional[torch.Generator] = None, device=None, n: int = 1
) -> torch.Tensor:
    """(batch, n) f32 stochastic-depth scales: Bernoulli(1 - rate) keep bits
    divided by 1 - rate, drawn on the CPU from ``generator`` (the global
    generator when None) and moved to ``device``."""
    keep = 1.0 - rate
    bits = torch.rand((batch, n), generator=generator) < keep
    return (bits.float() / keep).to(device)


def drop_path(
    x: torch.Tensor, rate: float, training: bool, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Stochastic depth on the leading (batch) axis (timm DropPath analog)."""
    if not training or rate == 0.0:
        return x
    scales = drop_path_scales(x.shape[0], rate, generator, x.device)
    return x * scales.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)


class DropPath(nn.Module):
    """Module wrapper for :func:`drop_path`; active in training mode."""

    def __init__(self, rate: float = 0.0) -> None:
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return drop_path(x, self.rate, self.training, generator)


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


def flax_default_init(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init as flax's defaults, the JAX ``build``'s: lecun-normal conv
    and dense kernels (a normal truncated at two standard deviations, scaled
    to variance 1 / fan_in) with zero biases; norms ones / zeros. PReLU keeps
    its 0.25."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
                std = m.weight[0].numel() ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
