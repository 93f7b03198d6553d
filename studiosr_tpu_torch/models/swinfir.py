"""SwinFIR — SwinIR with Spatial-Frequency residual blocks (NHWC, PyTorch).

Port of ``studiosr_tpu/models/swinfir.py``: every RSTB's residual conv and
the ``conv_after_body`` are an SFB, a spatial branch (conv-LeakyReLU(0.2)-
conv + skip) beside a spectral branch (1x1 conv, LeakyReLU, rfft2 -> 1x1
conv on the stacked (re | im) channels -> irfft2, skip, 1x1 conv), fused by
a 1x1 conv over their concatenation. Module names are the flax paths
(``layers.0.conv.S.body.0``, ``conv_after_body.F.fu.conv_layer`` ...).

The transforms are ``torch.fft.rfftn`` / ``irfftn`` over H and W with
``norm="ortho"``, computed in f32 whatever the map's dtype (cuFFT has no
bf16 transform; the JAX package's CPU route also transforms in f32), their
results rounded to the map's dtype. The spectrum's channels are stacked as
[re | im], the order the weight bridge cannot check (it maps
``fu.conv_layer`` by name): a swapped order loads and computes another
function.

Serving (``enable_fused``) runs each SFB's spatial branch through B14
(``ops/cuda/conv3x3.py::fused_resblock``) and the Swin blocks and tail
through SwinIR's kernels (``serving/swinir_fast.py``); training with
``fused_train`` runs the Swin blocks through B5-B8 and the SFBs in plain
autograd. The recipe trains in f32 (``bfloat16=False``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from studiosr_tpu_torch.models.blocks import conv, slots
from studiosr_tpu_torch.models.swinir import SwinIR

__all__ = ["SwinFIR", "SFB", "FourierUnit", "SpectralTransform", "SpatialB", "spectrum_channels", "spectrum_map"]


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def spectrum_channels(x: torch.Tensor) -> torch.Tensor:
    """rfft2 over H, W (ortho, in f32) of an NHWC map, as [re | im]
    channels in ``x.dtype``: (B, H, W // 2 + 1, 2C)."""
    fft = torch.fft.rfftn(x.float(), dim=(1, 2), norm="ortho")
    return torch.cat([fft.real, fft.imag], dim=-1).to(x.dtype)


def spectrum_map(stacked: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The inverse of :func:`spectrum_channels`: [re | im] channels ->
    irfft2 (ortho, in f32) of size (h, w), in ``stacked.dtype``."""
    re, im = stacked.float().chunk(2, dim=-1)
    return torch.fft.irfftn(torch.complex(re, im), s=(h, w), dim=(1, 2), norm="ortho").to(stacked.dtype)


class FourierUnit(nn.Module):
    """rfft2 -> 1x1 conv on [re | im] -> LeakyReLU(0.2) -> irfft2."""

    def __init__(self, embed_dim: int) -> None:
        super().__init__()
        self.conv_layer = conv(2 * embed_dim, 2 * embed_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        return spectrum_map(_lrelu(self.conv_layer(spectrum_channels(x))), h, w)


class SpectralTransform(nn.Module):
    def __init__(self, embed_dim: int) -> None:
        super().__init__()
        self.conv_before_fft = slots({"0": conv(embed_dim, embed_dim // 2, 1)})
        self.fu = FourierUnit(embed_dim // 2)
        self.conv_after_fft = conv(embed_dim // 2, embed_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _lrelu(self.conv_before_fft._modules["0"](x))
        return self.conv_after_fft(self.fu(x) + x)


class SpatialB(nn.Module):
    def __init__(self, embed_dim: int) -> None:
        super().__init__()
        self.body = slots({"0": conv(embed_dim, embed_dim), "2": conv(embed_dim, embed_dim)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body._modules["2"](_lrelu(self.body._modules["0"](x))) + x


class SFB(nn.Module):
    """Spatial branch || spectral branch -> concat -> 1x1 fusion."""

    def __init__(self, embed_dim: int) -> None:
        super().__init__()
        self.S = SpatialB(embed_dim)
        self.F = SpectralTransform(embed_dim)
        self.fusion = conv(2 * embed_dim, embed_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fusion(torch.cat([self.S(x), self.F(x)], dim=-1))


_TRAINING_CONFIG: Dict[str, Any] = dict(
    batch_size=32,
    learning_rate=0.0002,
    beta1=0.9,
    beta2=0.99,
    weight_decay=0.0,
    max_iters=500000,
    gamma=0.5,
    milestones=[250000, 400000, 450000, 475000],
    bfloat16=False,
)


class SwinFIR(SwinIR):
    """``SwinIR.build``'s arguments and config; the SFBs replace the convs."""

    _training_config = _TRAINING_CONFIG

    @classmethod
    def _module_hooks(cls) -> Dict[str, Any]:
        return {"resi_connection": SFB, "conv_after_body": SFB}

    @classmethod
    def from_pretrained(cls, *args, **kwargs) -> "SwinFIR":
        """No public SwinFIR release checkpoints exist (as in the JAX package)."""
        raise NotImplementedError(
            "SwinFIR has no published pretrained checkpoints. Train one with "
            "studiosr_tpu_torch.Trainer (SwinFIR.build().get_training_config()), or "
            "load a trained checkpoint directory with zoo.load_model."
        )
