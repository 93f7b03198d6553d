"""SwinIR — shifted-window transformer SR (NHWC, PyTorch, eval mode).

Port of ``studiosr_tpu/models/swinir.py``: conv_first -> RSTB groups (each a
stack of Swin blocks + conv + residual) -> conv_after_body -> upsampler;
classical ("pixelshuffle") and lightweight ("pixelshuffledirect") variants;
reflect padding in training mode vs flip-concat padding at eval.

Module names equal the flax paths (``layers.0.residual_group.blocks.1.attn``
...), so ``zoo/translate.py`` fills this module from a JAX params tree or an
exported torch state_dict by name. The shift mask and relative-position
index are numpy tables (``ops/windows.py``), recomputed rather than loaded.
Fused training and drop-path are not part of this port yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from studiosr_tpu_torch._device import resolve_device
from studiosr_tpu_torch.models.base import FusedServingModel
from studiosr_tpu_torch.models.blocks import LayerNorm, Mlp, Normalizer, Upsampler, conv
from studiosr_tpu_torch.ops.attention import attention_core
from studiosr_tpu_torch.ops.windows import (
    calculate_mask,
    gather_rel_bias,
    pad_to_multiple_flip,
    pad_to_multiple_reflect,
    relative_position_index,
    window_partition,
    window_reverse,
)

__all__ = ["SwinIR", "SwinIRModule", "WindowAttention", "SwinTransformerBlock", "RSTB"]


class WindowAttention(nn.Module):
    """Per-window MHA with a learned relative-position bias."""

    def __init__(self, dim: int, window_size: int, num_heads: int) -> None:
        super().__init__()
        self.window_size = window_size
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b_, n, c = x.shape
        heads = self.num_heads
        d = c // heads
        bias = gather_rel_bias(self.relative_position_bias_table, relative_position_index(self.window_size), heads)
        qkv = self.qkv(x).reshape(b_, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (d**-0.5), qkv[1], qkv[2]
        out = attention_core(q, k, v, bias=bias, mask=mask)
        return self.proj(out.transpose(1, 2).reshape(b_, n, c))


class SwinTransformerBlock(nn.Module):
    """LN -> (shifted) window attention -> LN -> MLP, both residual. (B, H, W, C)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, c = x.shape
        ws, ss = self.window_size, self.shift_size
        shortcut = x
        x = self.norm1(x)
        mask = None
        if ss > 0:
            x = torch.roll(x, (-ss, -ss), dims=(1, 2))
            mask = torch.from_numpy(calculate_mask((h, w), ws, ss)).to(x.device)
        windows = window_partition(x, ws).reshape(-1, ws * ws, c)
        windows = self.attn(windows, mask=mask)
        x = window_reverse(windows.reshape(-1, ws, ws, c), ws, h, w)
        if ss > 0:
            x = torch.roll(x, (ss, ss), dims=(1, 2))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class _ResidualGroup(nn.Module):
    def __init__(self, blocks: Sequence[nn.Module]) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RSTB(nn.Module):
    """Residual Swin Transformer Block group."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int, mlp_ratio: float = 4.0) -> None:
        super().__init__()
        self.residual_group = _ResidualGroup(
            [
                SwinTransformerBlock(dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2, mlp_ratio)
                for i in range(depth)
            ]
        )
        self.conv = conv(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x
        for blk in self.residual_group.blocks:
            res = blk(res)
        return self.conv(res) + x


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.norm = LayerNorm(dim)


class SwinIRModule(nn.Module):
    def __init__(
        self,
        scale: int = 4,
        n_colors: int = 3,
        img_range: float = 1.0,
        embed_dim: int = 180,
        depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
        num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6),
        window_size: int = 8,
        mlp_ratio: float = 2.0,
        upsampler: str = "pixelshuffle",
    ) -> None:
        super().__init__()
        self.scale = scale
        self.window_size = window_size
        self.upsampler = upsampler
        self.normalizer = Normalizer(img_range)
        self.conv_first = conv(n_colors, embed_dim)
        self.patch_embed = _PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            RSTB(embed_dim, depth, num_heads[i], window_size, mlp_ratio) for i, depth in enumerate(depths)
        )
        self.norm = LayerNorm(embed_dim)
        self.conv_after_body = conv(embed_dim, embed_dim)
        if upsampler == "pixelshuffle":
            self.conv_before_upsample = nn.ModuleList([conv(embed_dim, 64)])
            self.upsample = Upsampler(scale, 64)
            self.conv_last = conv(64, n_colors)
        elif upsampler == "pixelshuffledirect":
            self.upsample = Upsampler(scale, embed_dim, num_out_ch=n_colors)
        else:
            raise ValueError(f"unknown upsampler: {upsampler}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        pad = pad_to_multiple_reflect if self.training else pad_to_multiple_flip
        x = self.normalizer.normalize(pad(x, self.window_size))

        x = self.conv_first(x)
        shallow = x
        feats = self.patch_embed.norm(x)
        for layer in self.layers:
            feats = layer(feats)
        feats = self.norm(feats)
        x = self.conv_after_body(feats) + shallow

        if self.upsampler == "pixelshuffle":
            x = F.leaky_relu(self.conv_before_upsample[0](x), 0.01)
            x = self.conv_last(self.upsample(x))
        else:
            x = self.upsample(x)

        x = self.normalizer.unnormalize(x)
        return x[:, : h * self.scale, : w * self.scale, :]


def _init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init: truncated-normal (std 1/sqrt(fan_in)) dense and conv
    kernels with zero biases, as flax's lecun_normal; LayerNorm ones/zeros;
    rel-pos tables truncated normal with std 0.02."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                std = m.weight[0].numel() ** -0.5
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02, a=-0.04, b=0.04, generator=generator)


class SwinIR(FusedServingModel):
    def _fused_fns(self):
        from studiosr_tpu_torch.serving.swinir_fast import prepare_serving, swinir_fast_forward

        return swinir_fast_forward, prepare_serving

    @classmethod
    def build(
        cls,
        scale: int = 4,
        n_colors: int = 3,
        img_range: float = 1.0,
        embed_dim: int = 180,
        depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
        num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6),
        window_size: int = 8,
        mlp_ratio: float = 2.0,
        drop_rate: float = 0.0,
        drop_path_rate: float = 0.1,
        upsampler: str = "pixelshuffle",
        seed: int = 0,
        device=None,
    ) -> "SwinIR":
        """Seeded SwinIR on ``device`` (default ``cuda``; raises without it).

        ``drop_rate`` / ``drop_path_rate`` are kept in the config for parity
        with the JAX package's ``params.json``; eval mode applies neither."""
        dev = resolve_device(device)
        config = dict(
            scale=scale,
            n_colors=n_colors,
            img_range=img_range,
            embed_dim=embed_dim,
            depths=list(depths),
            num_heads=list(num_heads),
            window_size=window_size,
            mlp_ratio=mlp_ratio,
            drop_rate=drop_rate,
            drop_path_rate=drop_path_rate,
            upsampler=upsampler,
        )
        module = SwinIRModule(
            scale, n_colors, img_range, embed_dim, tuple(depths), tuple(num_heads), window_size, mlp_ratio, upsampler
        )
        _init_weights(module, torch.Generator().manual_seed(seed))
        return cls(module.to(dev).eval(), config, dev)
