"""SwinIR — shifted-window transformer SR (NHWC, PyTorch).

Port of ``studiosr_tpu/models/swinir.py``: conv_first -> RSTB groups (each a
stack of Swin blocks + conv + residual) -> conv_after_body -> upsampler;
classical ("pixelshuffle") and lightweight ("pixelshuffledirect") variants;
reflect padding in training mode vs flip-concat padding at eval.

Module names equal the flax paths (``layers.0.residual_group.blocks.1.attn``
...), so ``zoo/translate.py`` fills this module from a JAX params tree or an
exported torch state_dict by name. The shift mask and relative-position
index are numpy tables (``ops/windows.py``), recomputed rather than loaded.

Training mode (``module.train()``) applies stochastic depth to both
residual halves of every Swin block, with rates
``np.linspace(0, drop_path_rate, sum(depths))``; each block draws its (B, 2)
keep scales from the ``generator`` handed to ``forward``. ``fused_train``
routes every Swin block through the custom-autograd fused halves
(``ops/attn_vjp.py`` over B5/B8, ``ops/mlp_vjp.py`` over B6/B7) with the
same parameters and the same scales; it requires ``drop_rate == 0``.
``drop_rate > 0`` applies dropout in training mode after the patch
embedding's LayerNorm and in every block's MLP (after the GELU and after
fc2), in plain autograd, its draws seeded from the same ``generator``.

``resi_connection`` and ``conv_after_body`` (``studiosr_tpu/models/swinir.py``
hooks) take a factory ``f(dim) -> nn.Module`` for each RSTB's residual conv
and the conv after the body; SwinFIR passes its SFB. Without them both are
3x3 convs, under the same parameter names.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from studiosr_tpu_torch._device import resolve_device
from studiosr_tpu_torch.models.base import FusedServingModel
from studiosr_tpu_torch.models.blocks import LayerNorm, Mlp, Normalizer, Upsampler, conv, drop_path_scales, dropout
from studiosr_tpu_torch.ops.attention import attention_core
from studiosr_tpu_torch.ops.attn_vjp import attention_map_vjp
from studiosr_tpu_torch.ops.mlp_vjp import mlp_block_dp_vjp
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
    """LN -> (shifted) window attention -> LN -> MLP, both residual. (B, H, W, C).

    In training mode with ``drop_path > 0`` each residual delta is scaled per
    sample by keep bits / keep (columns 0 and 1 of one (B, 2) draw), on the
    plain and the fused path alike."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        window_size: int,
        shift_size: int = 0,
        mlp_ratio: float = 4.0,
        drop_path: float = 0.0,
        drop: float = 0.0,
    ):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.drop_path = drop_path
        self.fused_train = False
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=drop)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, ss = self.window_size, self.shift_size
        scales = None
        if self.training and self.drop_path > 0.0:
            scales = drop_path_scales(b, self.drop_path, generator, x.device, n=2)
        if self.fused_train:
            return self._fused(x, scales)
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
        if scales is not None:
            x = x * scales[:, 0].reshape(-1, 1, 1, 1).to(x.dtype)
        x = shortcut + x
        y = self.mlp(self.norm2(x), generator)
        if scales is not None:
            y = y * scales[:, 1].reshape(-1, 1, 1, 1).to(y.dtype)
        return x + y

    def _fused(self, x: torch.Tensor, scales: Optional[torch.Tensor]) -> torch.Tensor:
        b, h, w, c = x.shape
        a = self.attn
        bias = gather_rel_bias(a.relative_position_bias_table, relative_position_index(self.window_size), a.num_heads)
        x = attention_map_vjp(
            x, self.norm1.weight, self.norm1.bias, a.qkv.weight.t(), a.qkv.bias, a.proj.weight.t(), a.proj.bias,
            bias, None if scales is None else scales[:, 0].contiguous(), self.shift_size, a.num_heads,
            self.window_size,
        )
        y = mlp_block_dp_vjp(
            x.reshape(b * h * w, c), self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight.t(), self.mlp.fc1.bias,
            self.mlp.fc2.weight.t(), self.mlp.fc2.bias, None if scales is None else scales[:, 1].contiguous(), h * w,
        )
        return y.reshape(b, h, w, c)


class _ResidualGroup(nn.Module):
    def __init__(self, blocks: Sequence[nn.Module]) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RSTB(nn.Module):
    """Residual Swin Transformer Block group."""

    def __init__(
        self,
        dim: int,
        depth: int,
        num_heads: int,
        window_size: int,
        mlp_ratio: float = 4.0,
        drop_path: Sequence[float] = (),
        resi_connection: Optional[Callable[[int], nn.Module]] = None,
        drop: float = 0.0,
    ) -> None:
        super().__init__()
        self.residual_group = _ResidualGroup(
            [
                SwinTransformerBlock(
                    dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                    drop_path[i] if drop_path else 0.0, drop,
                )
                for i in range(depth)
            ]
        )
        self.conv = resi_connection(dim) if resi_connection is not None else conv(dim, dim)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        res = x
        for blk in self.residual_group.blocks:
            res = blk(res, generator)
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
        drop_rate: float = 0.0,
        drop_path_rate: float = 0.0,
        fused_train: bool = False,
        resi_connection: Optional[Callable[[int], nn.Module]] = None,
        conv_after_body: Optional[Callable[[int], nn.Module]] = None,
    ) -> None:
        super().__init__()
        self.scale = scale
        self.window_size = window_size
        self.upsampler = upsampler
        self.drop_rate = drop_rate
        self.normalizer = Normalizer(img_range)
        self.conv_first = conv(n_colors, embed_dim)
        self.patch_embed = _PatchEmbed(embed_dim)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList(
            RSTB(embed_dim, depth, num_heads[i], window_size, mlp_ratio, dpr[sum(depths[:i]) : sum(depths[: i + 1])],
                 resi_connection, drop_rate)
            for i, depth in enumerate(depths)
        )
        self.norm = LayerNorm(embed_dim)
        self.conv_after_body = conv_after_body(embed_dim) if conv_after_body is not None else conv(embed_dim, embed_dim)
        if upsampler == "pixelshuffle":
            self.conv_before_upsample = nn.ModuleList([conv(embed_dim, 64)])
            self.upsample = Upsampler(scale, 64)
            self.conv_last = conv(64, n_colors)
        elif upsampler == "pixelshuffledirect":
            self.upsample = Upsampler(scale, embed_dim, num_out_ch=n_colors)
        else:
            raise ValueError(f"unknown upsampler: {upsampler}")
        self.fused_train = fused_train

    @property
    def fused_train(self) -> bool:
        """Route the Swin blocks through the fused custom-autograd halves."""
        return self._fused_train

    @fused_train.setter
    def fused_train(self, enabled: bool) -> None:
        if enabled and self.drop_rate:
            raise NotImplementedError("fused_train requires drop==0")
        self._fused_train = bool(enabled)
        for layer in self.layers:
            for blk in layer.residual_group.blocks:
                blk.fused_train = self._fused_train

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC forward; ``generator`` feeds the drop-path and dropout draws in training mode."""
        h, w = x.shape[1:3]
        pad = pad_to_multiple_reflect if self.training else pad_to_multiple_flip
        x = self.normalizer.normalize(pad(x, self.window_size))

        x = self.conv_first(x)
        shallow = x
        feats = dropout(self.patch_embed.norm(x), self.drop_rate, self.training, generator)
        for layer in self.layers:
            feats = layer(feats, generator)
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


_TRAINING_CONFIG: Dict[str, Any] = dict(
    batch_size=32,
    learning_rate=0.0002,
    beta1=0.9,
    beta2=0.99,
    weight_decay=0.0,
    max_iters=500000,
    gamma=0.5,
    milestones=[250000, 400000, 450000, 475000],
)


class SwinIR(FusedServingModel):
    _training_config = _TRAINING_CONFIG

    @classmethod
    def _module_hooks(cls) -> Dict[str, Any]:
        """SwinIRModule's ``resi_connection`` / ``conv_after_body`` factories."""
        return {}

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
        fused_train: bool = False,
    ) -> "SwinIR":
        """Seeded SwinIR on ``device`` (default ``cuda``; raises without it),
        in eval mode. ``drop_path_rate`` applies in training mode only."""
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
            scale, n_colors, img_range, embed_dim, tuple(depths), tuple(num_heads), window_size, mlp_ratio, upsampler,
            drop_rate, drop_path_rate, fused_train, **cls._module_hooks(),
        )
        _init_weights(module, torch.Generator().manual_seed(seed))
        return cls(module.to(dev).eval(), config, dev)
