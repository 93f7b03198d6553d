"""HAT — Hybrid Attention Transformer (NHWC, PyTorch).

Port of ``studiosr_tpu/models/hat.py``: conv_first -> RHAG groups (each a
stack of HABs, shifted-window attention plus a parallel conv
channel-attention branch scaled by ``conv_scale``, capped by an Overlapping
Cross-Attention Block) -> conv_after_body -> pixelshuffle upsampler. The
input is reflect-padded to a window multiple in both modes.

Module names equal the flax paths (``layers.0.residual_group.blocks.1.
conv_block.cab.3.attention.1``, ``layers.0.residual_group.overlap_attn.qkv``
...), so ``zoo/translate.py`` fills this module from a JAX params tree or
an exported torch state_dict by name.

The OCAB's overlapping key/value windows come from the zero-padded
*projected* kv map (``unfold`` of the padded map): out-of-image keys and
values are zero, so their logits are the bias alone; they are not masked.

Training mode applies stochastic depth to both residual halves of every
HAB, as SwinIR's port does, and ``drop_rate`` dropout after the patch
embedding's LayerNorm (the reference's HAB and OCAB MLPs take no dropout),
in plain autograd; ``fused_train`` (``studiosr_tpu/models/hat.py``
HAB / OCAB ``fused_train``) routes each HAB's attention half through
``attention_map_vjp`` (B5 forward, B8 / B9 backward) and its MLP half
through ``mlp_block_dp_vjp`` (B6, B7), and each OCAB's attention core
through ``oca_attention`` (B12, B13); the CAB branch, the OCAB's LayerNorms,
projections, unfold and MLP stay plain autograd, as in JAX. The parameters
are the same either way.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from studiosr_tpu_torch._device import resolve_device
from studiosr_tpu_torch.models.base import FusedServingModel
from studiosr_tpu_torch.models.blocks import (
    LayerNorm, Mlp, Normalizer, Upsampler, conv, drop_path_scales, dropout, gelu,
)
from studiosr_tpu_torch.models.swinir import _TRAINING_CONFIG, WindowAttention, _init_weights
from studiosr_tpu_torch.ops.attention import attention_core
from studiosr_tpu_torch.ops.attn_vjp import attention_map_vjp
from studiosr_tpu_torch.ops.cuda.ocab import overlap_window
from studiosr_tpu_torch.ops.mlp_vjp import mlp_block_dp_vjp
from studiosr_tpu_torch.ops.oca_vjp import oca_attention
from studiosr_tpu_torch.ops.windows import (
    calculate_mask,
    gather_rel_bias,
    pad_to_multiple_reflect,
    relative_position_index,
    relative_position_index_oca,
    window_partition,
    window_reverse,
)

__all__ = ["HAT", "HATModule", "HAB", "OCAB", "RHAG", "CAB", "ChannelAttentionHAT"]


class _Named(nn.Module):
    """A container whose children carry the given (numeric) names."""

    def __init__(self, **children: nn.Module) -> None:
        super().__init__()
        for name, child in children.items():
            self.add_module(name.lstrip("_"), child)


class ChannelAttentionHAT(nn.Module):
    """Squeeze-excite: x * sigmoid(conv(relu(conv(mean_hw x)))), with the
    convs named ``attention.1`` and ``attention.3``."""

    def __init__(self, num_feat: int, squeeze_factor: int = 16) -> None:
        super().__init__()
        self.attention = _Named(_1=conv(num_feat, num_feat // squeeze_factor, 1),
                                _3=conv(num_feat // squeeze_factor, num_feat, 1))

    def gate(self, mean: torch.Tensor) -> torch.Tensor:
        """(B, 1, 1, C) channel means -> (B, 1, 1, C) gate."""
        a = self.attention._modules
        return torch.sigmoid(a["3"](torch.relu(a["1"](mean))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gate(x.mean(dim=(1, 2), keepdim=True))


class CAB(nn.Module):
    """conv-GELU-conv + channel attention (``cab.0``, ``cab.2``, ``cab.3``)."""

    def __init__(self, num_feat: int, compress_ratio: int = 3, squeeze_factor: int = 30) -> None:
        super().__init__()
        mid = num_feat // compress_ratio
        self.cab = _Named(_0=conv(num_feat, mid), _2=conv(mid, num_feat),
                          _3=ChannelAttentionHAT(num_feat, squeeze_factor))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.cab._modules
        return m["3"](m["2"](gelu(m["0"](x))))


class HAB(nn.Module):
    """Hybrid attention block: LN -> (shifted) window attention + 0.01-scaled
    CAB branch, then LN -> MLP, both residual. (B, H, W, C)."""

    def __init__(
        self, dim: int, num_heads: int, window_size: int, shift_size: int = 0, mlp_ratio: float = 2.0,
        compress_ratio: int = 3, squeeze_factor: int = 30, conv_scale: float = 0.01, drop_path: float = 0.0,
    ) -> None:
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.conv_scale = conv_scale
        self.drop_path = drop_path
        self.fused_train = False
        self.norm1 = LayerNorm(dim)
        self.conv_block = CAB(dim, compress_ratio, squeeze_factor)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

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
        conv_x = self.conv_block(x)
        mask = None
        if ss > 0:
            x = torch.roll(x, (-ss, -ss), dims=(1, 2))
            mask = torch.from_numpy(calculate_mask((h, w), ws, ss)).to(x.device)
        windows = self.attn(window_partition(x, ws).reshape(-1, ws * ws, c), mask=mask)
        attn_x = window_reverse(windows.reshape(-1, ws, ws, c), ws, h, w)
        if ss > 0:
            attn_x = torch.roll(attn_x, (ss, ss), dims=(1, 2))
        if scales is not None:
            attn_x = attn_x * scales[:, 0].reshape(-1, 1, 1, 1).to(attn_x.dtype)
        x = shortcut + attn_x + conv_x * self.conv_scale
        y = self.mlp(self.norm2(x))
        if scales is not None:
            y = y * scales[:, 1].reshape(-1, 1, 1, 1).to(y.dtype)
        return x + y

    def _fused(self, x: torch.Tensor, scales: Optional[torch.Tensor]) -> torch.Tensor:
        """The JAX fused HAB: LN1 in f32 (cast to the map's dtype) feeds the
        CAB; B5 / B8-B9 compute x + d_0 proj(WA(LN1 x)) from x itself, so
        norm1's gradients arrive from both branches and autograd sums them."""
        b, h, w, c = x.shape
        a, n1, n2, m = self.attn, self.norm1, self.norm2, self.mlp
        ln = F.layer_norm(x.float(), (c,), n1.weight.float(), n1.bias.float(), 1e-5).to(x.dtype)
        conv_x = self.conv_block(ln)
        bias = gather_rel_bias(a.relative_position_bias_table, relative_position_index(self.window_size), a.num_heads)
        x = attention_map_vjp(
            x, n1.weight, n1.bias, a.qkv.weight.t(), a.qkv.bias, a.proj.weight.t(), a.proj.bias, bias,
            None if scales is None else scales[:, 0].contiguous(), self.shift_size, a.num_heads, self.window_size,
        )
        x = x + conv_x * self.conv_scale
        y = mlp_block_dp_vjp(
            x.reshape(b * h * w, c), n2.weight, n2.bias, m.fc1.weight.t(), m.fc1.bias, m.fc2.weight.t(), m.fc2.bias,
            None if scales is None else scales[:, 1].contiguous(), h * w,
        )
        return y.reshape(b, h, w, c)


class OCAB(nn.Module):
    """Overlapping cross-attention block: queries from each ws x ws window,
    keys and values from the (ws + 2 pad)^2 window around it, then the MLP."""

    def __init__(self, dim: int, num_heads: int, window_size: int, overlap_ratio: float, mlp_ratio: float = 2.0):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.overlap_ratio = overlap_ratio
        self.fused_train = False
        owin, _ = overlap_window(window_size, overlap_ratio)
        self.norm1 = LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((window_size + owin - 1) ** 2, num_heads))
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, heads = self.window_size, self.num_heads
        owin, pad = overlap_window(ws, self.overlap_ratio)
        d = c // heads
        shortcut = x
        qkv = self.qkv(self.norm1(x))
        q, kv = qkv[..., :c], qkv[..., c:]
        q_windows = window_partition(q, ws).reshape(-1, ws * ws, c)
        kv_pad = F.pad(kv, (0, 0, pad, pad, pad, pad))
        # (B, nH, nW, 2C, owin, owin) -> (B * nW_total, owin * owin, 2C)
        kv_windows = kv_pad.unfold(1, owin, ws).unfold(2, owin, ws).permute(0, 1, 2, 4, 5, 3)
        kv_windows = kv_windows.reshape(-1, owin * owin, 2 * c)
        nq, nk = ws * ws, owin * owin
        bias = gather_rel_bias(self.relative_position_bias_table, relative_position_index_oca(ws, self.overlap_ratio),
                               heads)
        bw = q_windows.shape[0]
        qh = q_windows.reshape(bw, nq, heads, d).transpose(1, 2) * (d**-0.5)
        kh = kv_windows[..., :c].reshape(bw, nk, heads, d).transpose(1, 2)
        vh = kv_windows[..., c:].reshape(bw, nk, heads, d).transpose(1, 2)
        core = oca_attention(qh, kh, vh, bias) if self.fused_train else attention_core(qh, kh, vh, bias=bias)
        out = core.transpose(1, 2).reshape(bw, nq, c)
        x = self.proj(window_reverse(out.reshape(-1, ws, ws, c), ws, h, w)) + shortcut
        return x + self.mlp(self.norm2(x))


class _ResidualGroup(nn.Module):
    def __init__(self, blocks: Sequence[nn.Module], overlap_attn: nn.Module) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.overlap_attn = overlap_attn


class RHAG(nn.Module):
    """Residual hybrid attention group: HABs + OCAB + conv, residual."""

    def __init__(
        self, dim: int, depth: int, num_heads: int, window_size: int, mlp_ratio: float, compress_ratio: int,
        squeeze_factor: int, conv_scale: float, overlap_ratio: float, drop_path: Sequence[float] = (),
    ) -> None:
        super().__init__()
        blocks = [
            HAB(dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2, mlp_ratio, compress_ratio,
                squeeze_factor, conv_scale, drop_path[i] if drop_path else 0.0)
            for i in range(depth)
        ]
        self.residual_group = _ResidualGroup(blocks, OCAB(dim, num_heads, window_size, overlap_ratio, mlp_ratio))
        self.conv = conv(dim, dim)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        res = x
        for blk in self.residual_group.blocks:
            res = blk(res, generator)
        return self.conv(self.residual_group.overlap_attn(res)) + x


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.norm = LayerNorm(dim)


class HATModule(nn.Module):
    def __init__(
        self,
        scale: int = 4,
        n_colors: int = 3,
        img_range: float = 1.0,
        embed_dim: int = 180,
        depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
        num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6),
        window_size: int = 16,
        mlp_ratio: float = 2.0,
        drop_rate: float = 0.0,
        drop_path_rate: float = 0.1,
        compress_ratio: int = 3,
        squeeze_factor: int = 30,
        conv_scale: float = 0.01,
        overlap_ratio: float = 0.5,
        fused_train: bool = False,
    ) -> None:
        super().__init__()
        self.scale = scale
        self.window_size = window_size
        self.drop_rate = drop_rate
        self.normalizer = Normalizer(img_range)
        self.conv_first = conv(n_colors, embed_dim)
        self.patch_embed = _PatchEmbed(embed_dim)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList(
            RHAG(embed_dim, depth, num_heads[i], window_size, mlp_ratio, compress_ratio, squeeze_factor, conv_scale,
                 overlap_ratio, dpr[sum(depths[:i]) : sum(depths[: i + 1])])
            for i, depth in enumerate(depths)
        )
        self.norm = LayerNorm(embed_dim)
        self.conv_after_body = conv(embed_dim, embed_dim)
        self.conv_before_upsample = nn.ModuleList([conv(embed_dim, 64)])
        self.upsample = Upsampler(scale, 64)
        self.conv_last = conv(64, n_colors)
        self.fused_train = fused_train

    @property
    def fused_train(self) -> bool:
        """Route every HAB and OCAB through the fused custom-autograd paths."""
        return self._fused_train

    @fused_train.setter
    def fused_train(self, enabled: bool) -> None:
        if enabled and self.drop_rate:
            raise NotImplementedError("fused_train requires drop==0")
        self._fused_train = bool(enabled)
        for layer in self.layers:
            for blk in (*layer.residual_group.blocks, layer.residual_group.overlap_attn):
                blk.fused_train = self._fused_train

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC forward; ``generator`` feeds the drop-path and dropout draws in training mode."""
        h, w = x.shape[1:3]
        x = self.normalizer.normalize(pad_to_multiple_reflect(x, self.window_size))
        x = self.conv_first(x)
        shallow = x
        feats = dropout(self.patch_embed.norm(x), self.drop_rate, self.training, generator)
        for layer in self.layers:
            feats = layer(feats, generator)
        feats = self.norm(feats)
        x = self.conv_after_body(feats) + shallow
        x = F.leaky_relu(self.conv_before_upsample[0](x), 0.01)
        x = self.conv_last(self.upsample(x))
        x = self.normalizer.unnormalize(x)
        return x[:, : h * self.scale, : w * self.scale, :]


class HAT(FusedServingModel):
    _training_config = _TRAINING_CONFIG  # the JAX package's HAT recipe is SwinIR's

    def _fused_fns(self):
        from studiosr_tpu_torch.serving.hat_fast import hat_fast_forward, prepare_hat_serving

        return hat_fast_forward, prepare_hat_serving

    @classmethod
    def build(
        cls,
        scale: int = 4,
        n_colors: int = 3,
        img_range: float = 1.0,
        embed_dim: int = 180,
        depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
        num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6),
        window_size: int = 16,
        mlp_ratio: float = 2.0,
        drop_rate: float = 0.0,
        drop_path_rate: float = 0.1,
        compress_ratio: int = 3,
        squeeze_factor: int = 30,
        conv_scale: float = 0.01,
        overlap_ratio: float = 0.5,
        seed: int = 0,
        device=None,
        fused_train: bool = False,
    ) -> "HAT":
        """Seeded HAT on ``device`` (default ``cuda``; raises without it), in
        eval mode. ``drop_path_rate`` applies in training mode only."""
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
            compress_ratio=compress_ratio,
            squeeze_factor=squeeze_factor,
            conv_scale=conv_scale,
            overlap_ratio=overlap_ratio,
        )
        module = HATModule(
            scale, n_colors, img_range, embed_dim, tuple(depths), tuple(num_heads), window_size, mlp_ratio, drop_rate,
            drop_path_rate, compress_ratio, squeeze_factor, conv_scale, overlap_ratio, fused_train,
        )
        gen = torch.Generator().manual_seed(seed)
        _init_weights(module, gen)
        with torch.no_grad():
            for m in module.modules():
                if isinstance(m, OCAB):
                    nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02, a=-0.04, b=0.04, generator=gen)
        return cls(module.to(dev).eval(), config, dev)
