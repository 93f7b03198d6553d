"""MaxSR — MaxViT-style SR: MBConv + block attention + grid attention (NHWC, PyTorch).

Port of ``studiosr_tpu/models/maxsr.py``: conv stem, stages of (MBConv ->
block attention -> grid attention), hierarchical feature fusion (HFFB) over
the concatenated stage outputs, PixelShuffle upsampling. Both modes:

* static (``adaptive=False``): 8 x 8 windows, a trained relative-position
  bias table, the input reflect-padded to a window multiple and the output
  cropped;
* adaptive (``adaptive=True``): windows of ceil(sqrt(H)) x ceil(sqrt(W)) on
  the map zero-padded to their squares, a zero bias and an inner LayerNorm;
  the map stays padded through the stages until the post-stage crop.

Module names are the flax paths (the static layout's ``stages.s.d.{0,1,2}``
with ``1.fn`` / ``2.fn`` inside each pair, the adaptive layout's flat
``stages.s.i`` with ``attention.fn`` / ``feedforward.fn``), so
``zoo/translate.py`` fills the module from a JAX variables tree, running
statistics included.

Training mode uses the BatchNorm batch statistics (flax's arithmetic,
``models/blocks.py::BatchNorm``) and MBConv's dropsample: each sample's
residual branch is kept with probability 1 - dropout and scaled by
1 / (1 - dropout), the draws taken from the ``generator`` handed to
``forward``. ``enable_fused`` routes the attention cores (32 a forward at
the default depth) through B15 (``ops/cuda/window_attn.py``); a window of
more than 1024 tokens (adaptive mode on about a megapixel of LR, 1025²
giving 33² tokens) is B15's structural decline, recorded in
``engagement.declines()`` and served by the plain core, as the JAX
wrapper declines it; the feed-forward and the map-level fused route stay plain, as the JAX package's
``FF_FUSED_SERVING`` and ``MAP_FUSED_SERVING`` leave them.

``fused_train`` (``studiosr_tpu/models/maxsr.py:365-419``) runs, in training
mode, each attention pair whose windows are square (wh == ww) on the whole
map: the attention half through ``ops/attn_vjp.py::attention_map_vjp`` (B5
forward, B8 backward at windows 2-8; B5 and B9 at 9 up, in the streaming
family from 17: a map side above 256) with zero qkv / proj biases, the feed-forward half
through ``ops/mlp_vjp.py::mlp_block_vjp`` (B6 / B7 at hidden 4 dim). Grid
attention is block attention of the perfect-shuffled map
(:func:`shuffle_grid`). The static mode hands over its gathered table bias
in the step's dtype; the adaptive mode runs its outer LayerNorm plainly,
hands the kernels a zero bias and re-bases their residual: x + (block(ln) -
ln). A non-square adaptive map, and every pair in eval mode (the Trainer's
evaluations, whose square maps may have any window), take the plain path, as
the JAX Trainer evaluates its plain module. The MBConvs (BatchNorm running
statistics, dropsample) run plainly on both paths.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from studiosr_tpu_torch._device import resolve_device
from studiosr_tpu_torch.models.base import Model
from studiosr_tpu_torch.models.blocks import BatchNorm, LayerNorm, Normalizer, conv, drop_path_scales, gelu, slots
from studiosr_tpu_torch.ops.attention import attention_core, attention_plain
from studiosr_tpu_torch.ops.attn_vjp import attention_map_vjp
from studiosr_tpu_torch.ops.cuda import window_attn
from studiosr_tpu_torch.ops.mlp_vjp import mlp_block_vjp
from studiosr_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from studiosr_tpu_torch.ops.windows import gather_rel_bias, pad_to_multiple_reflect, relative_position_index

__all__ = [
    "MaxSR", "MaxSRModule", "MBConv", "block_partition", "block_reverse", "grid_partition", "grid_reverse",
    "shuffle_grid", "unshuffle_grid",
]


class SqueezeExcitation(nn.Module):
    """Mean-pool gate with two bias-free Linear layers."""

    def __init__(self, dim: int, shrinkage_rate: float = 0.25) -> None:
        super().__init__()
        hidden = int(dim * shrinkage_rate)
        self.gate = slots({"1": nn.Linear(dim, hidden, bias=False), "3": nn.Linear(hidden, dim, bias=False)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.gate._modules["1"](x.mean(dim=(1, 2)))
        g = torch.sigmoid(self.gate._modules["3"](F.silu(g)))
        return x * g[:, None, None, :]


class MBConv(nn.Module):
    """Inverted bottleneck with an SE gate and the residual; the torch
    Sequential names under ``fn.``: 0 expand, 1 BN, 3 depthwise, 4 BN, 6 SE,
    7 project, 8 BN."""

    def __init__(self, dim: int, expansion_rate: float = 4, shrinkage_rate: float = 0.25, dropout: float = 0.0):
        super().__init__()
        hidden = int(expansion_rate * dim)
        self.dropout = dropout
        self.fn = slots({
            "0": conv(dim, hidden, 1), "1": BatchNorm(hidden), "3": conv(hidden, hidden, 3, groups=hidden),
            "4": BatchNorm(hidden), "6": SqueezeExcitation(hidden, shrinkage_rate), "7": conv(hidden, dim, 1),
            "8": BatchNorm(dim),
        })

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        f = self.fn._modules
        y = gelu(f["1"](f["0"](x)))
        y = gelu(f["4"](f["3"](y)))
        y = f["8"](f["7"](f["6"](y)))
        if self.training and self.dropout > 0.0:
            scales = drop_path_scales(y.shape[0], self.dropout, generator, y.device)
            y = y * scales.reshape(-1, 1, 1, 1).to(y.dtype)
        return y + x


def block_partition(x: torch.Tensor, wh: int, ww: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """'b (x w1) (y w2) c -> (b x y) (w1 w2) c': contiguous windows."""
    b, h, w, c = x.shape
    nx, ny = h // wh, w // ww
    x = x.reshape(b, nx, wh, ny, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nx * ny, wh * ww, c), (nx, ny)


def block_reverse(x: torch.Tensor, grid: Tuple[int, int], wh: int, ww: int) -> torch.Tensor:
    nx, ny = grid
    c = x.shape[-1]
    b = x.shape[0] // (nx * ny)
    x = x.reshape(b, nx, ny, wh, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, nx * wh, ny * ww, c)


def grid_partition(x: torch.Tensor, wh: int, ww: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """'b (w1 x) (w2 y) c -> (b x y) (w1 w2) c': strided grid tokens."""
    b, h, w, c = x.shape
    nx, ny = h // wh, w // ww
    x = x.reshape(b, wh, nx, ww, ny, c).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b * nx * ny, wh * ww, c), (nx, ny)


def grid_reverse(x: torch.Tensor, grid: Tuple[int, int], wh: int, ww: int) -> torch.Tensor:
    nx, ny = grid
    c = x.shape[-1]
    b = x.shape[0] // (nx * ny)
    x = x.reshape(b, nx, ny, wh, ww, c).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, wh * nx, ww * ny, c)


def shuffle_grid(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """The spatial perfect shuffle that makes grid partition a block
    partition: ``grid_partition(x) == block_partition(shuffle_grid(x))``."""
    b, h, w, c = x.shape
    nx, ny = h // wh, w // ww
    x = x.reshape(b, wh, nx, w, c).transpose(1, 2).reshape(b, h, w, c)
    return x.reshape(b, h, ww, ny, c).transpose(2, 3).reshape(b, h, w, c)


def unshuffle_grid(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """The inverse of :func:`shuffle_grid`."""
    b, h, w, c = x.shape
    nx, ny = h // wh, w // ww
    x = x.reshape(b, nx, wh, w, c).transpose(1, 2).reshape(b, h, w, c)
    return x.reshape(b, h, ny, ww, c).transpose(2, 3).reshape(b, h, w, c)


class _Attention(nn.Module):
    """Multi-head attention over (B', N, C) window tokens: the trained
    rel-pos bias table in static mode; an inner LayerNorm and no bias in
    adaptive mode. ``fused`` routes the core through B15."""

    def __init__(self, dim: int, dim_head: int, window_size: int = 0, static: bool = True) -> None:
        super().__init__()
        self.heads = dim // dim_head
        self.dim_head = dim_head
        self.window_size = window_size
        self.static = static
        self.fused = False
        if not static:
            self.norm = LayerNorm(dim)
        self.to_qkv = nn.Linear(dim, 3 * dim, bias=False)
        if static:
            self.rel_pos_bias = nn.Embedding((2 * window_size - 1) ** 2, self.heads)
        self.to_out = slots({"0": nn.Linear(dim, dim, bias=False)})

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b_, n, c = tokens.shape
        heads, d = self.heads, self.dim_head
        if not self.static:
            tokens = self.norm(tokens)
        qkv = self.to_qkv(tokens).reshape(b_, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (d**-0.5), qkv[1], qkv[2]
        bias = None
        if self.static:
            bias = gather_rel_bias(self.rel_pos_bias.weight, relative_position_index(self.window_size), heads)
        if self.fused and window_attn.takes(n, n, d):
            out = window_attn.window_attention(q, k, v, bias=bias)
        elif self.fused:
            # B15 takes at most 1024 tokens a window (about a megapixel of LR
            # in adaptive mode): a structural decline, as the JAX wrapper's,
            # recorded, then attention_core's plain route
            window_attn.decline(n, n, d)
            out = attention_plain(q, k, v, bias)
        else:
            out = attention_core(q, k, v, bias=bias)
        return self.to_out._modules["0"](out.transpose(1, 2).reshape(b_, n, c))


class _FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4) -> None:
        super().__init__()
        self.net = slots({"0": nn.Linear(dim, dim * mult), "3": nn.Linear(dim * mult, dim)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net._modules["3"](gelu(self.net._modules["0"](x)))


class _AttentionPair(nn.Module):
    """PreNorm attention + PreNorm feed-forward on block (or grid)
    partitioned tokens, under the static (``1`` / ``2``) or the adaptive
    (``attention`` / ``feedforward``) names."""

    def __init__(self, dim: int, dim_head: int, window_size: int, static: bool, grid: bool) -> None:
        super().__init__()
        self.grid = grid
        self.fused_train = False
        self.attn_name, self.ff_name = ("1", "2") if static else ("attention", "feedforward")
        self.add_module(self.attn_name, slots({"norm": LayerNorm(dim), "fn": _Attention(dim, dim_head, window_size,
                                                                                         static)}))
        self.add_module(self.ff_name, slots({"norm": LayerNorm(dim), "fn": _FeedForward(dim)}))

    def forward(self, x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
        if self.fused_train and self.training and wh == ww:
            return self._fused(x, wh)
        attn, ff = self._modules[self.attn_name], self._modules[self.ff_name]
        partition, reverse = (grid_partition, grid_reverse) if self.grid else (block_partition, block_reverse)
        tokens, grid_shape = partition(x, wh, ww)
        tokens = tokens + attn.fn(attn.norm(tokens))
        tokens = tokens + ff.fn(ff.norm(tokens))
        return reverse(tokens, grid_shape, wh, ww)

    def _fused(self, x: torch.Tensor, ws: int) -> torch.Tensor:
        """The pair on the whole map through B5 / B8 (B9) and B6 / B7."""
        attn, ff = self._modules[self.attn_name], self._modules[self.ff_name]
        a, net = attn.fn, ff.fn.net._modules
        b, h, w, c = x.shape
        # _Attention has no qkv / proj biases: zeros that take no gradient
        zb3, zb1 = torch.zeros(3 * c, device=x.device), torch.zeros(c, device=x.device)
        wqkv, wproj = a.to_qkv.weight.t(), a.to_out._modules["0"].weight.t()
        if self.grid:
            x = shuffle_grid(x, ws, ws)
        if a.static:
            bias = gather_rel_bias(a.rel_pos_bias.weight, relative_position_index(ws), a.heads)
            x = attention_map_vjp(x, attn.norm.weight, attn.norm.bias, wqkv, zb3, wproj, zb1, bias, None, 0, a.heads,
                                  ws)
        else:
            # x + proj(attn(LN_in(LN_out x))): LN_out plainly, then the kernels'
            # residual re-based, x + (block(ln) - ln)
            x32 = x.float()
            ln = F.layer_norm(x32, (c,), attn.norm.weight.float(), attn.norm.bias.float(), 1e-5).to(x.dtype)
            zbias = torch.zeros(a.heads, ws * ws, ws * ws, device=x.device)
            y = attention_map_vjp(ln, a.norm.weight, a.norm.bias, wqkv, zb3, wproj, zb1, zbias, None, 0, a.heads, ws)
            x = (x32 + (y.float() - ln.float())).to(x.dtype)
        y = mlp_block_vjp(x.reshape(b * h * w, c), ff.norm.weight, ff.norm.bias, net["0"].weight.t(), net["0"].bias,
                          net["3"].weight.t(), net["3"].bias).reshape(b, h, w, c)
        return unshuffle_grid(y, ws, ws) if self.grid else y


class MaxSRModule(nn.Module):
    def __init__(
        self,
        scale: int = 4,
        n_colors: int = 3,
        img_range: float = 1.0,
        adaptive: bool = True,
        dim: int = 128,
        dim_head: int = 32,
        depth: Sequence[int] = (4, 4, 4, 4),
        window_size: int = 8,
        mbconv_expansion_rate: float = 4,
        mbconv_shrinkage_rate: float = 0.25,
        dropout: float = 0.1,
    ) -> None:
        super().__init__()
        self.scale = scale
        self.adaptive = adaptive
        self.window_size = window_size
        self.depth = tuple(depth)
        self.normalizer = Normalizer(img_range)
        self.conv_stem_first = conv(n_colors, dim)
        self.conv_stem_second = conv(dim, dim)
        ws = 0 if adaptive else window_size
        stages = {}
        for s, stage_depth in enumerate(self.depth):
            stage = {}
            for i in range(stage_depth):
                trio = (
                    MBConv(dim, mbconv_expansion_rate, mbconv_shrinkage_rate, dropout),
                    _AttentionPair(dim, dim_head, ws, static=not adaptive, grid=False),
                    _AttentionPair(dim, dim_head, ws, static=not adaptive, grid=True),
                )
                if adaptive:  # a flat list [mbconv, block, grid] * depth
                    stage.update({str(3 * i + j): m for j, m in enumerate(trio)})
                else:
                    stage[str(i)] = slots({str(j): m for j, m in enumerate(trio)})
            stages[str(s)] = slots(stage)
        self.stages = slots(stages)
        self.HFFB = slots({"0": conv(len(self.depth) * dim, dim, 1), "1": conv(dim, dim)})
        if (scale & (scale - 1)) == 0:
            up = {str(2 * i): conv(dim, 4 * dim) for i in range(int(math.log2(scale)))}
        elif scale == 3:
            up = {"0": conv(dim, 9 * dim)}
        else:
            raise ValueError(f"scale {scale} is not supported. Supported scales: 2^n and 3.")
        self.Upsample = slots(up)
        self.conv_last = conv(dim, n_colors)

    def _attention_modules(self):
        return [m for m in self.modules() if isinstance(m, _Attention)]

    @property
    def fused(self) -> bool:
        """Route every attention core through B15 (serving)."""
        return any(m.fused for m in self._attention_modules())

    @fused.setter
    def fused(self, enabled: bool) -> None:
        for m in self._attention_modules():
            m.fused = bool(enabled)

    @property
    def fused_train(self) -> bool:
        """Run the attention pairs of square windows through B5-B8 in training
        mode; in eval mode (the Trainer's evaluations) they stay plain."""
        return any(m.fused_train for m in self.modules() if isinstance(m, _AttentionPair))

    @fused_train.setter
    def fused_train(self, enabled: bool) -> None:
        for m in self.modules():
            if isinstance(m, _AttentionPair):
                m.fused_train = bool(enabled)

    def _trios(self, s: int):
        stage = self.stages._modules[str(s)]._modules
        for i in range(self.depth[s]):
            if self.adaptive:
                yield tuple(stage[str(3 * i + j)] for j in range(3))
            else:
                yield tuple(stage[str(i)]._modules[str(j)] for j in range(3))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC forward; ``generator`` feeds the dropsample draws in training mode."""
        h, w = x.shape[1:3]
        ws = self.window_size
        if not self.adaptive:
            x = pad_to_multiple_reflect(x, ws)
        x = self.normalizer.normalize(x)
        fm1 = self.conv_stem_first(x)
        x = self.conv_stem_second(fm1)

        stage_outputs = []
        for s in range(len(self.depth)):
            for mbconv, block, grid in self._trios(s):
                x = mbconv(x, generator)
                if self.adaptive:
                    hh, www = x.shape[1:3]
                    wh, ww = math.ceil(math.sqrt(hh)), math.ceil(math.sqrt(www))
                    # zero-padded to (wh^2, ww^2); a fixpoint of the window rule, so
                    # the map stays padded until the post-stage crop
                    x = F.pad(x, (0, 0, 0, ww * ww - www, 0, wh * wh - hh))
                else:
                    wh = ww = ws
                x = grid(block(x, wh, ww), wh, ww)
            stage_outputs.append(x)

        f_cat = torch.cat(stage_outputs, dim=-1)
        if self.adaptive:
            f_cat = f_cat[:, :h, :w, :]
        y = self.HFFB._modules["1"](self.HFFB._modules["0"](f_cat)) + fm1

        s = self.scale
        up = self.Upsample._modules
        if (s & (s - 1)) == 0:
            for i in range(int(math.log2(s))):
                y = pixel_shuffle(up[str(2 * i)](y), 2)
        else:
            y = pixel_shuffle(up["0"](y), 3)
        y = self.normalizer.unnormalize(self.conv_last(y))
        if not self.adaptive:
            y = y[:, : h * s, : w * s, :]
        return y


def _init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init as flax's defaults: truncated-normal (std 1/sqrt(fan_in))
    conv and dense kernels with zero biases, embeddings std
    1/sqrt(features), norms ones / zeros, running statistics 0 / 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                std = m.weight[0].numel() ** -0.5
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                std = m.weight.shape[1] ** -0.5
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)


class MaxSR(Model):
    _fused = False

    def enable_fused(self, enabled: bool = True) -> "MaxSR":
        """Serve the attention cores through B15; the parameters are unchanged
        (the mesh replicas are dropped)."""
        self.module.fused = enabled
        self._fused = enabled
        self.__dict__.pop("_replica_cache", None)
        return self

    @classmethod
    def build(
        cls,
        scale: int = 4,
        n_colors: int = 3,
        img_range: float = 1.0,
        adaptive: bool = True,
        dim: int = 128,
        dim_head: int = 32,
        depth: Sequence[int] = (4, 4, 4, 4),
        window_size: int = 8,
        mbconv_expansion_rate: float = 4,
        mbconv_shrinkage_rate: float = 0.25,
        dropout: float = 0.1,
        seed: int = 0,
        device=None,
        fused_train: bool = False,
    ) -> "MaxSR":
        """Seeded MaxSR on ``device`` (default ``cuda``; raises without it),
        in eval mode; ``fused_train`` routes training through B5-B8."""
        dev = resolve_device(device)
        config: Dict[str, Any] = dict(
            scale=scale,
            n_colors=n_colors,
            img_range=img_range,
            adaptive=adaptive,
            dim=dim,
            dim_head=dim_head,
            depth=list(depth),
            window_size=window_size,
            mbconv_expansion_rate=mbconv_expansion_rate,
            mbconv_shrinkage_rate=mbconv_shrinkage_rate,
            dropout=dropout,
        )
        module = MaxSRModule(**{**config, "depth": tuple(depth)})
        module.fused_train = fused_train
        _init_weights(module, torch.Generator().manual_seed(seed))
        return cls(module.to(dev).eval(), config, dev)

    @classmethod
    def from_pretrained(
        cls, scale: int = 4, light: bool = True, adaptive: bool = False, ckpt_path: Optional[str] = None, device=None,
    ) -> "MaxSR":
        """The JAX package's configuration mirror: ``light`` builds the
        48-dim, 2-deep variant; weights come only from a local torch state
        dict (``ckpt_path``), matched by name (``params`` / ``params_ema`` /
        ``state_dict`` wrappers and ``module.`` prefixes unwrapped)."""
        config: Dict[str, Any] = dict(
            scale=scale, adaptive=adaptive, dim=128, dim_head=32, depth=[4, 4, 4, 4], window_size=8, dropout=0.1
        )
        if light:
            config.update(dim=48, dim_head=12, depth=[2, 2, 2, 2])
        model = cls.build(**config, device=device)
        if ckpt_path is not None:
            from studiosr_tpu_torch.zoo.translate import load_jax_params, load_torch_state_dict

            load_jax_params(model.module, load_torch_state_dict(ckpt_path))
        return model
