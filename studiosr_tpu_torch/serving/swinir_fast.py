"""Serving-path SwinIR forward built on the CUDA kernels.

Port of ``studiosr_tpu/serving/swinir_fast.py``: the exact SwinIR eval
computation (``models/swinir.py``), with every Swin block through B1
(``ops/cuda/swin_block.py``) at window 8, and at every other window (2-7, 9
up: SwinIR at 24, the key chunks streamed from 17) as B5
(``ops/cuda/window_attention.py``, the shift and its mask folded into its
reads) then B6 (``ops/cuda/mlp_block.py``) on the flattened rows, the JAX
package's own route where its whole-block kernel declines the window. The RSTB convs and ``conv_after_body`` through
B2 (``ops/cuda/conv3x3.py``, the skip map folded in through ``extra``) and
the tail through B3 at x4 or B4 at x2 / x3 (``ops/cuda/upsampler.py``); x8
has no fused tail and records its structural decline. SwinFIR's SFBs
(``models/swinfir.py``) take the place of the RSTB convs and
``conv_after_body``: each spatial branch runs through B14
(``fused_resblock``), its spectral branch, 1x1 fusion and concat in plain
torch, as the JAX package's ``_residual_conv`` routes them.
``conv_first`` and ``conv_before_upsample`` stay plain convolutions, as the
JAX package leaves them to XLA. B1 returns its output aligned, so the JAX path's rolled-space
bookkeeping and its per-group realigning roll have no counterpart here.

On CPU tensors every kernel wrapper takes its plain version; on CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from studiosr_tpu_torch.models.blocks import DEFAULT_RGB_MEAN
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.conv3x3 import (
    fused_conv3x3, fused_resblock, prepare_conv3x3_weights, prepare_fused_conv3x3_weights,
)
from studiosr_tpu_torch.ops.cuda.mlp_block import fused_mlp_block, mma_takes as mlp_mma_takes, pack_mlp_block
from studiosr_tpu_torch.ops.cuda.swin_block import (
    KERNEL_WINDOW, fused_swin_block, pack_swin_block,
)
from studiosr_tpu_torch.ops.cuda.upsampler import (
    SCALES_S, fused_upsample_s, fused_upsample_x4, pack_tail,
)
from studiosr_tpu_torch.ops.cuda.window_attention import (
    fused_window_attention_block, mma_takes as attn_mma_takes, pack_window_attention,
)
from studiosr_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from studiosr_tpu_torch.ops.windows import gather_rel_bias, pad_to_multiple_flip, relative_position_index

__all__ = ["swinir_fast_forward", "prepare_serving", "tail_operands", "fused_tail"]


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def _ln(norm: nn.LayerNorm, prefix: str = "ln") -> Dict[str, torch.Tensor]:
    return {f"{prefix}_w": _f32(norm.weight), f"{prefix}_b": _f32(norm.bias)}


def _dense(linear: nn.Linear, dtype) -> torch.Tensor:
    """nn.Linear (out, in) weight -> (in, out) kernel operand."""
    return linear.weight.detach().t().to(dtype).contiguous()


def _conv_operands(conv: nn.Conv2d, dtype):
    return prepare_conv3x3_weights(conv.weight, dtype), _f32(conv.bias)


def _b2_operands(conv: nn.Conv2d, dtype):
    """B2's (and B14's) operands: the weights packed in the layout of the
    kernel of ``dtype`` (in f32 where Cout > 16), HWIO otherwise."""
    return prepare_fused_conv3x3_weights(conv.weight, dtype), _f32(conv.bias)


def _b1_operands(blk: nn.Module, heads: int, rpi, dtype) -> Dict[str, Any]:
    """B1's operands for one Swin block, by keyword: the weights and the
    gathered rel-pos bias packed once into the blob of the kernel of
    ``dtype`` (``wqkv``; ``wproj``, ``bias``, ``w1``, ``w2`` None) where it
    takes the geometry (in f32 the 3xTF32 kernel's hi / lo images), dense
    (in, out) otherwise."""
    a = blk.attn
    ops = dict(
        ln1_w=_f32(blk.norm1.weight), ln1_b=_f32(blk.norm1.bias),
        wqkv=_dense(a.qkv, dtype), bqkv=_f32(a.qkv.bias),
        wproj=_dense(a.proj, dtype), bproj=_f32(a.proj.bias),
        bias=gather_rel_bias(_f32(a.relative_position_bias_table), rpi, heads).contiguous(),
        ln2_w=_f32(blk.norm2.weight), ln2_b=_f32(blk.norm2.bias),
        w1=_dense(blk.mlp.fc1, dtype), b1=_f32(blk.mlp.fc1.bias),
        w2=_dense(blk.mlp.fc2, dtype), b2=_f32(blk.mlp.fc2.bias),
    )
    packed = pack_swin_block(ops["wqkv"], ops["wproj"], ops["bias"], ops["w1"], ops["w2"], heads)
    if packed is not None:
        ops.update(wqkv=packed, wproj=None, bias=None, w1=None, w2=None)
    return ops


def _b5_b6_operands(blk: nn.Module, heads: int, rpi, dtype) -> Dict[str, Any]:
    """B5's and B6's operands for one Swin block at a window B1 does not
    take, ``{"attn": ..., "mlp": ...}`` by keyword: in bf16 B5's weights and
    gathered rel-pos bias packed once into its kernel's blob where
    ``mma_takes`` the geometry (``wqkv``; ``wproj``, ``bias`` None), and
    B6's fc1 and fc2 into its blob where its ``mma_takes`` does (``w1``;
    ``w2`` None); dense (in, out) otherwise."""
    a = blk.attn
    attn = dict(**_ln(blk.norm1), wqkv=_dense(a.qkv, dtype), bqkv=_f32(a.qkv.bias), wproj=_dense(a.proj, dtype),
                bproj=_f32(a.proj.bias),
                bias=gather_rel_bias(_f32(a.relative_position_bias_table), rpi, heads).contiguous())
    if dtype == torch.bfloat16 and attn_mma_takes(attn["ln_w"].numel(), heads):
        attn.update(wqkv=pack_window_attention(attn["wqkv"], attn["wproj"], attn["bias"], heads), wproj=None,
                    bias=None)
    mlp = dict(**_ln(blk.norm2), w1=_dense(blk.mlp.fc1, dtype), b1=_f32(blk.mlp.fc1.bias),
               w2=_dense(blk.mlp.fc2, dtype), b2=_f32(blk.mlp.fc2.bias))
    if dtype == torch.bfloat16 and mlp_mma_takes(*mlp["w1"].shape):
        mlp.update(w1=pack_mlp_block(mlp["w1"], mlp["w2"]), w2=None)
    return {"attn": attn, "mlp": mlp}


def _swin_block(x: torch.Tensor, operands: Dict[str, Any], heads: int, ws: int, shift: int) -> torch.Tensor:
    """One Swin block: B1 on its operands, or B5 then B6 on theirs."""
    if "attn" not in operands:
        return fused_swin_block(x, **operands, heads=heads, window_size=ws, shift=shift)
    y = fused_window_attention_block(x, **operands["attn"], heads=heads, window_size=ws, shift=shift)
    return fused_mlp_block(y.reshape(-1, y.shape[-1]), **operands["mlp"]).reshape(y.shape)


def _residual_operands(block: nn.Module, dtype):
    """A 3x3 conv's operands for B2, or an SFB's spatial-branch pair
    ``{"s0", "b0", "s2", "b2"}`` for B14."""
    if isinstance(block, nn.Conv2d):
        return _b2_operands(block, dtype)
    (s0, b0), (s2, b2) = (_b2_operands(block.S.body._modules[k], dtype) for k in ("0", "2"))
    return {"s0": s0, "b0": b0, "s2": s2, "b2": b2}


def _residual_conv(block: nn.Module, x: torch.Tensor, operands, extra: torch.Tensor) -> torch.Tensor:
    """``block(x) + extra``: B2 with the skip folded in for a 3x3 conv; for
    an SFB its spatial branch through B14 (LeakyReLU 0.2, res_scale 1) and
    the spectral branch, concat and 1x1 fusion in plain torch."""
    if not isinstance(operands, dict):
        return fused_conv3x3(x, *operands, extra=extra)
    s = fused_resblock(x, operands["s0"], operands["b0"], operands["s2"], operands["b2"], activation="lrelu0.2")
    return block.fusion(torch.cat([s, block.F(x)], dim=-1)) + extra


def prepare_serving(module: nn.Module, config: Dict[str, Any], dtype) -> Dict[str, Any]:
    """Lay every kernel's weights out once, at load time.

    Dense weights go to (in, out) and conv weights to HWIO in ``dtype``; B1's
    weights and rel-pos bias are packed into its kernel's blob (bf16, and f32
    at the geometries of the 3xTF32 kernel), and B2's and B14's conv weights
    into theirs (bf16, and f32 where Cout > 16; an SFB's two spatial-branch
    convs as a ``{s0, b0, s2, b2}`` pair); otherwise the rel-pos bias is
    gathered to (heads, N, N). LayerNorm weights and biases become f32. Window 8 lays out
    B1's operands; the other windows B5's and B6's (:func:`_b5_b6_operands`).
    Consumed by :func:`swinir_fast_forward`."""
    ws = int(config["window_size"])
    block_operands = _b1_operands if ws == KERNEL_WINDOW else _b5_b6_operands
    rpi = relative_position_index(ws)
    prep: Dict[str, Any] = {"blocks": [], "convs": []}
    for li, layer in enumerate(module.layers):
        heads = int(config["num_heads"][li])
        prep["blocks"].append([block_operands(blk, heads, rpi, dtype) for blk in layer.residual_group.blocks])
        prep["convs"].append(_residual_operands(layer.conv, dtype))
    prep["after_body"] = _residual_operands(module.conv_after_body, dtype)
    if config.get("upsampler", "pixelshuffle") == "pixelshuffle":
        prep["tail"] = tail_operands(module, int(config["scale"]), dtype)
    else:
        prep["up_direct"] = _b2_operands(module.upsample._modules["0"], dtype)
    return prep


def tail_operands(module: nn.Module, scale: int, dtype):
    """The fused tail's weights: B3's (``upsample.0``, ``upsample.2``,
    ``conv_last``) at x4, B4's (``upsample.0``, ``conv_last``) at x2 / x3,
    None where no kernel serves the scale. The weights are packed once in
    the kernels' layouts (``pack_tail``) in bf16, and in f32 where the wide
    convs run the 3xTF32 kernel (conv_last HWIO), HWIO otherwise."""
    convs = {4: ("0", "2"), **{s: ("0",) for s in SCALES_S}}.get(scale)
    if convs is None:
        return None
    ops = [t for name in convs for t in _conv_operands(module.upsample._modules[name], dtype)]
    return pack_tail((*ops, *_conv_operands(module.conv_last, dtype)), scale)


def fused_tail(module: nn.Module, x: torch.Tensor, scale: int, tail) -> torch.Tensor:
    """The pixelshuffle tail after conv_before_upsample + LeakyReLU: B3 at
    x4, B4 at x2 / x3; any other scale records the by-design decline and runs
    the plain log2 ladder."""
    if scale == 4:
        return fused_upsample_x4(x, *tail)
    if scale in SCALES_S:
        return fused_upsample_s(x, *tail, scale)
    engagement.structural_tail_decline(scale)
    return module.conv_last(module.upsample(x))


def _layernorm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with f32 statistics, returned in ``x.dtype``."""
    return F.layer_norm(x.float(), (x.shape[-1],), ln.weight.float(), ln.bias.float(), 1e-5).to(x.dtype)


def swinir_fast_forward(
    module: nn.Module, x: torch.Tensor, config: Dict[str, Any], prep: Optional[Dict[str, Any]] = None
) -> torch.Tensor:
    """Eval-mode SwinIR forward (flip-concat padding) of an NHWC batch.

    ``prep``: the weights of :func:`prepare_serving` for ``x.dtype``; built
    here when omitted."""
    if prep is None:
        prep = prepare_serving(module, config, x.dtype)
    scale = int(config["scale"])
    ws = int(config["window_size"])
    img_range = float(config.get("img_range", 1.0))
    upsampler = config.get("upsampler", "pixelshuffle")

    _, h0, w0, _ = x.shape
    x = pad_to_multiple_flip(x, ws)
    mean = torch.tensor(DEFAULT_RGB_MEAN, dtype=x.dtype, device=x.device)
    x = x / img_range - mean

    x = module.conv_first(x).contiguous()
    shallow = x
    feats = _layernorm(x, module.patch_embed.norm)
    for li, layer in enumerate(module.layers):
        heads = int(config["num_heads"][li])
        res = feats
        for bi, operands in enumerate(prep["blocks"][li]):
            res = _swin_block(res, operands, heads, ws, 0 if bi % 2 == 0 else ws // 2)
        feats = _residual_conv(layer.conv, res, prep["convs"][li], feats)
    feats = _layernorm(feats, module.norm)
    x = _residual_conv(module.conv_after_body, feats, prep["after_body"], shallow)

    if upsampler == "pixelshuffle":
        x = F.leaky_relu(module.conv_before_upsample[0](x), 0.01).contiguous()
        x = fused_tail(module, x, scale, prep["tail"])
    else:
        x = pixel_shuffle(fused_conv3x3(x, *prep["up_direct"]), scale)

    x = (x + mean) * img_range
    return x[:, : h0 * scale, : w0 * scale, :]
