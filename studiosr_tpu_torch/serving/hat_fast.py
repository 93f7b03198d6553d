"""Serving-path HAT forward built on the CUDA kernels.

Port of ``studiosr_tpu/serving/hat_fast.py``: the exact HAT eval computation
(``models/hat.py``). Per HAB:

* B11 (``ops/cuda/conv3x3.py::fused_cab_body``) runs the CAB trunk on the
  block input, y2 = conv2(gelu(conv1(LN1 x))), with the per-image channel
  sums of y2; the squeeze-excite gate g = sigmoid(conv(relu(conv(mean))))
  runs in plain ops, mean = sums / (H W) of the padded map; in bf16 its two
  convs are packed once, at load time, for the kernel written for the H100
  (``pack_cab_convs``, where ``cab_mma_takes`` the geometry);
* B5 at window 16 (``ops/cuda/window_attention.py``) computes
  y = x + attn(LN1 x), the shift folded in and the output aligned, so the
  JAX path's rolls have no counterpart; in bf16 its weights and bias are
  packed once, at load time, for the kernel written for the H100
  (``pack_window_attention``, where ``mma_takes`` the geometry);
* B6 (``ops/cuda/mlp_block.py``) finishes the block. At batch 1 it folds in
  the CAB join x' = y + y2 * (g * conv_scale) through ``extra`` /
  ``extra_scale``; at batch > 1 the join runs in plain ops first. In bf16
  its fc1 and fc2 are packed once, at load time, for the kernel written for
  the H100 (``pack_mlp_block``, where ``mma_takes`` the geometry).

Each group ends with B10 (``ops/cuda/ocab.py``) and its conv through B2,
the skip folded in. In bf16, B10's q|k|v, proj, fc1 and fc2 are packed
once, at load time, for the kernels written for the H100
(``pack_ocab_block``, where ``ocab_mma_takes`` the geometry), and its
gathered rel-pos bias is rounded to the map's dtype, as the JAX package's
``prepare_ocab_weights`` rounds it. ``conv_after_body`` runs through B2 as
well and the tail through B3 at x4 or B4 at x2 / x3 (x8 records its
structural decline).
``conv_first``, ``conv_before_upsample`` and the LayerNorms
outside the blocks stay plain, as the JAX package leaves them to XLA.

On CPU tensors every kernel wrapper takes its plain version; on CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from studiosr_tpu_torch.models.blocks import DEFAULT_RGB_MEAN
from studiosr_tpu_torch.ops.cuda.conv3x3 import cab_mma_takes, fused_cab_body, fused_conv3x3, pack_cab_convs
from studiosr_tpu_torch.ops.cuda.mlp_block import fused_mlp_block, mma_takes as mlp_mma_takes, pack_mlp_block
from studiosr_tpu_torch.ops.cuda.ocab import fused_ocab_block, ocab_mma_takes, pack_ocab_block
from studiosr_tpu_torch.ops.cuda.window_attention import fused_window_attention_block, mma_takes, pack_window_attention
from studiosr_tpu_torch.ops.windows import (
    gather_rel_bias,
    pad_to_multiple_reflect,
    relative_position_index,
    relative_position_index_oca,
)
from studiosr_tpu_torch.serving.swinir_fast import (
    _b2_operands, _conv_operands, _dense, _f32, _layernorm, _ln, fused_tail, tail_operands,
)

__all__ = ["hat_fast_forward", "prepare_hat_serving"]


def prepare_hat_serving(module: nn.Module, config: Dict[str, Any], dtype) -> Dict[str, Any]:
    """Lay every kernel's weights out once, at load time: dense weights to
    (in, out) and conv weights to HWIO in ``dtype`` (B2's and B11's packed in
    bf16, and B5's q|k|v, proj and rel-pos bias in one blob, B6's fc1 and fc2
    in another, B10's q|k|v, proj, fc1 and fc2 in a third), the rel-pos
    biases gathered to (heads, 256, 256) and (heads, 256, 576) (the latter in
    ``dtype``), LayerNorm weights and biases f32. Consumed by :func:`hat_fast_forward`."""
    ws = int(config["window_size"])
    overlap = float(config.get("overlap_ratio", 0.5))
    rpi, rpi_oca = relative_position_index(ws), relative_position_index_oca(ws, overlap)
    prep: Dict[str, Any] = {"blocks": [], "convs": [], "ocab": []}
    for li, layer in enumerate(module.layers):
        heads = int(config["num_heads"][li])
        group = []
        for blk in layer.residual_group.blocks:
            a, cab = blk.attn, blk.conv_block.cab._modules
            w1, b1 = _conv_operands(cab["0"], dtype)
            w2, b2 = _conv_operands(cab["2"], dtype)
            if dtype == torch.bfloat16 and cab_mma_takes(w1.shape[2], w1.shape[3]):
                w1, w2 = pack_cab_convs(w1, w2)
            attn = dict(**_ln(blk.norm1), wqkv=_dense(a.qkv, dtype), bqkv=_f32(a.qkv.bias),
                        wproj=_dense(a.proj, dtype), bproj=_f32(a.proj.bias),
                        bias=gather_rel_bias(_f32(a.relative_position_bias_table), rpi, heads).contiguous())
            if dtype == torch.bfloat16 and mma_takes(attn["ln_w"].numel(), heads):
                attn.update(wqkv=pack_window_attention(attn["wqkv"], attn["wproj"], attn["bias"], heads), wproj=None,
                            bias=None)
            mlp = dict(**_ln(blk.norm2), w1=_dense(blk.mlp.fc1, dtype), b1=_f32(blk.mlp.fc1.bias),
                       w2=_dense(blk.mlp.fc2, dtype), b2=_f32(blk.mlp.fc2.bias))
            if dtype == torch.bfloat16 and mlp_mma_takes(*mlp["w1"].shape):
                mlp.update(w1=pack_mlp_block(mlp["w1"], mlp["w2"]), w2=None)
            group.append(dict(cab=dict(**_ln(blk.norm1), w1=w1, b1=b1, w2=w2, b2=b2), attn=attn, mlp=mlp))
        prep["blocks"].append(group)
        oa = layer.residual_group.overlap_attn
        ocab = dict(
            **_ln(oa.norm1, "ln1"), wqkv=_dense(oa.qkv, dtype), bqkv=_f32(oa.qkv.bias), wproj=_dense(oa.proj, dtype),
            bproj=_f32(oa.proj.bias),
            bias=gather_rel_bias(_f32(oa.relative_position_bias_table), rpi_oca, heads).to(dtype).contiguous(),
            **_ln(oa.norm2, "ln2"), w1=_dense(oa.mlp.fc1, dtype), b1=_f32(oa.mlp.fc1.bias),
            w2=_dense(oa.mlp.fc2, dtype), b2=_f32(oa.mlp.fc2.bias),
        )
        if dtype == torch.bfloat16 and ocab_mma_takes(ocab["bproj"].numel(), heads, ws, overlap, ocab["b1"].numel()):
            ocab.update(wqkv=pack_ocab_block(ocab["wqkv"], ocab["wproj"], ocab["w1"], ocab["w2"], heads), wproj=None,
                        w1=None, w2=None)
        prep["ocab"].append(ocab)
        prep["convs"].append(_b2_operands(layer.conv, dtype))
    prep["after_body"] = _b2_operands(module.conv_after_body, dtype)
    prep["tail"] = tail_operands(module, int(config["scale"]), dtype)
    return prep


def hat_fast_forward(
    module: nn.Module, x: torch.Tensor, config: Dict[str, Any], prep: Optional[Dict[str, Any]] = None
) -> torch.Tensor:
    """Eval-mode HAT forward (reflect padding) of an NHWC batch.

    ``prep``: the weights of :func:`prepare_hat_serving` for ``x.dtype``;
    built here when omitted."""
    if prep is None:
        prep = prepare_hat_serving(module, config, x.dtype)
    scale = int(config["scale"])
    ws = int(config["window_size"])
    img_range = float(config.get("img_range", 1.0))
    conv_scale = float(config.get("conv_scale", 0.01))
    overlap = float(config.get("overlap_ratio", 0.5))

    n, h0, w0, _ = x.shape
    x = pad_to_multiple_reflect(x, ws)
    hgt, wdt = x.shape[1:3]
    mean = torch.tensor(DEFAULT_RGB_MEAN, dtype=x.dtype, device=x.device)
    x = x / img_range - mean

    x = module.conv_first(x).contiguous()
    shallow = x
    c = x.shape[-1]
    feats = _layernorm(x, module.patch_embed.norm)
    for li, layer in enumerate(module.layers):
        heads = int(config["num_heads"][li])
        res = feats
        for bi, ops in enumerate(prep["blocks"][li]):
            ca = layer.residual_group.blocks[bi].conv_block.cab._modules["3"]
            y2, sums = fused_cab_body(res, **ops["cab"])
            g = ca.gate((sums / (hgt * wdt)).to(res.dtype).reshape(n, 1, 1, c))
            y = fused_window_attention_block(res, **ops["attn"], heads=heads, window_size=ws,
                                             shift=0 if bi % 2 == 0 else ws // 2)
            if n == 1:
                escale = g.reshape(c) * torch.tensor(conv_scale, dtype=g.dtype, device=g.device)
                flat = fused_mlp_block(y.reshape(-1, c), **ops["mlp"], extra=y2.reshape(-1, c), extra_scale=escale)
            else:
                flat = fused_mlp_block((y + y2 * g * conv_scale).reshape(-1, c), **ops["mlp"])
            res = flat.reshape(n, hgt, wdt, c)
        res = fused_ocab_block(res, **prep["ocab"][li], heads=heads, window_size=ws, overlap_ratio=overlap)
        feats = fused_conv3x3(res, *prep["convs"][li], extra=feats)
    feats = _layernorm(feats, module.norm)
    x = fused_conv3x3(feats, *prep["after_body"], extra=shallow)
    x = F.leaky_relu(module.conv_before_upsample[0](x), 0.01).contiguous()
    x = fused_tail(module, x, scale, prep["tail"])
    x = (x + mean) * img_range
    return x[:, : h0 * scale, : w0 * scale, :]
