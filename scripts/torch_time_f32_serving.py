#!/usr/bin/env python3
"""Time the port's kernels in f32 on one NVIDIA GPU: the f32 serving path
(B1, B2, B3, B4, B14) and the f32 kernels of the other paths.

    python3 scripts/torch_time_f32_serving.py [--checkout DIR] [--serving-only | --attn-only]

f32 with TF32 off (``resolve_device`` turns it off for cuBLAS and cuDNN),
seeded operands, CUDA events over 20 launches after 3 warm-up launches.

The serving path, at SwinIR / SwinFIR x4's shapes (a 264 x 264 map: 256
flip-padded to the window's multiple), each kernel on its weights as the
checkout's ``prepare_serving`` lays them out in f32 (its models built at
full width and cut to one or two blocks, seeded): B1 (``fused_swin_block``,
C 180, 6 heads, hidden 360, shift 4) beside its plain version, B5 f32 then
B6 f32 on the same map and weights (``fused_window_attention_block`` then
``fused_mlp_block``, dense f32 weights) and the block as a sequence of f32
PyTorch calls; B2 (``fused_conv3x3`` 180 -> 180 with the skip map) beside
its plain version and cuDNN's ``F.conv2d`` + add; B3 (``fused_upsample_x4``,
264 x 264 x 64) and B4 (``fused_upsample_s`` x2 / x3) beside their plain
versions and the tails as f32 PyTorch calls; B14 (``fused_resblock``,
LeakyReLU 0.2) beside its plain version and cuDNN's two convs +
``leaky_relu`` + add. Each with its per-kernel split (``torch.profiler``)
and its bound: operations at 3xTF32 (164.9 TFLOP/s) and on the FMA pipes
(66.9), bytes at 3.35 TB/s.

The other f32 kernels at their paths' shapes (skipped with
``--serving-only``): B11 (``fused_cab_body``; on the weights as the
checkout's ``prepare_hat_serving`` holds them, and on HWIO weights), B5 at
window 16 and B10 (``fused_ocab_block``) at HAT x4's f32 forward (one 256 x
256 map), B11 and B10 beside their plain versions, B9 (``attention_bwd`` at
window 16) and B12 / B13 (``oca_core_fwd`` / ``oca_core_bwd``) at HAT's f32
gradient check (batch 4 of 64 x 64 crops), B12 and B13 at HAT's f32
training step (batch 32: 512 windows), B15 (``window_attention``) at
MaxSR's adaptive and static shapes; B12, B13 and B15 beside SDPA in f32,
the others beside f32 PyTorch sequences; then B5 and B9 on the first design
at the f32 geometries no kernel took before it was restaged (C 264 / 12
heads at window 12 on batch 4 of 72 x 72 maps, C 256 / 4 heads at window 16
on batch 4 of 64 x 64; a checkout that raises on them records nothing).
With ``--attn-only`` only B13 (64 and 512 windows), B12 at 512 and B15 are
timed.

Prints one JSON line: {"package": path, "card": nvidia-smi's name and power
limit, "ms": {name: ms}, "passes": {name: [[kernel, ms], ...]}, "entries":
{name: C entries}, "bounds": {name: {...}}}. With ``--checkout DIR`` the
script runs itself on DIR, this tree, this tree and DIR (A, B, B, A on one
card), prints each line, then a table of the four.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import OrderedDict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))

TF32X3_TFLOPS, FMA_TFLOPS, HBM_TBS = 494.7 / 3, 66.9, 3.35
HP, C, HEADS, HIDDEN = 264, 180, 6, 360


def bounds(flops: float, nbytes: float) -> dict:
    return {"gflop": flops / 1e9, "mb": nbytes / 1e6, "tf32x3_ms": flops / TF32X3_TFLOPS / 1e9,
            "fma_ms": flops / FMA_TFLOPS / 1e9, "bytes_ms": nbytes / HBM_TBS / 1e9}


def swin_sequence(x, ops: dict, heads: int, shift: int):
    """The Swin block as a sequence of f32 PyTorch calls (roll and
    partition, ``F.layer_norm``, ``F.linear``, SDPA with the bias plus the
    shift mask, ``F.linear``, the MLP); ``ops`` dense, by B1's keywords."""
    import torch
    import torch.nn.functional as F

    from studiosr_tpu_torch.ops.windows import calculate_mask, window_partition, window_reverse

    bsz, h, w, c = x.shape
    n, d, ws = 64, c // heads, 8
    region = torch.from_numpy(calculate_mask((h, w), ws, shift)).to(x.device)
    mask = (ops["bias"].reshape(1, 1, heads, n, n) + region[None, :, None]).expand(bsz, -1, -1, -1, -1)
    mask = mask.reshape(-1, heads, n, n).contiguous()
    wq, wp, wa, wb = (ops[k].t().contiguous() for k in ("wqkv", "wproj", "w1", "w2"))

    def forward():
        xr = torch.roll(x, (-shift, -shift), (1, 2))
        xw = window_partition(xr, ws).reshape(-1, n, c)
        qkv = F.linear(F.layer_norm(xw, (c,), ops["ln1_w"], ops["ln1_b"], 1e-5), wq, ops["bqkv"])
        qkv = qkv.reshape(-1, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], attn_mask=mask)
        z = xr + window_reverse(F.linear(o.transpose(1, 2).reshape(-1, n, c), wp, ops["bproj"]).reshape(
            -1, ws, ws, c), ws, h, w)
        y = z + F.linear(F.gelu(F.linear(F.layer_norm(z, (c,), ops["ln2_w"], ops["ln2_b"], 1e-5), wa, ops["b1"])),
                         wb, ops["b2"])
        return torch.roll(y, (shift, shift), (1, 2))

    return forward


def tail_module(gen, dev, scale: int):
    """A stand-in for a SwinIR tail: ``upsample`` (conv0 [, conv1] with
    their shuffles) and ``conv_last`` at 64 channels, seeded."""
    import torch
    import torch.nn as nn

    s = 2 if scale == 4 else scale

    def conv(cin, cout):
        m = nn.Conv2d(cin, cout, 3, padding=1).to(dev)
        with torch.no_grad():
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * (9 * cin) ** -0.5)
            m.bias.copy_(torch.randn(cout, generator=gen) * 0.1)
        return m

    layers = [conv(64, s * s * 64), nn.PixelShuffle(s)]
    if scale == 4:
        layers += [conv(64, 4 * 64), nn.PixelShuffle(2)]
    up = nn.Sequential(OrderedDict((str(i), m) for i, m in enumerate(layers)))
    return nn.Module(), up, conv(64, 3)


def f32_tail_sequence(x, module, scale: int):
    """The tail as f32 PyTorch calls: ``F.conv2d`` (cuDNN, TF32 off) and
    ``F.pixel_shuffle``."""
    y = x.permute(0, 3, 1, 2)
    return module.conv_last(module.upsample(y)).permute(0, 2, 3, 1)


def measure_serving(dev, gen, ms: dict, passes: dict, entries: dict, bnd: dict) -> None:
    import torch
    import torch.nn.functional as F

    from studiosr_tpu_torch import SwinFIR, SwinIR
    from studiosr_tpu_torch.ops.cuda import engagement
    from studiosr_tpu_torch.ops.cuda.conv3x3 import (
        conv3x3_plain, fused_conv3x3, fused_resblock, prepare_conv3x3_weights, resblock_plain,
    )
    from studiosr_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
    from studiosr_tpu_torch.ops.cuda.swin_block import fused_swin_block, swin_block_plain
    from studiosr_tpu_torch.ops.cuda.upsampler import (
        fused_upsample_s, fused_upsample_x4, upsample_s_plain, upsample_x4_plain,
    )
    from studiosr_tpu_torch.ops.cuda.window_attention import fused_window_attention_block
    from studiosr_tpu_torch.ops.windows import relative_position_index
    from studiosr_tpu_torch.serving import swinir_fast
    from torch_time_attn_kernels import pass_split, time_ms

    f32 = torch.float32
    widths = dict(scale=4, embed_dim=C, num_heads=[HEADS], window_size=8, mlp_ratio=2.0)
    model = SwinIR.build(**widths, depths=[2], seed=0, device=dev)
    prep = swinir_fast.prepare_serving(model.module, model.config, f32)
    blk = model.module.layers[0].residual_group.blocks[1]
    x = torch.randn(1, HP, HP, C, generator=gen).to(dev)
    skip = torch.randn(1, HP, HP, C, generator=gen).to(dev)
    tokens = HP * HP

    def timed(name, kernel, entry_of=None):
        engagement.reset()
        ms[name] = time_ms(kernel)
        got = engagement.entries()
        entries[name] = got.get(entry_of or name.split(" ")[0], got)
        passes[name] = pass_split(kernel)

    # B1, as serving holds it; B5 then B6 and the plain version on the dense weights
    served = prep["blocks"][0][1]
    kw = dict(heads=HEADS, window_size=8, shift=4)
    dense = swinir_fast._b5_b6_operands(blk, HEADS, relative_position_index(8), f32)
    a, m = dense["attn"], dense["mlp"]
    ops = dict(ln1_w=a["ln_w"], ln1_b=a["ln_b"], wqkv=a["wqkv"], bqkv=a["bqkv"], wproj=a["wproj"],
               bproj=a["bproj"], bias=a["bias"], ln2_w=m["ln_w"], ln2_b=m["ln_b"], w1=m["w1"], b1=m["b1"],
               w2=m["w2"], b2=m["b2"])
    timed("fused_swin_block f32", lambda: fused_swin_block(x, **served, **kw))
    ms["fused_swin_block f32 plain"] = time_ms(lambda: swin_block_plain(x, **ops, **kw), iters=5, warmup=1)

    def b5_b6():
        y = fused_window_attention_block(x, **a, **kw)
        return fused_mlp_block(y.reshape(-1, C), **m)

    ms["fused_swin_block f32 yardstick (B5 f32 + B6 f32)"] = time_ms(b5_b6)
    passes["fused_swin_block f32 yardstick (B5 f32 + B6 f32)"] = pass_split(b5_b6)
    ms["fused_swin_block f32 library (f32 PyTorch sequence)"] = time_ms(swin_sequence(x, ops, HEADS, 4), iters=10)
    err = float((fused_swin_block(x, **served, **kw) - swin_block_plain(x, **ops, **kw)).abs().max())
    ms["fused_swin_block f32 max_abs_err"] = err
    flops = 2 * tokens * C * (3 * C + C + 2 * HIDDEN) + 4 * tokens * 64 * C
    bnd["fused_swin_block f32"] = bounds(flops, 2 * x.numel() * 4 + sum(t.numel() * 4 for t in ops.values()))

    # B2 on a RSTB conv, as serving holds it, with the skip map
    w, b = prep["convs"][0]
    hwio = prepare_conv3x3_weights(model.module.layers[0].conv.weight, f32)
    timed("fused_conv3x3 f32", lambda: fused_conv3x3(x, w, b, extra=skip))
    ms["fused_conv3x3 f32 plain"] = time_ms(lambda: conv3x3_plain(x, hwio, b, extra=skip), iters=10)
    w_oihw, x_nchw = hwio.permute(3, 2, 0, 1).contiguous(), x.permute(0, 3, 1, 2)
    ms["fused_conv3x3 f32 library (cuDNN conv2d + add, TF32 off)"] = time_ms(
        lambda: F.conv2d(x_nchw, w_oihw, b, padding=1).permute(0, 2, 3, 1) + skip)
    ms["fused_conv3x3 f32 max_abs_err"] = float(
        (fused_conv3x3(x, w, b, extra=skip) - conv3x3_plain(x, hwio, b, extra=skip)).abs().max())
    bnd["fused_conv3x3 f32"] = bounds(2 * tokens * 9 * C * C, 3 * x.numel() * 4 + hwio.numel() * 4)

    # B3 and B4 x2 / x3 on 264 x 264 x 64, their weights as serving holds them
    x64 = torch.randn(1, HP, HP, 64, generator=gen).to(dev)
    for scale in (4, 2, 3):
        mod, up, last = tail_module(gen, dev, scale)
        mod.upsample, mod.conv_last = up, last
        tail = swinir_fast.tail_operands(mod, scale, f32)
        hw = [t for name in (("0", "2") if scale == 4 else ("0",)) for t in (
            prepare_conv3x3_weights(up._modules[name].weight, f32), up._modules[name].bias.detach().float())]
        hw += [prepare_conv3x3_weights(last.weight, f32), last.bias.detach().float()]
        if scale == 4:
            name, kernel, plain = "fused_upsample_x4 f32", lambda: fused_upsample_x4(x64, *tail), \
                lambda: upsample_x4_plain(x64, *hw)
            s2 = 4
            flops = 2 * 9 * 64 * (tokens * 256 + 4 * tokens * 256 + 16 * tokens * 3)
        else:
            name, kernel, plain = f"fused_upsample_s x{scale} f32", \
                lambda t=tail, s=scale: fused_upsample_s(x64, *t, s), \
                lambda h_=hw, s=scale: upsample_s_plain(x64, *h_, s)
            s2 = scale * scale
            flops = 2 * 9 * 64 * (tokens * s2 * 64 + s2 * tokens * 3)
        timed(name, kernel, name.split(" ")[0])
        ms[f"{name} plain"] = time_ms(plain, iters=5, warmup=1)
        with torch.no_grad():
            ms[f"{name} library (f32 PyTorch sequence)"] = time_ms(lambda m_=mod, s=scale: f32_tail_sequence(
                x64, m_, s), iters=10)
        ms[f"{name} max_abs_err"] = float((kernel() - plain()).abs().max())
        scale_out = 16 if scale == 4 else s2
        bnd[name] = bounds(flops, x64.numel() * 4 + sum(t.numel() * 4 for t in hw) + scale_out * tokens * 3 * 4)
    del x64
    torch.cuda.empty_cache()

    # B14: SwinFIR's SFB spatial branch, as serving holds it
    fir = SwinFIR.build(**widths, depths=[1], seed=0, device=dev)
    res = swinir_fast.prepare_serving(fir.module, fir.config, f32)["convs"][0]
    body = fir.module.layers[0].conv.S.body._modules
    hw0, hw2 = (prepare_conv3x3_weights(body[k].weight, f32) for k in ("0", "2"))
    args = (res["s0"], res["b0"], res["s2"], res["b2"])
    timed("fused_resblock f32", lambda: fused_resblock(x, *args, activation="lrelu0.2"))
    ms["fused_resblock f32 plain"] = time_ms(
        lambda: resblock_plain(x, hw0, res["b0"], hw2, res["b2"], activation="lrelu0.2"), iters=10)
    o0, o2 = (t.permute(3, 2, 0, 1).contiguous() for t in (hw0, hw2))

    def resblock_library():
        h1 = F.leaky_relu(F.conv2d(x_nchw, o0, res["b0"], padding=1), 0.2)
        return x + F.conv2d(h1, o2, res["b2"], padding=1).permute(0, 2, 3, 1)

    ms["fused_resblock f32 library (cuDNN conv2d x2 + leaky_relu + add, TF32 off)"] = time_ms(resblock_library)
    ms["fused_resblock f32 max_abs_err"] = float(
        (fused_resblock(x, *args, activation="lrelu0.2")
         - resblock_plain(x, hw0, res["b0"], hw2, res["b2"], activation="lrelu0.2")).abs().max())
    bnd["fused_resblock f32"] = bounds(2 * 2 * tokens * 9 * C * C, 2 * x.numel() * 4 + 2 * hw0.numel() * 4)


def measure_others(dev, gen, ms: dict, passes: dict, entries: dict, bnd: dict) -> None:
    import torch

    from studiosr_tpu_torch.ops.cuda import engagement
    from studiosr_tpu_torch.ops.cuda.attn_bwd import attention_bwd
    from studiosr_tpu_torch.ops.cuda.conv3x3 import cab_body_plain, fused_cab_body
    from studiosr_tpu_torch.ops.cuda.ocab import fused_ocab_block, ocab_plain
    from studiosr_tpu_torch.ops.cuda.window_attention import fused_window_attention_block
    from torch_time_attn_kernels import (
        attention_half_forward_sequence, attention_half_sequence, ocab_forward_sequence, pass_split, time_ms,
    )
    from torch_time_conv_kernels import cab_sequence

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def timed(name, key, kernel):
        engagement.reset()
        ms[name] = time_ms(kernel, iters=10)
        entries[name] = engagement.entries().get(key)
        passes[name] = pass_split(kernel, calls=3)

    # HAT x4's f32 forward: one 256 x 256 map
    xs = randn(1, 256, 256, C)
    cab = [1 + randn(C, scale=0.1), randn(C, scale=0.1), randn(3, 3, C, 60, scale=(9 * C) ** -0.5),
           randn(60, scale=0.1), randn(3, 3, 60, C, scale=(9 * 60) ** -0.5), randn(C, scale=0.1)]
    cab_seq = cab[:2] + [t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t for t in cab[2:]]
    served = list(cab)  # as serving holds them: a checkout with B11's f32 kernel packs its convs at load time
    try:
        from studiosr_tpu_torch.ops.cuda.conv3x3 import cab_f32_mma_takes, pack_cab_f32_convs

        if cab_f32_mma_takes(C, 60):
            served[2], served[4] = pack_cab_f32_convs(cab[2], cab[4])
    except ImportError:
        pass
    timed("fused_cab_body f32", "fused_cab_body", lambda: fused_cab_body(xs, *served))
    timed("fused_cab_body f32 HWIO", "fused_cab_body", lambda: fused_cab_body(xs, *cab))
    ms["fused_cab_body f32 plain"] = time_ms(lambda: cab_body_plain(xs, *cab), iters=5, warmup=1)
    ms["fused_cab_body f32 library (f32 PyTorch sequence)"] = time_ms(lambda: cab_sequence(xs, *cab_seq), iters=10)
    ms["fused_cab_body f32 max_abs_err"] = float((fused_cab_body(xs, *served)[0] - cab_body_plain(xs, *cab)[0]).abs(
    ).max())
    bnd["fused_cab_body f32"] = bounds(2 * 2 * 65536 * 9 * C * 60, 2 * xs.numel() * 4)

    ws = 16
    dense = (1 + randn(C, scale=0.1), randn(C, scale=0.1), randn(C, 3 * C, scale=C**-0.5), randn(3 * C, scale=0.1),
             randn(C, C, scale=C**-0.5), randn(C, scale=0.1), randn(HEADS, ws * ws, ws * ws, scale=0.5))
    kw = dict(heads=HEADS, window_size=ws, shift=8)
    timed("fused_window_attention_block_ws16 f32", "fused_window_attention_block_ws16",
          lambda: fused_window_attention_block(xs, *dense, **kw))
    ms["fused_window_attention_block_ws16 f32 library (f32 PyTorch sequence)"] = time_ms(
        attention_half_forward_sequence(xs, dense, HEADS, ws, 8, None, dtype=torch.float32), iters=10)
    bnd["fused_window_attention_block_ws16 f32"] = bounds(2 * 65536 * C * 4 * C + 4 * 65536 * 256 * C,
                                                         2 * xs.numel() * 4)

    ocab_ops = (1 + randn(C, scale=0.1), randn(C, scale=0.1), randn(C, 3 * C, scale=C**-0.5), randn(3 * C, scale=0.1),
                randn(C, C, scale=C**-0.5), randn(C, scale=0.1), randn(HEADS, 256, 576, scale=0.5),
                1 + randn(C, scale=0.1), randn(C, scale=0.1), randn(C, 2 * C, scale=C**-0.5), randn(2 * C, scale=0.1),
                randn(2 * C, C, scale=(2 * C)**-0.5), randn(C, scale=0.1))
    okw = dict(heads=HEADS, window_size=16, overlap_ratio=0.5)
    timed("fused_ocab_block f32", "fused_ocab_block", lambda: fused_ocab_block(xs, *ocab_ops, **okw))
    ms["fused_ocab_block f32 plain"] = time_ms(lambda: ocab_plain(xs, *ocab_ops, **okw), iters=3, warmup=1)
    ms["fused_ocab_block f32 max_abs_err"] = float(
        (fused_ocab_block(xs, *ocab_ops, **okw) - ocab_plain(xs, *ocab_ops, **okw)).abs().max())
    seq = ocab_forward_sequence(xs, ocab_ops, HEADS, 16, 0.5, dtype=torch.float32)
    ms["fused_ocab_block f32 library (f32 PyTorch sequence)"] = time_ms(seq, iters=10)
    t = 65536
    bnd["fused_ocab_block f32"] = bounds(2 * t * C * 3 * C + 4 * t * 576 * C + 2 * t * C * C + 4 * t * C * 2 * C,
                                        2 * xs.numel() * 4)
    del xs
    torch.cuda.empty_cache()

    # HAT's f32 gradient check: batch 4 of 64 x 64 crops
    x, g = randn(4, 64, 64, C), randn(4, 64, 64, C, scale=1e-3)
    dp = torch.full((4,), 1 / 0.9, device=dev)
    dp[0] = 0.0
    akw = dict(heads=HEADS, window_size=ws, shift=8, drop_path=dp)
    timed("attention_bwd_ws16 f32", "attention_bwd_ws16", lambda: attention_bwd(x, g, *dense, **akw))
    ms["attention_bwd_ws16 f32 library (f32 PyTorch sequence)"] = time_ms(
        attention_half_sequence(x, g, dense, HEADS, ws, 8, dp, dtype=torch.float32), iters=5, warmup=2)
    t = 4 * 64 * 64
    bnd["attention_bwd_ws16 f32"] = bounds(3 * 2 * t * C * 3 * C + 2 * 2 * t * C * C + 12 * t * 256 * C,
                                          3 * x.numel() * 4)

    measure_attn(dev, gen, ms, passes, entries, bnd, fwd=True)
    measure_first_design(dev, gen, ms, passes, entries, bnd)


def measure_first_design(dev, gen, ms: dict, passes: dict, entries: dict, bnd: dict) -> None:
    """B5 and B9 in f32 on the first design (``window_attention16_f32``,
    ``attn_bwd16_f32``) at C 264 / 12 heads, window 12, and C 256 / 4
    heads, window 16; nothing where the checkout raises on them."""
    import torch

    from studiosr_tpu_torch.ops.cuda import engagement
    from studiosr_tpu_torch.ops.cuda.attn_bwd import attention_bwd
    from studiosr_tpu_torch.ops.cuda.window_attention import fused_window_attention_block
    from torch_time_attn_kernels import pass_split, time_ms

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    for c, heads, ws, side in ((264, 12, 12, 72), (256, 4, 16, 64)):
        x, g = randn(4, side, side, c), randn(4, side, side, c, scale=1e-3)
        ops = (1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5), randn(3 * c, scale=0.1),
               randn(c, c, scale=c**-0.5), randn(c, scale=0.1), randn(heads, ws * ws, ws * ws, scale=0.5))
        kw = dict(heads=heads, window_size=ws, shift=ws // 2)
        t, n = 4 * side * side, ws * ws
        for name, key, kernel, flops in (
                (f"fused_window_attention_block_ws16 f32 C {c} window {ws}", "fused_window_attention_block_ws16",
                 lambda: fused_window_attention_block(x, *ops, **kw), 2 * t * c * 4 * c + 4 * t * n * c),
                (f"attention_bwd_ws16 f32 C {c} window {ws}", "attention_bwd_ws16",
                 lambda: attention_bwd(x, g, *ops, **kw),
                 3 * 2 * t * c * 3 * c + 2 * 2 * t * c * c + 12 * t * n * c)):
            try:
                kernel()
            except NotImplementedError:
                continue
            engagement.reset()
            ms[name] = time_ms(kernel, iters=5)
            entries[name] = engagement.entries().get(key)
            passes[name] = pass_split(kernel, calls=2)
            bnd[name] = bounds(flops, 2 * x.numel() * 4)
        del x, g
        torch.cuda.empty_cache()


def measure_attn(dev, gen, ms: dict, passes: dict, entries: dict, bnd: dict, fwd: bool = False) -> None:
    """B13 (and with ``fwd`` B12) at HAT's f32 gradient check (64 windows)
    and B13 at its f32 training step (512 windows), each beside SDPA's f32
    backward; B15 at MaxSR x4's f32 shapes beside SDPA f32."""
    import torch
    import torch.nn.functional as F

    from studiosr_tpu_torch.ops.cuda import engagement
    from studiosr_tpu_torch.ops.cuda.oca_core import oca_core_bwd, oca_core_fwd
    from studiosr_tpu_torch.ops.cuda.window_attn import window_attention
    from torch_time_attn_kernels import pass_split, time_ms

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def timed(name, key, kernel, iters=10):
        engagement.reset()
        ms[name] = time_ms(kernel, iters=iters)
        entries[name] = engagement.entries().get(key)
        passes[name] = pass_split(kernel, calls=3)

    for bw, tag in ((64, ""), (512, " bw512")):
        def view(n, scale):  # (bw, 6, n, 30) over (bw, n, 6, 30) storage, as the OCAB's views
            return randn(bw, n, HEADS, 30, scale=scale).transpose(1, 2)

        q, k, v, go = view(256, 2 * 30**-0.5), view(576, 1.0), view(576, 1.0), view(256, 1.0)
        bias = randn(HEADS, 256, 576, scale=2.0)
        nqk = bw * HEADS * 256 * 576 * 30
        qkvb = (q.numel() + k.numel() + v.numel() + bias.numel()) * 4
        if fwd or tag:  # B12 at the gradient check (with fwd) and at the f32 step's 512 windows
            timed(f"oca_core_fwd f32{tag}", "oca_core_fwd", lambda: oca_core_fwd(q, k, v, bias))
            bnd[f"oca_core_fwd f32{tag}"] = bounds(4 * nqk, qkvb + q.numel() * 4)
        timed(f"oca_core_bwd f32{tag}", "oca_core_bwd", lambda: oca_core_bwd(q, k, v, bias, go), iters=10 if not tag else 5)
        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=1.0), iters=5)
        if fwd or tag:
            ms[f"oca_core_fwd f32{tag} library (SDPA)"] = sdpa_fwd
        leaves = [t_.detach().requires_grad_() for t_ in (q, k, v, bias)]

        def sdpa_both():
            out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=1.0)
            torch.autograd.grad(out, leaves, go)

        ms[f"oca_core_bwd f32{tag} library (SDPA backward)"] = time_ms(sdpa_both, iters=3, warmup=1) - sdpa_fwd
        bnd[f"oca_core_bwd f32{tag}"] = bounds(10 * nqk, qkvb + (q.numel() * 3 + k.numel() + v.numel() +
                                                                 bias.numel()) * 4)
        del q, k, v, go, leaves, bias
        torch.cuda.empty_cache()

    # B15 at MaxSR x4's f32 forward: adaptive (256 windows of 256) and static (1024 of 64, with a bias)
    for mode, windows, n, with_bias in (("adaptive", 256, 256, False), ("static", 1024, 64, True)):
        qkv = randn(windows, n, 3, 4, 32).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * 32**-0.5, qkv[1], qkv[2]
        bias = randn(4, n, n) if with_bias else None
        name = f"window_attention {mode} f32"
        timed(name, "window_attention_pallas", lambda: window_attention(q, k, v, bias=bias))
        ms[f"{name} library (SDPA)"] = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=1.0), iters=10)
        bnd[name] = bounds(4 * windows * 4 * n * n * 32, 4 * q.numel() * 4)


def measure(serving_only: bool, attn_only: bool = False) -> dict:
    import torch

    if "PYTHONPATH" not in os.environ:
        sys.path.insert(0, str(ROOT))
    import studiosr_tpu_torch
    from studiosr_tpu_torch import resolve_device
    from studiosr_tpu_torch.ops.cuda import _build
    from torch_time_attn_kernels import card_line

    dev = resolve_device("cuda")  # TF32 off for cuBLAS and cuDNN
    _build.build()
    gen = torch.Generator().manual_seed(0)
    ms, passes, entries, bnd = {}, {}, {}, {}
    if attn_only:
        measure_attn(dev, gen, ms, passes, entries, bnd)
    else:
        with torch.no_grad():
            measure_serving(dev, gen, ms, passes, entries, bnd)
        torch.cuda.empty_cache()
        if not serving_only:
            measure_others(dev, gen, ms, passes, entries, bnd)
    return {"package": studiosr_tpu_torch.__file__, "card": card_line(), "ms": ms, "passes": passes,
            "entries": {k: str(v) for k, v in entries.items()}, "bounds": bnd}


def ab(checkout: Path, extra: list) -> None:
    """Run this script on ``checkout``, this tree, this tree, ``checkout``."""
    runs = []
    for label, tree in (("parent", checkout), ("change", ROOT), ("change", ROOT), ("parent", checkout)):
        env = dict(os.environ, PYTHONPATH=str(tree))
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), *extra], env=env, cwd=tree,
                             capture_output=True, text=True, check=True, timeout=1800).stdout
        line = json.loads(out.strip().splitlines()[-1])
        print(json.dumps({"run": label, **line}), flush=True)
        runs.append((label, line))
    print("ms, " + " / ".join(label for label, _ in runs))
    for name in dict.fromkeys(k for _, line in runs for k in line["ms"]):  # a name only one tree times too
        print(f"  {name}: " + " / ".join(f"{line['ms'].get(name, float('nan')):.4f}" for _, line in runs))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", type=Path, help="a second checkout to compare with: parent, this, this, parent")
    only = parser.add_mutually_exclusive_group()
    only.add_argument("--serving-only", action="store_true", help="time only B1, B2, B3, B4 and B14")
    only.add_argument("--attn-only", action="store_true", help="time only B13 and B15")
    args = parser.parse_args()
    if args.checkout:
        ab(args.checkout.resolve(), ["--serving-only"] if args.serving_only else ["--attn-only"] if args.attn_only else [])
    else:
        print(json.dumps(measure(args.serving_only, args.attn_only)))


if __name__ == "__main__":
    main()
