#!/usr/bin/env python3
"""Time the port's convolution kernels and B1 on one NVIDIA GPU.

    PYTHONPATH=<checkout> python3 scripts/torch_time_conv_kernels.py

Times, in bf16 with seeded operands, by CUDA events over 20 launches after 3
warm-up launches: B2 (``fused_conv3x3`` with the skip map, SwinIR serving's
264 x 264 x 180 map, its weights laid out as the checkout's serving path
lays them out: ``prepare_fused_conv3x3_weights`` where the checkout has it,
else HWIO) and its library yardstick (cuDNN's ``F.conv2d`` + add,
channels-last), B3 (``fused_upsample_x4``, 264 x 264 x 64), B4
(``fused_upsample_s`` at x2 and x3, 264 x 264 x 64), B11
(``fused_cab_body``, HAT serving's 256 x 256 x 180 map, 180 -> 60 -> 180) and
B14 (``fused_resblock``, SwinFIR's 264 x 264 x 180 map, LeakyReLU 0.2, its
weights packed as the checkout's serving path packs them where its B14
takes packed weights, else HWIO) beside cuDNN's two convs + LeakyReLU +
add, and B1 (``fused_swin_block``, the main path's 264 x 264 x 180 map, 6
heads, hidden 360, shift 4, its weights packed once where the checkout has
``pack_swin_weights``, else dense), and prints one JSON line: {"package": path, "card": nvidia-smi's name and power
limit, "ms": {kernel: ms}}. The package is whichever ``studiosr_tpu_torch``
is first on the path, so running it with ``PYTHONPATH`` set to two checkouts
in turn (A, B, B, A) compares them on one card.
"""

from __future__ import annotations

import json
import subprocess

import torch
import torch.nn.functional as F

import studiosr_tpu_torch
from studiosr_tpu_torch import resolve_device
from studiosr_tpu_torch.ops.cuda import conv3x3, swin_block
from studiosr_tpu_torch.ops.cuda.conv3x3 import fused_cab_body, fused_conv3x3, fused_resblock
from studiosr_tpu_torch.ops.cuda.swin_block import fused_swin_block
from studiosr_tpu_torch.ops.cuda.upsampler import fused_upsample_s, fused_upsample_x4


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    dev = resolve_device("cuda")
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def conv_w(cin, cout):
        return randn(3, 3, cin, cout, scale=(9 * cin) ** -0.5).to(bf), randn(cout, scale=0.1)

    x = randn(1, 264, 264, 180).to(bf)
    w, b = conv_w(180, 180)
    w_oihw, b_lib, x_nchw = w.permute(3, 2, 0, 1).contiguous(), b.to(bf), x.permute(0, 3, 1, 2)
    prepare = getattr(conv3x3, "prepare_fused_conv3x3_weights", conv3x3.prepare_conv3x3_weights)
    w_b2 = prepare(w_oihw, bf)
    x64 = randn(1, 264, 264, 64).to(bf)
    tail = [*conv_w(64, 256), *conv_w(64, 256), *conv_w(64, 3)]
    tail_s = {s: [*conv_w(64, s * s * 64), *conv_w(64, 3)] for s in (2, 3)}
    h = randn(1, 256, 256, 180).to(bf)
    cab = [1 + randn(180, scale=0.1), randn(180, scale=0.1), *conv_w(180, 60), *conv_w(60, 180)]
    res = [*conv_w(180, 180), *conv_w(180, 180)]
    res_oihw = [t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t.to(bf) for t in res]
    if "resblock_mma_bf16" in getattr(conv3x3, "_RES_SIGNATURES", {}):  # B14 reads packed weights
        res = [conv3x3.pack_conv3x3_weights(t) if t.dim() == 4 else t for t in res]

    def resblock_library():
        h1 = F.leaky_relu(F.conv2d(x_nchw, res_oihw[0], res_oihw[1], padding=1), 0.2)
        return x + F.conv2d(h1, res_oihw[2], res_oihw[3], padding=1).permute(0, 2, 3, 1)

    c, heads, hidden = 180, 6, 360
    block = [1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5).to(bf),
             randn(3 * c, scale=0.1), randn(c, c, scale=c**-0.5).to(bf), randn(c, scale=0.1),
             randn(heads, 64, 64, scale=0.5), 1 + randn(c, scale=0.1), randn(c, scale=0.1),
             randn(c, hidden, scale=c**-0.5).to(bf), randn(hidden, scale=0.1),
             randn(hidden, c, scale=hidden**-0.5).to(bf), randn(c, scale=0.1)]
    if hasattr(swin_block, "pack_swin_weights"):  # packed once, as serving holds them
        packed = swin_block.pack_swin_weights(block[2], block[4], block[6], block[9], block[11], heads)
        block = [packed if i == 2 else None if i in (4, 6, 9, 11) else t for i, t in enumerate(block)]
    ms = {
        "fused_conv3x3": time_ms(lambda: fused_conv3x3(x, w_b2, b, extra=x)),
        "fused_conv3x3 library (cuDNN conv2d + add)": time_ms(
            lambda: F.conv2d(x_nchw, w_oihw, b_lib, padding=1).permute(0, 2, 3, 1) + x),
        "fused_upsample_x4": time_ms(lambda: fused_upsample_x4(x64, *tail)),
        "fused_upsample_s x2": time_ms(lambda: fused_upsample_s(x64, *tail_s[2], 2)),
        "fused_upsample_s x3": time_ms(lambda: fused_upsample_s(x64, *tail_s[3], 3)),
        "fused_cab_body": time_ms(lambda: fused_cab_body(h, *cab)),
        "fused_resblock": time_ms(lambda: fused_resblock(x, *res, activation="lrelu0.2")),
        "fused_resblock library (cuDNN conv2d x2 + leaky_relu + add)": time_ms(resblock_library),
        "fused_swin_block": time_ms(lambda: fused_swin_block(x, *block, heads=heads, window_size=8, shift=4)),
    }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"package": studiosr_tpu_torch.__file__, "card": card, "ms": ms}))


if __name__ == "__main__":
    main()
