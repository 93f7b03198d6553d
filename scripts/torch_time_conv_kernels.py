#!/usr/bin/env python3
"""Time the kernels built on ``csrc/conv3x3.cuh`` on one NVIDIA GPU.

    PYTHONPATH=<checkout> python3 scripts/torch_time_conv_kernels.py

Times B2 (``fused_conv3x3`` with the skip map, SwinIR serving's 264 x 264 x
180 map), B3 (``fused_upsample_x4``, 264 x 264 x 64) and B11
(``fused_cab_body``, HAT serving's 256 x 256 x 180 map, 180 -> 60 -> 180) in
bf16 with seeded operands, by CUDA events over 20 launches after 3 warm-up
launches, and prints one JSON line: {"package": path, "card": nvidia-smi's
name and power limit, "ms": {kernel: ms}}. The package is whichever
``studiosr_tpu_torch`` is first on the path, so running it with
``PYTHONPATH`` set to two checkouts in turn (A, B, B, A) compares them on one
card.
"""

from __future__ import annotations

import json
import subprocess

import torch

import studiosr_tpu_torch
from studiosr_tpu_torch import resolve_device
from studiosr_tpu_torch.ops.cuda.conv3x3 import fused_cab_body, fused_conv3x3
from studiosr_tpu_torch.ops.cuda.upsampler import fused_upsample_x4


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

    x = randn(1, 264, 264, 180).to(bf)
    w, b = randn(3, 3, 180, 180, scale=(9 * 180) ** -0.5).to(bf), randn(180, scale=0.1)
    x64 = randn(1, 264, 264, 64).to(bf)
    tail = [randn(3, 3, 64, 256, scale=(9 * 64) ** -0.5).to(bf), randn(256, scale=0.1),
            randn(3, 3, 64, 256, scale=(9 * 64) ** -0.5).to(bf), randn(256, scale=0.1),
            randn(3, 3, 64, 3, scale=(9 * 64) ** -0.5).to(bf), randn(3, scale=0.1)]
    h = randn(1, 256, 256, 180).to(bf)
    cab = [1 + randn(180, scale=0.1), randn(180, scale=0.1), randn(3, 3, 180, 60, scale=(9 * 180) ** -0.5).to(bf),
           randn(60, scale=0.1), randn(3, 3, 60, 180, scale=(9 * 60) ** -0.5).to(bf), randn(180, scale=0.1)]
    ms = {
        "fused_conv3x3": time_ms(lambda: fused_conv3x3(x, w, b, extra=x)),
        "fused_upsample_x4": time_ms(lambda: fused_upsample_x4(x64, *tail)),
        "fused_cab_body": time_ms(lambda: fused_cab_body(h, *cab)),
    }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"package": studiosr_tpu_torch.__file__, "card": card, "ms": ms}))


if __name__ == "__main__":
    main()
