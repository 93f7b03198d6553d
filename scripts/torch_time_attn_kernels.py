#!/usr/bin/env python3
"""Time the port's attention-core kernels on one NVIDIA GPU.

    PYTHONPATH=<checkout> python3 scripts/torch_time_attn_kernels.py

Times, in bf16 with seeded operands, by CUDA events over 20 launches after 3
warm-up launches: B15 (``window_attention``) at MaxSR x4's two serving
shapes (adaptive: 256 windows of 256 tokens, no bias; static: 1024 windows
of 64 tokens, a (4, 64, 64) bias; 4 heads of 32, q, k, v the slices of one
projection) with ``F.scaled_dot_product_attention`` on the same operands as
the library yardstick (the bias as its mask), and the kernels that share
``csrc/attn_core.cuh`` at HAT x4 training's batch-32 shapes: B9
(``attention_bwd`` at window 16, shift 8, 180 channels, 6 heads), B12 and
B13 (``oca_core_fwd`` / ``oca_core_bwd`` on 512 windows, 6 heads, 256
queries, 576 keys, d 30, the OCAB's transposed views). Prints one JSON line:
{"package": path, "card": nvidia-smi's name and power limit, "ms": {kernel:
ms}}. Run with ``PYTHONPATH`` set to two checkouts in turn (A, B, B, A) to
compare them on one card.
"""

from __future__ import annotations

import json
import subprocess

import torch
import torch.nn.functional as F

import studiosr_tpu_torch
from studiosr_tpu_torch import resolve_device
from studiosr_tpu_torch.ops.cuda.attn_bwd import attention_bwd
from studiosr_tpu_torch.ops.cuda.oca_core import oca_core_bwd, oca_core_fwd
from studiosr_tpu_torch.ops.cuda.window_attn import window_attention


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

    ms = {}
    for mode, windows, n, with_bias in (("adaptive", 256, 256, False), ("static", 1024, 64, True)):
        qkv = randn(windows, n, 3, 4, 32).to(bf).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * 32**-0.5, qkv[1], qkv[2]
        bias = randn(4, n, n) if with_bias else None
        mask = None if bias is None else bias.to(bf)
        ms[f"window_attention {mode}"] = time_ms(lambda: window_attention(q, k, v, bias=bias))
        ms[f"window_attention {mode} library (SDPA)"] = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0))

    c, heads = 180, 6
    x, g = randn(32, 64, 64, c).to(bf), randn(32, 64, 64, c, scale=1e-3).to(bf)
    attn_ops = (1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5).to(bf),
                randn(3 * c, scale=0.1), randn(c, c, scale=c**-0.5).to(bf), randn(c, scale=0.1),
                randn(heads, 256, 256, scale=0.5))
    dp = torch.full((32,), 1 / 0.9, device=dev)
    dp[0] = 0.0
    ms["attention_bwd_ws16"] = time_ms(
        lambda: attention_bwd(x, g, *attn_ops, heads=heads, window_size=16, shift=8, drop_path=dp))

    def view(n, scale):  # (512, 6, n, 30) over (512, n, 6, 30) storage, as the OCAB's views
        return randn(512, n, heads, 30, scale=scale).to(bf).transpose(1, 2)

    q, k, v, go = view(256, 2 * 30**-0.5), view(576, 1.0), view(576, 1.0), view(256, 1.0)
    bias = randn(heads, 256, 576, scale=2.0)
    ms["oca_core_fwd"] = time_ms(lambda: oca_core_fwd(q, k, v, bias))
    ms["oca_core_bwd"] = time_ms(lambda: oca_core_bwd(q, k, v, bias, go))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"package": studiosr_tpu_torch.__file__, "card": card, "ms": ms}))


if __name__ == "__main__":
    main()
