#!/usr/bin/env python3
"""Device time of each CUDA kernel inside the port's training kernels B5-B8,
and of a whole training step.

    python3 scripts/torch_profile_train_kernels.py

1. One launch of each wrapper (B5, B6, B7, B8) runs at the training step's
   shapes (SwinIR x4 width: C 180, 6 heads, batch 32 of 64x64 maps, bf16,
   one drop-path scale 0) under ``torch.profiler``; the script prints, per
   wrapper, the device time of every kernel it enqueued (the weight pack,
   the per-window or per-tile pass, the weight-gradient GEMMs, the
   reductions), averaged over 5 calls after 2 warm-up calls.
2. Three steps of ``make_train_step`` (SwinIR x4 full width, the batch-32
   recipe, bf16, fused_train) after 2 warm-up steps: host ms a step, the
   device's busy ms a step (the kernels' device times summed; one stream)
   and so its idle share, and the kernels that take the most device time.

Prints the card's name and power limit first. Needs a CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from studiosr_tpu_torch import SwinIR, resolve_device  # noqa: E402
from studiosr_tpu_torch.ops.cuda.attn_bwd import attention_bwd  # noqa: E402
from studiosr_tpu_torch.ops.cuda.mlp_block import fused_mlp_block  # noqa: E402
from studiosr_tpu_torch.ops.cuda.mlp_bwd import mlp_bwd  # noqa: E402
from studiosr_tpu_torch.ops.cuda.window_attention import fused_window_attention_block  # noqa: E402
from studiosr_tpu_torch.parallel import build_optimizer, make_train_step, prepare_state  # noqa: E402
from studiosr_tpu_torch.utils import l1_loss  # noqa: E402

B, S, C, HEADS, CALLS, STEPS = 32, 64, 180, 6, 5, 3


def _device_kernels(prof):
    return [e for e in prof.key_averages() if e.device_type.name == "CUDA" and e.device_time_total > 0]


def profile_step(dev: torch.device) -> None:
    model = SwinIR.build(scale=4, embed_dim=C, depths=[6] * 6, num_heads=[HEADS] * 6, window_size=8, mlp_ratio=2.0,
                         drop_path_rate=0.1, device=dev)
    module = model.module
    module.fused_train = True
    tx = build_optimizer()
    state = prepare_state(module, tx)
    step = make_train_step(module, tx, l1_loss, bfloat16=True)
    rng = torch.Generator().manual_seed(1)
    lq = torch.randint(0, 256, (B, S, S, 3), generator=rng, dtype=torch.uint8).to(dev)
    gt = torch.randint(0, 256, (B, 4 * S, 4 * S, 3), generator=rng, dtype=torch.uint8).to(dev)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        step(state, lq, gt, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(state, lq, gt, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / STEPS * 1e3
    kernels = _device_kernels(prof)
    busy = sum(e.device_time_total for e in kernels) / STEPS / 1e3
    launches = sum(e.count for e in kernels) / STEPS
    print(f"train step (profiled): host {wall:.1f} ms a step, device busy {busy:.1f} ms "
          f"({100 * (1 - busy / wall):.1f} % idle), {launches:.0f} device kernels a step")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:15]:
        print(f"  {e.device_time_total / STEPS / 1e3:8.3f} ms  x{e.count // STEPS:<5} {e.key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    gen = torch.Generator().manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    x, g = randn(B, S, S, C), randn(B, S, S, C, scale=1e-3)
    attn = (1 + randn(C, scale=0.1, dtype=f32), randn(C, scale=0.1, dtype=f32), randn(C, 3 * C, scale=C**-0.5),
            randn(3 * C, scale=0.1, dtype=f32), randn(C, C, scale=C**-0.5), randn(C, scale=0.1, dtype=f32),
            randn(HEADS, 64, 64, scale=0.5, dtype=f32))
    mlp = (1 + randn(C, scale=0.1, dtype=f32), randn(C, scale=0.1, dtype=f32), randn(C, 2 * C, scale=C**-0.5),
           randn(2 * C, scale=0.1, dtype=f32), randn(2 * C, C, scale=(2 * C) ** -0.5))
    b2 = randn(C, scale=0.1, dtype=f32)
    dp = torch.full((B,), 1 / 0.9, device=dev)
    dp[0] = 0.0
    rows = (x.reshape(-1, C), g.reshape(-1, C))
    akw = dict(heads=HEADS, window_size=8, shift=4, drop_path=dp)
    mkw = dict(drop_path=dp, rows_per_sample=S * S)
    cases = {
        "B5 fused_window_attention_block": lambda: fused_window_attention_block(x, *attn, **akw),
        "B6 fused_mlp_block": lambda: fused_mlp_block(rows[0], *mlp, b2, **mkw),
        "B7 mlp_bwd": lambda: mlp_bwd(*rows, *mlp, **mkw),
        "B8 attention_bwd": lambda: attention_bwd(x, g, *attn, **akw),
    }
    for name, fn in cases.items():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        rows_ = _device_kernels(prof)
        total = sum(e.device_time_total for e in rows_) / CALLS / 1e3
        print(f"{name}: {total:.3f} ms device time a call")
        for e in sorted(rows_, key=lambda e: -e.device_time_total):
            print(f"  {e.device_time_total / CALLS / 1e3:8.3f} ms  x{e.count // CALLS:<3} {e.key[:110]}")
    profile_step(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
