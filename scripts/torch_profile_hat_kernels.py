#!/usr/bin/env python3
"""Device time of each CUDA kernel inside the port's HAT serving kernels, and
of a whole HAT x4 forward.

    python3 scripts/torch_profile_hat_kernels.py

1. One launch of each wrapper (B11 ``fused_cab_body``, B5 at window 16
   (shift 8), B6 with ``extra``, B10 ``fused_ocab_block``) runs at HAT
   serving's shapes (a 256x256 map, C 180, 6 heads, bf16) under
   ``torch.profiler``; the script prints, per wrapper, the device time of
   every kernel it enqueued (the weight pack, the LayerNorm and projection
   passes, the attention pass, the convs, the MLP), averaged over 5 calls
   after 2 warm-up calls.
2. Three forwards of HAT x4 at XPixelGroup/HAT ``options/test/HAT_SRx4.yml``
   (bf16, batch 1, 256x256 LR input, fused) after 2 warm-up forwards: host
   ms a forward, the device's busy ms a forward (the kernels' device times
   summed; one stream) and so its idle share, and the kernels that take the
   most device time.

Weights are random from a seed. Prints the card's name and power limit
first. Needs a CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from studiosr_tpu_torch import HAT, resolve_device  # noqa: E402
from studiosr_tpu_torch.ops.cuda.conv3x3 import fused_cab_body  # noqa: E402
from studiosr_tpu_torch.ops.cuda.mlp_block import fused_mlp_block  # noqa: E402
from studiosr_tpu_torch.ops.cuda.ocab import fused_ocab_block  # noqa: E402
from studiosr_tpu_torch.ops.cuda.window_attention import fused_window_attention_block  # noqa: E402
from studiosr_tpu_torch.serving.hat_fast import prepare_hat_serving  # noqa: E402

S, C, HEADS, CALLS, FORWARDS = 256, 180, 6, 5, 3
HAT_SRX4 = dict(scale=4, embed_dim=C, depths=[6] * 6, num_heads=[HEADS] * 6, window_size=16, mlp_ratio=2.0,
                compress_ratio=3, squeeze_factor=30, conv_scale=0.01, overlap_ratio=0.5)


def _device_kernels(prof):
    return [e for e in prof.key_averages() if e.device_type.name == "CUDA" and e.device_time_total > 0]


def profile_forward(model: HAT, dev: torch.device) -> None:
    x = torch.rand(1, S, S, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    for _ in range(2):
        model(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(FORWARDS):
            model(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / FORWARDS * 1e3
    kernels = _device_kernels(prof)
    busy = sum(e.device_time_total for e in kernels) / FORWARDS / 1e3
    launches = sum(e.count for e in kernels) / FORWARDS
    print(f"HAT x4 forward (profiled): host {wall:.1f} ms a forward, device busy {busy:.1f} ms "
          f"({100 * (1 - busy / wall):.1f} % idle), {launches:.0f} device kernels a forward")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:15]:
        print(f"  {e.device_time_total / FORWARDS / 1e3:8.3f} ms  x{e.count // FORWARDS:<5} {e.key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    model = HAT.build(**HAT_SRX4, seed=0, device=dev).half().enable_fused(True)
    prep = prepare_hat_serving(model.module, model.config, torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, S, S, C, generator=gen).to(dev, torch.bfloat16)
    extra = torch.randn(S * S, C, generator=gen).to(dev, torch.bfloat16)
    escale = torch.rand(C, generator=gen).to(dev)
    blocks = prep["blocks"][0]
    cases = {
        "B11 fused_cab_body": lambda: fused_cab_body(x, *blocks[0]["cab"].values()),
        "B5 fused_window_attention_block (window 16, shift 8)": lambda: fused_window_attention_block(
            x, *blocks[1]["attn"].values(), heads=HEADS, window_size=16, shift=8),
        "B6 fused_mlp_block (extra)": lambda: fused_mlp_block(
            x.reshape(-1, C), *blocks[0]["mlp"].values(), extra=extra, extra_scale=escale),
        "B10 fused_ocab_block": lambda: fused_ocab_block(
            x, *prep["ocab"][0].values(), heads=HEADS, window_size=16, overlap_ratio=0.5),
    }
    for name, fn in cases.items():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        rows = _device_kernels(prof)
        total = sum(e.device_time_total for e in rows) / CALLS / 1e3
        print(f"{name}: {total:.3f} ms device time a call")
        for e in sorted(rows, key=lambda e: -e.device_time_total):
            print(f"  {e.device_time_total / CALLS / 1e3:8.3f} ms  x{e.count // CALLS:<3} {e.key[:110]}")
    profile_forward(model, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
