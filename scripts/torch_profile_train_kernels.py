#!/usr/bin/env python3
"""Device time of each CUDA kernel inside the port's training kernels, and
of a whole training step.

    python3 scripts/torch_profile_train_kernels.py [--model swinir|hat|maxsr|swinfir] [--f32]

1. One launch of each wrapper runs at the training step's shapes (C 180, 6
   heads, batch 32 of 64x64 maps, bf16, one drop-path scale 0) under
   ``torch.profiler``: for SwinIR x4 B5, B6, B7, B8 (window 8); for HAT_SRx4
   B5 and B9 at window 16, B6, B7, and B12, B13 on the OCAB's (512 windows,
   6 heads, 256 queries, 576 keys, d 30) transposed views; for MaxSR x4 (the
   build defaults) B5, B6, B7, B8 at C 128, 4 heads, hidden 512, window 8,
   shift 0, no drop-path, zero qkv and proj biases. The script
   prints, per wrapper, the device time of every kernel it enqueued (the
   weight pack, the projection, attention and LN passes, the
   weight-gradient GEMMs, the reductions), averaged over 5 calls after 2
   warm-up calls.
2. Three steps of ``make_train_step`` (the model at full width, the
   batch-32 recipe, bf16 (SwinFIR f32), fused_train) after 2 warm-up steps: host ms a
   step, the device's busy ms a step (the kernels' device times summed; one
   stream) and so its idle share, the device kernels a step, and the
   kernels that take the most device time.

``--f32`` runs both in f32: the wrappers' operands and the step
(``bfloat16=False``, the JAX Trainer's f32 recipe; SwinFIR's always is).
Prints the card's name and power limit first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from studiosr_tpu_torch import HAT, MaxSR, SwinFIR, SwinIR, resolve_device  # noqa: E402
from studiosr_tpu_torch.ops.cuda.attn_bwd import attention_bwd  # noqa: E402
from studiosr_tpu_torch.ops.cuda.mlp_block import fused_mlp_block  # noqa: E402
from studiosr_tpu_torch.ops.cuda.mlp_bwd import mlp_bwd  # noqa: E402
from studiosr_tpu_torch.ops.cuda.oca_core import oca_core_bwd, oca_core_fwd  # noqa: E402
from studiosr_tpu_torch.ops.cuda.window_attention import fused_window_attention_block  # noqa: E402
from studiosr_tpu_torch.parallel import build_optimizer, make_train_step, prepare_state  # noqa: E402
from studiosr_tpu_torch.utils import l1_loss  # noqa: E402

B, S, C, HEADS, CALLS, STEPS = 32, 64, 180, 6, 5, 3
TOP = {"swinfir": 40}  # the step's kernels listed (SwinFIR: its SFBs' convs and FFTs beside B5-B8; f32 30)


def _device_kernels(prof):
    return [e for e in prof.key_averages() if e.device_type.name == "CUDA" and e.device_time_total > 0]


def profile_step(dev: torch.device, name: str, f32: bool) -> None:
    if name == "swinir":
        model = SwinIR.build(scale=4, embed_dim=C, depths=[6] * 6, num_heads=[HEADS] * 6, window_size=8,
                             mlp_ratio=2.0, drop_path_rate=0.1, device=dev)
    elif name == "swinfir":
        model = SwinFIR.build(scale=4, embed_dim=C, depths=[6] * 6, num_heads=[HEADS] * 6, window_size=8,
                              mlp_ratio=2.0, drop_path_rate=0.1, device=dev)
    elif name == "maxsr":
        model = MaxSR.build(scale=4, device=dev)
    else:
        model = HAT.build(scale=4, embed_dim=C, depths=[6] * 6, num_heads=[HEADS] * 6, window_size=16, mlp_ratio=2.0,
                          compress_ratio=3, squeeze_factor=30, conv_scale=0.01, overlap_ratio=0.5,
                          drop_path_rate=0.1, device=dev)
    module = model.module
    module.fused_train = True
    tx = build_optimizer()
    state = prepare_state(module, tx)
    step = make_train_step(module, tx, l1_loss, bfloat16=not f32)
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
    print(f"{name}{' f32' if f32 else ''} train step (profiled): host {wall:.1f} ms a step, device busy {busy:.1f} ms "
          f"({100 * (1 - busy / wall):.1f} % idle), {launches:.0f} device kernels a step")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:TOP.get(name, 30 if f32 else 15)]:
        print(f"  {e.device_time_total / STEPS / 1e3:8.3f} ms  x{e.count // STEPS:<5} {e.key[:100]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("swinir", "hat", "maxsr", "swinfir"), default="swinir")
    parser.add_argument("--f32", action="store_true", help="the wrappers and the step in f32 (SwinFIR's always are)")
    args = parser.parse_args()
    f32_step = args.f32 or args.model == "swinfir"  # SwinFIR's recipe trains in f32
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    gen = torch.Generator().manual_seed(0)
    f32 = torch.float32
    bf = f32 if f32_step else torch.bfloat16  # the kernels' operands in the step's dtype

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    maxsr = args.model == "maxsr"
    c, heads, hidden = (128, 4, 512) if maxsr else (C, HEADS, 2 * C)
    x, g = randn(B, S, S, c), randn(B, S, S, c, scale=1e-3)
    ws = 16 if args.model == "hat" else 8
    attn = [1 + randn(c, scale=0.1, dtype=f32), randn(c, scale=0.1, dtype=f32), randn(c, 3 * c, scale=c**-0.5),
            randn(3 * c, scale=0.1, dtype=f32), randn(c, c, scale=c**-0.5), randn(c, scale=0.1, dtype=f32),
            randn(heads, ws * ws, ws * ws, scale=0.5, dtype=f32)]
    mlp = (1 + randn(c, scale=0.1, dtype=f32), randn(c, scale=0.1, dtype=f32), randn(c, hidden, scale=c**-0.5),
           randn(hidden, scale=0.1, dtype=f32), randn(hidden, c, scale=hidden**-0.5))
    b2 = randn(c, scale=0.1, dtype=f32)
    dp = torch.full((B,), 1 / 0.9, device=dev)
    dp[0] = 0.0
    if maxsr:  # MaxSR's pairs: no drop-path, no qkv / proj bias, no shift
        dp, attn[3], attn[5] = None, torch.zeros_like(attn[3]), torch.zeros_like(attn[5])
    rows = (x.reshape(-1, c), g.reshape(-1, c))
    akw = dict(heads=heads, window_size=ws, shift=0 if maxsr else ws // 2, drop_path=dp)
    mkw = dict(drop_path=dp, rows_per_sample=S * S)
    cases = {
        f"B5 fused_window_attention_block (window {ws})": lambda: fused_window_attention_block(x, *attn, **akw),
        "B6 fused_mlp_block": lambda: fused_mlp_block(rows[0], *mlp, b2, **mkw),
        "B7 mlp_bwd": lambda: mlp_bwd(*rows, *mlp, **mkw),
        f"{'B8' if ws == 8 else 'B9'} attention_bwd (window {ws})": lambda: attention_bwd(x, g, *attn, **akw),
    }
    if args.model == "hat":
        bw, d = B * (S // ws) ** 2, C // HEADS

        def view(n):  # the OCAB's (bw, heads, n, d) views of (bw, n, heads, d) storage
            return randn(bw, n, HEADS, d).transpose(1, 2)

        q, k, v, go = view(256), view(576), view(576), view(256)
        bias = randn(HEADS, 256, 576, scale=0.5, dtype=f32)
        cases["B12 oca_core_fwd"] = lambda: oca_core_fwd(q, k, v, bias)
        cases["B13 oca_core_bwd"] = lambda: oca_core_bwd(q, k, v, bias, go)
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
    profile_step(dev, args.model, f32_step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
