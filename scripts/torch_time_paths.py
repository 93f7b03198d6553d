#!/usr/bin/env python3
"""Time the port's end-to-end paths on one NVIDIA GPU.

    PYTHONPATH=<checkout> python3 scripts/torch_time_paths.py [--only PATH ...]

Times, as ``chip_smoke.py`` does (CUDA events, 2 warm-up calls, seeded
random weights at full width): the SwinIR x4, HAT x4, SwinFIR x4, MaxSR
x4 (adaptive and static, the JAX package's ``build`` defaults), SwinIR
x2 and x3 and HAT x2 and x3 forward, and SwinIR x4 at window 24 (its 256 x 256
image padded to 264 x 264)
(bf16, batch 1, a 256 x 256 uint8 image, fused serving) over 5 forwards,
the SwinIR x4, SwinFIR x4 and MaxSR x4 (both modes) forward in f32, fused
(and for SwinIR and SwinFIR plain; TF32 off), and the SwinIR x4 and HAT x4 train step (``make_train_step``, bf16 over f32 masters, batch
32 of 64 x 64 crops, fused_train; HAT also at window 24, the crops padded
to 72 x 72: 288 windows a step; HAT also in f32, ``bfloat16=False``), the
MaxSR x4 adaptive train step (the same bf16 recipe) and the SwinFIR x4 train
step at its f32 recipe
(``bfloat16=False``, fused_train) over 5 steps (``--only`` names a subset), and prints one JSON line:
{"package": path, "card": nvidia-smi's name and power limit, "ms": {path:
ms}, "peak_gib": {train step: peak memory over its timed steps}}. A checkout whose HAT has no fused training path reads null there. The
package is whichever ``studiosr_tpu_torch`` is first on the path, so running
it with ``PYTHONPATH`` set to two checkouts in turn (A, B, B, A) compares
them on one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

import studiosr_tpu_torch
from studiosr_tpu_torch import HAT, MaxSR, SwinFIR, SwinIR, resolve_device
from studiosr_tpu_torch.parallel import build_optimizer, make_train_step, prepare_state
from studiosr_tpu_torch.utils import l1_loss

WIDTHS = dict(scale=4, embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, mlp_ratio=2.0, drop_path_rate=0.1)
HAT_WIDTHS = dict(window_size=16, compress_ratio=3, squeeze_factor=30, conv_scale=0.01, overlap_ratio=0.5)
MAXSR_WIDTHS = dict(scale=4, dim=128, dim_head=32, depth=[4] * 4, window_size=8, dropout=0.1)


def time_ms(fn, iters: int = 5, warmup: int = 2) -> float:
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


def build(name: str, dev: torch.device, **kw):
    if name == "hat ws24":
        return HAT.build(**WIDTHS, **{**HAT_WIDTHS, "window_size": 24}, seed=0, device=dev, **kw)
    if name == "swinir ws24":
        return SwinIR.build(**WIDTHS, window_size=24, seed=0, device=dev, **kw)
    scale = int(name[-1]) if name[-1].isdigit() else 4  # "swinir x2", "hat x3", ...
    if name.startswith("swinir"):
        return SwinIR.build(**{**WIDTHS, "scale": scale}, window_size=8, seed=0, device=dev, **kw)
    if name == "swinfir":
        return SwinFIR.build(**WIDTHS, window_size=8, seed=0, device=dev, **kw)
    if name.startswith("maxsr"):
        return MaxSR.build(**MAXSR_WIDTHS, adaptive=name.endswith("adaptive"), seed=0, device=dev, **kw)
    return HAT.build(**{**WIDTHS, "scale": scale}, **HAT_WIDTHS, seed=0, device=dev, **kw)


def forward_ms(name: str, dev: torch.device) -> float:
    """bf16 fused; "<model> f32" fused in f32, "<model> f32 plain" the plain
    port forward in f32 (TF32 off)."""
    f32, plain = " f32" in name, name.endswith(" plain")
    model = build(name.split(" f32")[0], dev)
    model = (model if f32 else model.half()).enable_fused(not plain)
    image = np.random.default_rng(0).integers(0, 256, (256, 256, 3), dtype=np.uint8)
    x = torch.from_numpy(image).to(dev).float()[None] / 255.0
    with torch.inference_mode():
        return time_ms(lambda: model(x))


def step_ms(name: str, dev: torch.device):
    """"<model>" at its recipe's dtype; "<model> f32" in f32 (``bfloat16=False``)."""
    f32 = name.endswith(" f32")
    base = name[:-len(" f32")] if f32 else name
    try:
        module = build(base, dev, fused_train=True).module
    except NotImplementedError:
        return None
    tx = build_optimizer()
    state = prepare_state(module, tx)
    step = make_train_step(module, tx, l1_loss, bfloat16=not f32 and base != "swinfir")  # SwinFIR's recipe trains in f32
    rng = np.random.default_rng(4)
    lq = torch.from_numpy(rng.integers(0, 256, (32, 64, 64, 3), dtype=np.uint8)).to(dev)
    gt = torch.from_numpy(rng.integers(0, 256, (32, 256, 256, 3), dtype=np.uint8)).to(dev)
    gen = torch.Generator().manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: step(state, lq, gt, gen))
    PEAK[name] = torch.cuda.max_memory_allocated() / 2**30
    return ms


PEAK: dict = {}


PATHS = ("swinir forward", "swinir ws24 forward", "swinir train step", "hat forward", "hat train step", "hat ws24 train step",
         "swinfir forward", "swinfir train step", "maxsr adaptive train step",
         "maxsr adaptive forward", "maxsr static forward", "swinir x2 forward", "swinir x3 forward",
         "hat x2 forward", "hat x3 forward", "swinir f32 forward", "swinir f32 plain forward",
         "swinfir f32 forward", "swinfir f32 plain forward", "hat f32 train step", "maxsr adaptive f32 forward",
         "maxsr static f32 forward")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", nargs="+", choices=PATHS, default=PATHS, metavar="PATH",
                        help=f"time only these paths, of: {', '.join(PATHS)}")
    args = parser.parse_args()
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    ms = {}
    for path in PATHS:
        if path in args.only:
            name = path.rsplit(" ", 2 if path.endswith("train step") else 1)[0]
            ms[path] = step_ms(name, dev) if path.endswith("train step") else forward_ms(name, dev)
            torch.cuda.empty_cache()
    peak = {f"{name} train step": gib for name, gib in PEAK.items()}
    print(json.dumps({"package": str(studiosr_tpu_torch.__file__), "card": card, "ms": ms, "peak_gib": peak}))


if __name__ == "__main__":
    main()
