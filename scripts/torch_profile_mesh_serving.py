#!/usr/bin/env python3
"""Where tiled serving over a mesh spends its wall time, on one NVIDIA GPU.

    python3 scripts/torch_profile_mesh_serving.py [--slots N]

SwinIR x4 (classical: embed 180, depths [6]x6, 6 heads, window 8) at a
1024 x 1024 LR image and HAT x4 (``HAT_SRx4.yml``'s widths, window 16) at
512 x 512, bf16 fused serving, random weights from a seed, through
``tiled_inference`` (tile 128, overlap 16, batch 8), each in the device loop
and the host loop, without a mesh and over a mesh of ``--slots`` slots of
this card (default 2: each slot a replica with its own host thread and
CUDA stream). After a warm-up call of each route, one call under
``torch.profiler``: its wall seconds (host clock, synchronised before and
after), the device's busy seconds (the union of the kernels' intervals, so
two streams running at once count once), the kernels' device seconds
summed, the idle share (1 - busy / wall), and the host-side CUDA calls that
copy or wait (``cudaStreamSynchronize``, ``cudaMemcpyAsync``, ...) with
their counts. Prints nvidia-smi's name and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from studiosr_tpu_torch import HAT, SwinIR, resolve_device  # noqa: E402
from studiosr_tpu_torch.parallel import get_mesh, tiled_inference  # noqa: E402

SWINIR = dict(scale=4, embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=8, mlp_ratio=2.0)
HAT_SRX4 = dict(scale=4, embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=16, mlp_ratio=2.0,
                compress_ratio=3, squeeze_factor=30, conv_scale=0.01, overlap_ratio=0.5)
TILED = dict(tile=128, tile_overlap=16, tile_batch=8)


def busy_seconds(intervals) -> float:
    """The length of the union of (start, end) intervals, in seconds (µs in)."""
    total, reach = 0.0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total / 1e6


def profiled(run) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = busy_seconds([(e.time_range.start, e.time_range.end) for e in kernels])
    calls = {}
    for e in prof.events():
        if e.device_type.name == "CPU" and e.name.startswith("cuda") and ("ync" in e.name or "emcpy" in e.name):
            calls[e.name] = calls.get(e.name, 0) + 1
    return {"wall_s": round(wall, 4), "device_busy_s": round(busy, 4),
            "kernel_s_summed": round(sum(e.time_range.elapsed_us() for e in kernels) / 1e6, 4),
            "idle_share": round(1 - busy / wall, 3), "kernels": len(kernels), "sync_copy_calls": calls}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--slots", type=int, default=2)
    args = parser.parse_args()
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    mesh = get_mesh([torch.device("cuda", torch.cuda.current_device())] * args.slots)
    rng = np.random.default_rng(0)
    out = {"card": card, "slots": args.slots}
    for name, cls, config, side in (("swinir", SwinIR, SWINIR, 1024), ("hat", HAT, HAT_SRX4, 512)):
        model = cls.build(**config, seed=0, device=dev).half().enable_fused(True)
        image = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
        for loop in (True, False):
            for route, kw in (("mesh-less", {}), (f"{args.slots} slots", {"mesh": mesh})):
                run = lambda: tiled_inference(model, image, device_loop=loop, **TILED, **kw)  # noqa: E731
                run()
                key = f"{name} {side}² {'device' if loop else 'host'} loop, {route}"
                out[key] = profiled(run)
                print(key, out[key], flush=True)
        del model
        torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
