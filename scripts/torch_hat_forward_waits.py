#!/usr/bin/env python3
"""Where a HAT x4 forward's wall time goes beyond its kernels, on one NVIDIA GPU.

    PYTHONPATH=<checkout> python3 scripts/torch_hat_forward_waits.py

HAT x4 at XPixelGroup/HAT ``options/test/HAT_SRx4.yml`` widths (bf16,
batch 1, a 256 x 256 input, fused serving, random weights from a seed),
after 3 warm-up forwards: eight runs of 5 forwards each by CUDA events
(ms a forward, so the spread shows), the host's ms to enqueue a forward,
and one forward under ``torch.profiler``: the device's busy ms (the
kernels' device times summed; one stream) and the host-side CUDA calls
that copy, set or wait (``cudaMemcpyAsync``, ``cudaStreamSynchronize``,
...) with their counts, and nvidia-smi's name and power limit. The
package is whichever ``studiosr_tpu_torch`` is first on the path, so
running it with ``PYTHONPATH`` set to two checkouts in turn (A, B, B, A)
compares them on one card. Prints one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from studiosr_tpu_torch import HAT, resolve_device

HAT_SRX4 = dict(scale=4, embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=16, mlp_ratio=2.0,
                compress_ratio=3, squeeze_factor=30, conv_scale=0.01, overlap_ratio=0.5)


def main() -> None:
    dev = resolve_device("cuda")
    model = HAT.build(**HAT_SRX4, seed=0, device=dev).half().enable_fused(True)
    x = torch.rand(1, 256, 256, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.inference_mode():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        runs = []
        for _ in range(8):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                model(x)
            end.record()
            torch.cuda.synchronize()
            runs.append(round(start.elapsed_time(end) / 5, 2))
        t0 = time.perf_counter()
        for _ in range(5):
            model(x)
        host_enqueue = (time.perf_counter() - t0) / 5 * 1e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    events = prof.key_averages()
    calls = {e.key: e.count for e in events
             if e.device_type.name == "CPU" and ("ync" in e.key or "emcpy" in e.key or "Memset" in e.key)}
    busy = sum(e.self_device_time_total for e in events if e.device_type.name == "CUDA") / 1e3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"package": sys.modules["studiosr_tpu_torch"].__file__, "card": card,
                      "fwd_ms_runs": runs, "host_enqueue_ms": round(host_enqueue, 2),
                      "sync_memcpy_events": calls, "device_busy_ms": round(busy, 2)}))


if __name__ == "__main__":
    main()
