#!/usr/bin/env python3
"""Where the time goes in a bf16 forward of each conv family, and whether
cuDNN takes the NHWC maps with no layout copies.

    python3 scripts/torch_profile_conv_models.py [--models edsr rcan ...]

Each model (SRCNN, ESPCN, VDSR, SRResNet, EDSR, RCAN, HAN, IMDN by default)
at its ``build`` defaults, x4, bf16, batch 1, 256x256 LR input, random
weights from a seed: three forwards after two warm-up forwards under
``torch.profiler``. Prints, per model, the host ms a forward, the device's
busy ms a forward (the kernels' device times summed; one stream) and its
idle share, the device kernels a forward, the share of device time in
layout kernels (cuDNN's ``nchwToNhwc`` / ``nhwcToNchw`` conversions, its
channel padding, transposes and copies: a conv that did not take the
channels-last view as it lies would add conversions around every call)
with their count a forward, the host's copy operators (``aten::copy_``,
``aten::contiguous``, ``aten::clone``) by input shape, which tells a
weight's copy from a map's, and the kernels that take the most device
time (cuDNN's NHWC implicit-GEMM convs show ``nhwc`` in their names). The
port's convolutions hand cuDNN the NHWC activation as a channels-last NCHW
view (``models/blocks.py`` ``Conv``). Prints the card's name and power
limit first. Needs a CUDA card.
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

from studiosr_tpu_torch import resolve_device  # noqa: E402
from studiosr_tpu_torch.zoo.registry import get_model_class  # noqa: E402

FAMILIES = ("srcnn", "espcn", "vdsr", "srresnet", "edsr", "rcan", "han", "imdn")
LAYOUT = ("nchwtonhwc", "nhwctonchw", "addpadding", "transpose", "copy")
S, FORWARDS = 256, 3


def profile_model(name: str, dev: torch.device) -> None:
    model = get_model_class(name).build(scale=4, seed=0, device=dev).half()
    x = torch.rand(1, S, S, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    for _ in range(2):
        model(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(FORWARDS):
            model(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / FORWARDS * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and e.device_time_total > 0]
    busy = sum(e.device_time_total for e in kernels) / FORWARDS / 1e3
    layout = [e for e in kernels if any(word in e.key.lower() for word in LAYOUT)]
    layout_ms = sum(e.device_time_total for e in layout) / FORWARDS / 1e3
    print(f"\n{name} x4 bf16 {S}x{S} ({sum(p.numel() for p in model.module.parameters())} parameters): host "
          f"{wall:.3f} ms a forward, device busy {busy:.3f} ms ({100 * (1 - busy / wall):.1f} % idle), "
          f"{sum(e.count for e in kernels) / FORWARDS:.0f} device kernels a forward; layout kernels "
          f"{layout_ms:.3f} ms ({100 * layout_ms / busy:.1f} % of busy), "
          f"{sum(e.count for e in layout) / FORWARDS:.0f} a forward")
    for e in layout:
        print(f"  layout {e.device_time_total / FORWARDS / 1e3:8.3f} ms  x{e.count // FORWARDS:<5} {e.key[:100]}")
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key in ("aten::copy_", "aten::contiguous", "aten::clone"):
            print(f"  host op {e.key} x{e.count // FORWARDS:<5} inputs {str(e.input_shapes)[:100]}")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:8]:
        print(f"  {e.device_time_total / FORWARDS / 1e3:8.3f} ms  x{e.count // FORWARDS:<5} {e.key[:100]}")
    del model
    torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--models", nargs="*", default=list(FAMILIES))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for name in args.models:
        profile_model(name, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
