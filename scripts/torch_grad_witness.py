#!/usr/bin/env python3
"""Training gradients of the port against an f64 witness, over several seeds.

    python3 scripts/torch_grad_witness.py [--model swinir|hat] [--seeds 0 1 2]

Needs one CUDA card; builds the kernels first. For each seed it runs
``chip_smoke.train_grads`` (SwinIR classical x4, or HAT_SRx4, at full
width, batch 4 of 64x64 crops, drop_path_rate 0.1): plain autograd of the
port's model in f64 (the witness), plain and fused-train in f32, plain and
fused-train with bf16 copies of the weights; and logs each run's loss and per-parameter
gradient error against the witness (``chip_smoke.grad_report``), the
rel-pos bias tables apart, and the output pixels whose L1 sign differs
from the witness's. Ends with one JSON line of the worst and median
per-parameter errors of each run, tables and the rest, over all seeds,
and the flipped signs of each seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("swinir", "hat"), default="swinir")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = parser.parse_args()
    dev = chip_smoke.phase_device()
    chip_smoke.phase_build()
    summary: dict = {}
    for seed in args.seeds:
        if args.model == "swinir":
            model = chip_smoke.SwinIR.build(**chip_smoke.TRAIN_MODEL, seed=seed, device=dev)
        else:
            model = chip_smoke.HAT.build(**chip_smoke.HAT_TRAIN_MODEL, seed=seed, device=dev)
        report = chip_smoke.grad_report(chip_smoke.train_grads(model, dev, seed), seed, f"{args.model} ")
        del model
        for (path, dtype), r in report.items():
            entry = summary.setdefault(f"{path} {str(dtype)[6:]}",
                                       {"tables": [], "others": [], "loss": [], "flipped": []})
            entry["loss"].append(r["loss"])
            entry["flipped"].append(r["flipped"])
            for k, v in r["params"].items():
                entry["tables" if k.endswith("bias_table") else "others"].append(v)
    out = {
        run: {
            "seeds": args.seeds,
            "loss_worst": max(e["loss"]),
            "flipped": e["flipped"],
            **{f"{part}_{stat}": float(fn(e[part])) for part in ("tables", "others")
               for stat, fn in (("worst", np.max), ("median", np.median))},
        }
        for run, e in summary.items()
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
