#!/usr/bin/env python3
"""What bounds B5 and B6 in f32: time variants of their kernels.

    python3 scripts/torch_ablate_f32_fwd.py [--only VARIANT ...]

Each variant is the checkout's ``csrc/window_attention_f32.cu`` and
``csrc/mlp_block_f32.cu`` (with their headers) after the substitutions
listed below, built by nvcc with the port's flags into
``build/ablate/f32_fwd/<variant>/`` (all at once) and launched through the
port's own wrappers (``fused_window_attention_block``, ``fused_mlp_block``)
in f32 at SwinFIR's training step: batch 32 of 64 x 64 maps, C 180, 6
heads, window 8 shift 4, hidden 360, drop-path scales (0, 1/0.9, ...). For
each, ``torch.profiler`` over 10 calls gives the device time of every
kernel a call enqueues, and the output's largest error against the plain
version relative to the plain output's largest value. A variant that drops
work computes wrong values and only bounds the time of what remains. Prints
one line a variant and kernel, and then one JSON line: {"card": nvidia-smi's
name and power limit, "passes": {variant: {kernel: [[kernel name, launches,
ms], ...]}}, "errors": {variant: {kernel: relative error}}, "registers":
{variant: {kernel name: ptxas's registers}}, "spills": {variant: {kernel
name: ptxas's spill stores in bytes}}}.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from studiosr_tpu_torch import resolve_device  # noqa: E402
from studiosr_tpu_torch.ops.cuda import _build  # noqa: E402
from studiosr_tpu_torch.ops.cuda import mlp_block as mbk  # noqa: E402
from studiosr_tpu_torch.ops.cuda import window_attention as wa  # noqa: E402
from torch_time_attn_kernels import pass_split  # noqa: E402

OUT = _build.BUILD_DIR.parent / "ablate" / "f32_fwd"
HDR, ATTN = "tf32x3.cuh", "window_attention_f32.cu"
SOURCES = (("window_attention_f32", wa), ("mlp_block_f32", mbk))
STAGES = "constexpr int TFW_STAGES = 2;"
BLOCKS = "constexpr int WA32_BLOCKS = 3;"
TERMS = ("      tfw_rs<BN>(part, al[kk], bh, kk > 0);\n      tfw_rs<BN>(part, ah[kk], bl, 1);\n"
         "      tfw_rs<BN>(part, ah[kk], bh, 1);\n")
SMALL_TERMS = "  tf_mma(d, al, bh);\n  tf_mma(e, cl, fh);\n  tf_mma(d, ah, bl);\n  tf_mma(e, ch, fl);\n"
# (variant, [(file, text, replacement)]): each text must occur in its file.
VARIANTS = [
    ("full", []),
    ("row products: three stages (two blocks an SM)", [(HDR, STAGES, "constexpr int TFW_STAGES = 3;")]),
    ("row products: 64-column tiles",
     [(HDR, "inline int tfw_bn(int N) { return (N + 95) / 96 * 96 <= (N + 63) / 64 * 64 ? 96 : 64; }",
       "inline int tfw_bn(int N) { return 64; }")]),
    ("attention pass: four blocks an SM", [(ATTN, BLOCKS, "constexpr int WA32_BLOCKS = 4;")]),
    ("attention pass: two blocks an SM", [(ATTN, BLOCKS, "constexpr int WA32_BLOCKS = 2;")]),
    # every product a single TF32 term (not f32): what the two correction terms cost
    ("products: one TF32 term (not f32)", [(HDR, TERMS, "      tfw_rs<BN>(part, ah[kk], bh, kk > 0);\n"),
                                           (HDR, SMALL_TERMS, "")]),
]


def _ptxas(log: str) -> tuple:
    """({kernel<template args>: registers}, {kernel<template args>: spill
    stores in bytes}) from an nvcc -Xptxas -v log."""
    regs, spills, fn, spill = {}, {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            length = re.match(r"_Z(\d+)", fn)
            kernel = fn[length.end():length.end() + int(length.group(1))] if length else fn
            key = f"{kernel}<{','.join(re.findall(r'Li(\d+)E', fn))}>"
            while key in regs:
                key += "'"
            regs[key], spills[key] = int(m.group(1)), spill
            fn = None
    return regs, spills


def build_all(only, variants=VARIANTS, sources=SOURCES, out=OUT, kernels=None) -> dict:
    """{variant: ({source: library}, registers, spills)}, every variant of
    ``variants`` compiled at once into ``out``: each of ``sources`` ((C
    source, its wrapper module), whose ``_SIGNATURES_F32`` bind it) built
    from a copy of the checkout's csrc with the variant's substitutions;
    ptxas's figures of the kernels whose names contain one of ``kernels``
    (all by default)."""
    shutil.rmtree(out, ignore_errors=True)
    jobs = []
    for i, (name, subs) in enumerate(variants):
        if only and name not in only:
            continue
        d = out / f"v{i}"
        d.mkdir(parents=True)
        for p in _build.CSRC.glob("*.cu*"):
            shutil.copy(p, d / p.name)
        for target, old, new in subs:
            text = (d / target).read_text()
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in {target}")
            (d / target).write_text(text.replace(old, new))
        for src, _ in sources:
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / f"{src}.so"), str(d / f"{src}.cu")]
            jobs.append((name, d, src, subprocess.Popen(cmd, stdout=open(d / f"{src}.log", "w"),
                                                        stderr=subprocess.STDOUT)))
    for name, d, src, proc in jobs:
        if proc.wait() != 0:
            raise SystemExit(f"{name}: nvcc failed on {src}\n{(d / f'{src}.log').read_text()[-3000:]}")
    libs = {}
    keep = (lambda k: True) if kernels is None else (lambda k: any(n in k for n in kernels))  # noqa: E731
    for i, (name, _) in enumerate(variants):
        d = out / f"v{i}"
        if not d.exists():
            continue
        built, regs, spills = {}, {}, {}
        for src, module in sources:
            lib = ctypes.CDLL(str(d / f"{src}.so"))
            for fn, args in module._SIGNATURES_F32.items():
                getattr(lib, fn).argtypes = list(args)
                getattr(lib, fn).restype = module._RESTYPES_F32.get(fn, ctypes.c_int)
            built[src] = lib
            r, s = _ptxas((d / f"{src}.log").read_text())
            regs.update({f"{src}: {k}": v for k, v in r.items() if keep(k)})
            spills.update({f"{src}: {k}": v for k, v in s.items() if keep(k)})
        libs[name] = (built, regs, spills)
    return libs


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", nargs="+", metavar="VARIANT", help="build and time only these variants")
    args = parser.parse_args()
    dev = resolve_device("cuda")
    libs = build_all(args.only)
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    b, s, c, heads, hidden = 32, 64, 180, 6, 360
    x = randn(b, s, s, c)
    attn = (1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5), randn(3 * c, scale=0.1),
            randn(c, c, scale=c**-0.5), randn(c, scale=0.1), randn(heads, 64, 64, scale=0.5))
    mlp = (1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, hidden, scale=c**-0.5), randn(hidden, scale=0.1),
           randn(hidden, c, scale=hidden**-0.5), randn(c, scale=0.1))
    dp = torch.full((b,), 1 / 0.9, device=dev)
    dp[0] = 0.0
    akw = dict(heads=heads, window_size=8, shift=4, drop_path=dp)
    xr = x.reshape(-1, c)
    mkw = dict(drop_path=dp, rows_per_sample=s * s)
    cases = {"fused_window_attention_block": (lambda: wa.fused_window_attention_block(x, *attn, **akw),
                                              wa.window_attention_plain(x, *attn, **akw)),
             "fused_mlp_block": (lambda: mbk.fused_mlp_block(xr, *mlp, **mkw), mbk.mlp_block_plain(xr, *mlp, **mkw))}
    passes, errors, registers, spills = {}, {}, {}, {}
    load = _build.load
    try:
        for name, (built, regs, spill) in libs.items():
            _build.load = lambda src, *_, built=built: built[src]
            passes[name], errors[name], registers[name], spills[name] = {}, {}, regs, spill
            for kernel, (fn, want) in cases.items():
                got = fn()
                torch.cuda.synchronize()
                errors[name][kernel] = float((got - want).abs().max() / want.abs().max())
                passes[name][kernel] = pass_split(fn)
                total = sum(t for _, _, t in passes[name][kernel])
                print(f"{name} | {kernel}: {total:.4f} ms; relative error {errors[name][kernel]:.2e}; " + "; ".join(
                    f"{n.split('(')[0]} x{k:g} {t:.4f}" for n, k, t in passes[name][kernel]), flush=True)
            print(f"{name} | registers {regs}; spill stores {spill}", flush=True)
    finally:
        _build.load = load
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "passes": passes, "errors": errors, "registers": registers, "spills": spills}))


if __name__ == "__main__":
    main()
