#!/usr/bin/env python3
"""What bounds B8 and B7 in f32: time variants of their kernels.

    python3 scripts/torch_ablate_f32_bwd.py [--only VARIANT ...]

Each variant is the checkout's ``csrc/attn_bwd_f32.cu`` and
``csrc/mlp_bwd_f32.cu`` (with their headers) after the substitutions listed
below, built by nvcc with the port's flags into
``build/ablate/f32_bwd/<variant>/`` (all at once) and launched through the
port's own wrappers (``attention_bwd``, ``mlp_bwd``) in f32 at SwinFIR's
training step: batch 32 of 64 x 64 maps, C 180, 6 heads, window 8 shift 4,
hidden 360, drop-path scales (0, 1/0.9, ...). For each, ``torch.profiler``
over 10 calls gives the device time of every kernel a call enqueues, and
each output's largest error against the plain version relative to the
plain output's largest value. Variants that drop work, or change a layout
the wrappers' packing mirrors (the row products' tile width), compute wrong
values and only bound the time of what remains. Prints one line a variant and
then one JSON line: {"card": nvidia-smi's name and power limit, "passes":
{variant: {kernel: [[kernel name, launches, ms], ...]}}, "errors":
{variant: {kernel: [relative error of each output]}}, "registers":
{variant: ptxas's register counts of the product kernel}}.
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
from studiosr_tpu_torch.ops.cuda import attn_bwd as ab  # noqa: E402
from studiosr_tpu_torch.ops.cuda import mlp_bwd as mb  # noqa: E402
from torch_time_attn_kernels import pass_split  # noqa: E402

OUT = _build.BUILD_DIR.parent / "ablate" / "f32_bwd"
HDR, ATTN = "tf32x3.cuh", "attn_bwd_f32.cu"
WG_MT = "constexpr int TF_WGRAD_MT = 3;"
W_STAGES = "constexpr int TFW_STAGES = 2;"
TERMS = ("      tfw_rs<BN>(part, al[kk], bh, kk > 0);\n      tfw_rs<BN>(part, ah[kk], bl, 1);\n"
         "      tfw_rs<BN>(part, ah[kk], bh, 1);\n")
WG_PART_ZERO = """#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
"""
WG_PART_ADD = """#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
"""
WG_TERM = "        for (int nt = 0; nt < NT; ++nt) tf_mma(part[mt][nt], {}, {}[nt]);\n"
SMALL_TERMS = "  tf_mma(d, al, bh);\n  tf_mma(e, cl, fh);\n  tf_mma(d, ah, bl);\n  tf_mma(e, ch, fl);\n"
# (variant, [(file, text, replacement)]): each text must occur in its file.
VARIANTS = [
    ("full", []),
    ("attention core: three blocks an SM", [(ATTN, "__launch_bounds__(128, 2) ab32_attn_kernel",
                                             "__launch_bounds__(128, 3) ab32_attn_kernel")]),
    ("row products: three stages (two blocks an SM)", [(HDR, W_STAGES, "constexpr int TFW_STAGES = 3;")]),
    ("row products: 64-column tiles (four blocks an SM)",
     [(HDR, "inline int tfw_bn(int N) { return (N + 95) / 96 * 96 <= (N + 63) / 64 * 64 ? 96 : 64; }",
       "inline int tfw_bn(int N) { return 64; }")]),
    ("weight gradients: 64-row tiles, two blocks an SM", [(HDR, WG_MT, "constexpr int TF_WGRAD_MT = 2;")]),
    # the tensor cores' own sum over the whole K range: the accuracy it costs
    ("no stage partials", [(HDR, "float acc[NA] = {}, part[NA];", "float acc[NA] = {};\n  float (&part)[NA] = acc;"),
                           (HDR, "    for (int i = 0; i < NA; ++i) acc[i] += part[i];\n", ""),
                           (HDR, "tfw_rs<BN>(part, al[kk], bh, kk > 0);", "tfw_rs<BN>(part, al[kk], bh, 1);"),
                           (HDR, WG_PART_ZERO, ""), (HDR, WG_PART_ADD, ""),
                           (HDR, "float acc[MT][NT][4] = {}, part[MT][NT][4];",
                            "float acc[MT][NT][4] = {};\n  float (&part)[MT][NT][4] = acc;")]),
    # every product a single TF32 term (not f32): what the two correction terms cost
    ("products: one TF32 term (not f32)", [(HDR, TERMS, "      tfw_rs<BN>(part, ah[kk], bh, kk > 0);\n"),
                                           (HDR, WG_TERM.format("al", "bh"), ""),
                                           (HDR, WG_TERM.format("ah", "bl"), ""), (HDR, SMALL_TERMS, "")]),
]


def build_all(only) -> dict:
    """{variant: (attention library, MLP library, registers)}, every variant compiled at once."""
    shutil.rmtree(OUT, ignore_errors=True)
    jobs = []
    for i, (name, subs) in enumerate(VARIANTS):
        if only and name not in only:
            continue
        d = OUT / f"v{i}"
        d.mkdir(parents=True)
        for p in _build.CSRC.glob("*.cu*"):
            shutil.copy(p, d / p.name)
        for target, old, new in subs:
            text = (d / target).read_text()
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in {target}")
            (d / target).write_text(text.replace(old, new))
        for src in ("attn_bwd_f32", "mlp_bwd_f32"):
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / f"{src}.so"), str(d / f"{src}.cu")]
            jobs.append((name, d, src, subprocess.Popen(cmd, stdout=open(d / f"{src}.log", "w"),
                                                        stderr=subprocess.STDOUT)))
    for name, d, src, proc in jobs:
        if proc.wait() != 0:
            raise SystemExit(f"{name}: nvcc failed on {src}\n{(d / f'{src}.log').read_text()[-3000:]}")
    libs = {}
    for i, (name, _) in enumerate(VARIANTS):
        d = OUT / f"v{i}"
        if not d.exists():
            continue
        pair = []
        for src, module in (("attn_bwd_f32", ab), ("mlp_bwd_f32", mb)):
            lib = ctypes.CDLL(str(d / f"{src}.so"))
            for fn, args in module._SIGNATURES_F32.items():
                getattr(lib, fn).argtypes = list(args)
                getattr(lib, fn).restype = module._RESTYPES_F32.get(fn, ctypes.c_int)
            pair.append(lib)
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers", (d / "attn_bwd_f32.log").read_text())})
        libs[name] = (*pair, regs)
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
    x, g = randn(b, s, s, c), randn(b, s, s, c, scale=1e-3)
    attn = (1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5), randn(3 * c, scale=0.1),
            randn(c, c, scale=c**-0.5), randn(c, scale=0.1), randn(heads, 64, 64, scale=0.5))
    mlp = (1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, hidden, scale=c**-0.5), randn(hidden, scale=0.1),
           randn(hidden, c, scale=hidden**-0.5))
    dp = torch.full((b,), 1 / 0.9, device=dev)
    dp[0] = 0.0
    akw = dict(heads=heads, window_size=8, shift=4, drop_path=dp)
    xr, gr = x.reshape(-1, c), g.reshape(-1, c)
    mkw = dict(drop_path=dp, rows_per_sample=s * s)
    cases = {"attention_bwd": (lambda: ab.attention_bwd(x, g, *attn, **akw),
                               ab.attention_bwd_plain(x, g, *attn, **akw)),
             "mlp_bwd": (lambda: mb.mlp_bwd(xr, gr, *mlp, **mkw), mb.mlp_bwd_plain(xr, gr, *mlp, **mkw))}
    passes, errors, registers = {}, {}, {}
    load = _build.load
    try:
        for name, (alib, mlib, regs) in libs.items():
            _build.load = lambda src, *_, alib=alib, mlib=mlib: alib if src == "attn_bwd_f32" else mlib
            passes[name], errors[name], registers[name] = {}, {}, regs
            for kernel, (fn, want) in cases.items():
                got = fn()
                torch.cuda.synchronize()
                errors[name][kernel] = [float((a - e).abs().max() / e.abs().max()) for a, e in zip(got, want)]
                passes[name][kernel] = pass_split(fn)
                total = sum(t for _, _, t in passes[name][kernel])
                print(f"{name} | {kernel}: {total:.4f} ms; worst relative error "
                      f"{max(errors[name][kernel]):.2e}; " + "; ".join(
                          f"{n.split('(')[0]} x{k:g} {t:.4f}" for n, k, t in passes[name][kernel]), flush=True)
            print(f"{name} | registers {regs}", flush=True)
    finally:
        _build.load = load
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "passes": passes, "errors": errors, "registers": registers}))


if __name__ == "__main__":
    main()
