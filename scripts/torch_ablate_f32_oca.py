#!/usr/bin/env python3
"""What bounds B13 and B15 in f32: time variants of their kernels.

    python3 scripts/torch_ablate_f32_oca.py [--only VARIANT ...]

Each variant is the checkout's ``csrc/oca_bwd_f32.cu`` and
``csrc/window_attn.cu`` (with their headers) after the substitutions listed
below, built by nvcc with the port's flags into
``build/ablate/f32_oca/<variant>/`` (all at once) and launched through the
port's own wrappers in f32: B13 (``oca_core_bwd``) at HAT's f32 training
step (512 windows, 6 heads, 256 queries, 576 keys, d 30, the OCAB's
transposed views, an f32 bias of a few units) and B15
(``window_attention``) at MaxSR x4's adaptive (256 windows of 256 tokens, 4
heads of 32, no bias) and static (1024 windows of 64 tokens, a bias) f32
forward. For each, ``torch.profiler`` over 10 calls gives the device time of
every kernel a call enqueues, and the first output's largest error against
the plain version relative to the plain output's largest value. A variant
that drops work computes wrong values and only bounds the time of what
remains. Prints one line a variant and case, and then one JSON line:
{"card": nvidia-smi's name and power limit, "passes": {variant: {case:
[[kernel name, launches, ms], ...]}}, "errors": {variant: {case: relative
error}}, "registers": {variant: {kernel: ptxas's registers}}, "spills":
{variant: {kernel: ptxas's spill stores in bytes}}}.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from studiosr_tpu_torch import resolve_device  # noqa: E402
from studiosr_tpu_torch.ops.attention import attention_plain  # noqa: E402
from studiosr_tpu_torch.ops.cuda import _build  # noqa: E402
from studiosr_tpu_torch.ops.cuda import oca_core as oca  # noqa: E402
from studiosr_tpu_torch.ops.cuda import window_attn as wa  # noqa: E402
from torch_ablate_f32_fwd import _ptxas  # noqa: E402
from torch_time_attn_kernels import pass_split  # noqa: E402

OUT = _build.BUILD_DIR.parent / "ablate" / "f32_oca"
HDR, B13, B15 = "tf32x3.cuh", "oca_bwd_f32.cu", "window_attn.cu"
SOURCES = (("oca_bwd_f32", oca._SIGNATURES_F32), ("window_attn", wa._SIGNATURES))
SMALL_TERMS = "  tf_mma(d, al, bh);\n  tf_mma(e, cl, fh);\n  tf_mma(d, ah, bl);\n  tf_mma(e, ch, fl);\n"
# (variant, [(file, text, replacement)]): each text must occur in its file.
VARIANTS = [
    ("full", []),
    # every product a single TF32 term (not f32): what the two correction terms cost
    ("products: one TF32 term (not f32)", [(HDR, SMALL_TERMS, "")]),
    # the score products (B13's two sweeps) and B15's p v dropped: what the rest costs
    ("B13: no score products", [(B13, "  for (int ks = 0; ks < KS; ++ks) {\n    uint32_t qh[4]",
                                 "  for (int ks = 0; ks < 0; ++ks) {\n    uint32_t qh[4]")]),
    ("B13 main: no dk / dv products", [(B13, "for (int st = 0; st < O32_SLAB / 32; ++st) {",
                                        "for (int st = 0; st < 0; ++st) {")]),
    ("B13 main: no dq products", [(B13, "for (int half = 0; half < 2; ++half) {\n        float part[NDT][4];",
                                   "for (int half = 0; half < 0; ++half) {\n        float part[NDT][4];")]),
    ("B15: no p v products", [(B15, "for (int kb = 4 * half; kb < 4 * half + 4; ++kb) {\n            uint32_t ph[4]",
                               "for (int kb = 4 * half; kb < 4 * half; ++kb) {\n            uint32_t ph[4]")]),
]


def build_all(only) -> dict:
    """{variant: ({source: library}, registers, spills)}, every variant compiled at once."""
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
        for src, _ in SOURCES:
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
        built, regs, spills = {}, {}, {}
        for src, signatures in SOURCES:
            lib = ctypes.CDLL(str(d / f"{src}.so"))
            for fn, args in signatures.items():
                getattr(lib, fn).argtypes = list(args)
                getattr(lib, fn).restype = ctypes.c_int
            built[src] = lib
            r, s = _ptxas((d / f"{src}.log").read_text())
            regs.update({f"{src}: {k}": v for k, v in r.items() if "o32_" in k or "wf32_" in k})
            spills.update({f"{src}: {k}": v for k, v in s.items() if "o32_" in k or "wf32_" in k})
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

    bw, heads, nq, nk, d = 512, 6, 256, 576, 30

    def view(n, scale):  # (bw, heads, n, d) over (bw, n, heads, d) storage, as the OCAB's views
        return randn(bw, n, heads, d, scale=scale).transpose(1, 2)

    ops = (view(nq, 2 * d**-0.5), view(nk, 1.0), view(nk, 1.0), randn(heads, nq, nk, scale=2.0), view(nq, 1.0))
    adaptive = randn(256, 256, 3, 4, 32).permute(2, 0, 3, 1, 4)
    static = randn(1024, 64, 3, 4, 32).permute(2, 0, 3, 1, 4)
    sbias = randn(4, 64, 64)
    cases = {
        "oca_core_bwd (HAT f32 step)": (lambda: oca.oca_core_bwd(*ops)[0], oca.oca_core_bwd_plain(*ops)[0]),
        "window_attention (MaxSR adaptive)": (lambda: wa.window_attention(adaptive[0] * 32**-0.5, adaptive[1], adaptive[2]),
                                              attention_plain(adaptive[0] * 32**-0.5, adaptive[1], adaptive[2])),
        "window_attention (MaxSR static)": (lambda: wa.window_attention(static[0] * 32**-0.5, static[1], static[2], sbias),
                                            attention_plain(static[0] * 32**-0.5, static[1], static[2], sbias)),
    }
    passes, errors, registers, spills = {}, {}, {}, {}
    load = _build.load
    try:
        for name, (built, regs, spill) in libs.items():
            _build.load = lambda src, *_, built=built: built[src]
            passes[name], errors[name], registers[name], spills[name] = {}, {}, regs, spill
            for case, (fn, want) in cases.items():
                got = fn()
                torch.cuda.synchronize()
                errors[name][case] = float((got - want).abs().max() / want.abs().max())
                passes[name][case] = pass_split(fn, calls=10)
                total = sum(t for _, _, t in passes[name][case])
                print(f"{name} | {case}: {total:.4f} ms; relative error {errors[name][case]:.2e}; " + "; ".join(
                    f"{n.split('(')[0]} x{k:g} {t:.4f}" for n, k, t in passes[name][case]), flush=True)
            print(f"{name} | registers {regs}; spill stores {spill}", flush=True)
    finally:
        _build.load = load
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "passes": passes, "errors": errors, "registers": registers, "spills": spills}))


if __name__ == "__main__":
    main()
