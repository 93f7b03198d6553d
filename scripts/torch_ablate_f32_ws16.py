#!/usr/bin/env python3
"""What bounds B5 and B9 in f32 at windows 9-16: time variants of their kernels.

    python3 scripts/torch_ablate_f32_ws16.py [--only VARIANT ...]

Each variant is the checkout's ``csrc/window_attention_f32.cu`` and
``csrc/attn_bwd_f32.cu`` (with their headers: ``tf_window16.cuh``'s
attention pass, ``tf32x3.cuh``'s products) after the substitutions listed
below, built by nvcc with the port's flags into
``build/ablate/f32_ws16/<variant>/`` (all at once) and launched through the
port's own wrappers in f32 at HAT x4's f32 training step: B5
(``fused_window_attention_block``) and B9 (``attention_bwd``) on batch 32
of 64 x 64 maps, C 180, 6 heads of 30, window 16, shift 8, drop-path
scales, an f32 bias. For each, ``torch.profiler`` over 5 calls gives the
device time of every kernel a call enqueues (the passes: the LN rows, the
row products, the bias in fragment order, ``tw_rows_kernel``,
``ab16_main_kernel``, dq's and d bias's sums, the weight gradients), and
the first output's largest error against the plain version relative to
the plain output's largest value. A variant that drops work computes wrong
values and only bounds the time of what remains. Prints one line a variant
and case, and then one JSON line: {"card": nvidia-smi's name and power
limit, "passes": {variant: {case: [[kernel name, launches, ms], ...]}},
"errors": {variant: {case: relative error}}, "registers": {variant:
{kernel: ptxas's registers}}, "spills": {variant: {kernel: ptxas's spill
stores in bytes}}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from studiosr_tpu_torch import resolve_device  # noqa: E402
from studiosr_tpu_torch.ops.cuda import _build  # noqa: E402
from studiosr_tpu_torch.ops.cuda import attn_bwd as bwd  # noqa: E402
from studiosr_tpu_torch.ops.cuda import window_attention as fwd  # noqa: E402
from torch_ablate_f32_fwd import build_all  # noqa: E402
from torch_time_attn_kernels import pass_split  # noqa: E402

OUT = _build.BUILD_DIR.parent / "ablate" / "f32_ws16"
HDR, ROWS, B9 = "tf32x3.cuh", "tf_window16.cuh", "attn_bwd_f32.cu"
SOURCES = (("window_attention_f32", fwd), ("attn_bwd_f32", bwd))
SMALL_TERMS = "  tf_mma(d, al, bh);\n  tf_mma(e, cl, fh);\n  tf_mma(d, ah, bl);\n  tf_mma(e, ch, fl);\n"
# (variant, [(file, text, replacement)]): each text must occur in its file.
VARIANTS = [
    ("full", []),
    # every product on mma.sync a single TF32 term (not f32): what the two
    # correction terms cost (the row products on wgmma keep their three)
    ("mma.sync products: one TF32 term (not f32)", [(HDR, SMALL_TERMS, "")]),
    # B5's scores in tw_rows_kernel dropped
    ("rows pass (B5): no score products", [(ROWS, "for (int ks = 0; ks < KS; ++ks)\n#pragma unroll\n            for",
                                             "for (int ks = 0; ks < 0; ++ks)\n#pragma unroll\n            for")]),
    # the scores and dprobs of B9's two sweeps dropped
    ("B9 sweeps 1 and 2: no score products", [(HDR, "  for (int ks = 0; ks < KS; ++ks) {\n    uint32_t qh[4]",
                                               "  for (int ks = 0; ks < 0; ++ks) {\n    uint32_t qh[4]")]),
    # o += p v in tw_rows_kernel dropped (B5's attn, B9's sweep 1)
    ("rows pass: no p v products", [(ROWS, "for (int kb = 4 * half; kb < 4 * half + 4; ++kb) {\n            uint32_t ph",
                                      "for (int kb = 4 * half; kb < 4 * half; ++kb) {\n            uint32_t ph")]),
    # the window's k / v split into hi / lo images skipped (the images hold stale values)
    ("rows pass: no k / v split", [(ROWS, "    tf_split_rows<DP, LD, TW_THREADS>(stage, kvs, kvs + KV, N);\n"
                                          "    tf_split_rows<DP, LD, TW_THREADS>(stage + KV, kvs + 2 * KV, kvs + 3 * KV, N);\n",
                                    "")]),
    ("B9 sweep 2: no dk / dv products", [(B9, "for (int st = 0; st < qrows / 32; ++st) {",
                                          "for (int st = 0; st < 0; ++st) {")]),
    ("B9 sweep 2: no dq products", [(B9, "for (int half = 0; half < 2; ++half) {\n        float part[NDT][4];",
                                     "for (int half = 0; half < 0; ++half) {\n        float part[NDT][4];")]),
]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", nargs="+", metavar="VARIANT", help="build and time only these variants")
    args = parser.parse_args()
    dev = resolve_device("cuda")
    libs = build_all(args.only, VARIANTS, SOURCES, OUT, kernels=("tw_rows", "ab16_"))
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    batch, crop, c, heads, ws = 32, 64, 180, 6, 16
    x, g = randn(batch, crop, crop, c), randn(batch, crop, crop, c, scale=1e-3)
    dp = torch.full((batch,), 1 / 0.9, device=dev)
    dp[0] = 0.0
    ops = (1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5), randn(3 * c, scale=0.1),
           randn(c, c, scale=c**-0.5), randn(c, scale=0.1), randn(heads, ws * ws, ws * ws, scale=0.5))
    kw = dict(heads=heads, window_size=ws, shift=ws // 2, drop_path=dp)
    cases = {
        "B5 ws16 (HAT f32 step)": (lambda: fwd.fused_window_attention_block(x, *ops, **kw),
                                   fwd.window_attention_plain(x, *ops, **kw)),
        "B9 ws16 (HAT f32 step)": (lambda: bwd.attention_bwd(x, g, *ops, **kw)[3],  # d Wqkv
                                   bwd.attention_bwd_plain(x, g, *ops, **kw)[3]),
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
                passes[name][case] = pass_split(fn, calls=5)
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
