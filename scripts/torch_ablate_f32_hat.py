#!/usr/bin/env python3
"""What bounds B11 and B10 in f32 (HAT's f32 serving forward): time variants of their kernels.

    python3 scripts/torch_ablate_f32_hat.py [--only VARIANT ...]

Each variant is the checkout's ``csrc/cab_mma.cu`` (B11's f32 entry on
``conv3x3_f32.cuh``'s CAB instantiation) and ``csrc/ocab_f32.cu`` (B10's f32
entry: its attention pass ``oc32_attn_kernel``, the row products of
``tf32x3.cuh``, the MLP tail of ``mf32_mlp.cuh``) after the substitutions
listed below, built by nvcc with the port's flags into
``build/ablate/f32_hat/<variant>/`` (all at once, by
``torch_ablate_f32_fwd.build_all``) and launched through the port's own
wrappers in f32 at HAT x4 serving's shapes: B11 (``fused_cab_body``, one
256 x 256 map, C 180, Cm 60, the weights packed as serving packs them) and
B10 (``fused_ocab_block``, the same map, 6 heads of 30, window 16, overlap
0.5: 576 keys, hidden 360). For each, ``torch.profiler`` over 5 calls gives
the device time of every kernel a call enqueues (B11: the LN rows, conv1,
conv2, the sum; B10: the weights' pack, LN1, q|k|v, the attention pass,
proj, and the MLP tail's LN2, fc1, fc2), and the first output's largest
error against the plain version relative to the plain output's largest
value. A variant that drops work computes wrong values and only bounds the
time of what remains. Prints one line a variant and case, and then one JSON
line: {"card": nvidia-smi's name and power limit, "passes": {variant:
{case: [[kernel name, launches, ms], ...]}}, "errors": {variant: {case:
relative error}}, "registers": {variant: {kernel: ptxas's registers}},
"spills": {variant: {kernel: ptxas's spill stores in bytes}}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from studiosr_tpu_torch import resolve_device  # noqa: E402
from studiosr_tpu_torch.ops.cuda import _build  # noqa: E402
from studiosr_tpu_torch.ops.cuda import conv3x3 as cv  # noqa: E402
from studiosr_tpu_torch.ops.cuda import ocab as oc  # noqa: E402
from torch_ablate_f32_fwd import build_all  # noqa: E402
from torch_time_attn_kernels import pass_split  # noqa: E402

OUT = _build.BUILD_DIR.parent / "ablate" / "f32_hat"
CONV, HDR, OCAB = "conv3x3_f32.cuh", "tf32x3.cuh", "ocab_f32.cu"
# build_all binds a library by its module's _SIGNATURES_F32 / _RESTYPES_F32
SOURCES = (("cab_mma", SimpleNamespace(_SIGNATURES_F32=cv._CAB_MMA_SIGNATURES, _RESTYPES_F32={})), ("ocab_f32", oc))
CONV_TERMS = ("      tfw_rs<BN>(part, al[kk], bh, kk > 0);\n      tfw_rs<BN>(part, ah[kk], bl, 1);\n"
              "      tfw_rs<BN>(part, ah[kk], bh, 1);\n")
SMALL_TERMS = "  tf_mma(d, al, bh);\n  tf_mma(e, cl, fh);\n  tf_mma(d, ah, bl);\n  tf_mma(e, ch, fl);\n"
# (variant, [(file, text, replacement)]): each text must occur in its file.
VARIANTS = [
    ("full", []),
    # B11's convs (and B2's kernel) a single TF32 term a product: what the two correction terms cost
    ("convs: one TF32 term (not f32)", [(CONV, CONV_TERMS, "      tfw_rs<BN>(part, ah[kk], bh, kk > 0);\n")]),
    # B11's convs without their weight ring's copies (the slots hold stale values)
    ("convs: no weight loads", [(CONV, "if (WPIECES % CT_THREADS == 0 || i < WPIECES) hm_cp_async",
                                 "if (false) hm_cp_async")]),
    # B11's convs without the patch copies
    ("convs: no patch loads", [(CONV, "          hm_cp_async<XW>(P + px * CT_PL + c,",
                                "          if (false) hm_cp_async<XW>(P + px * CT_PL + c,")]),
    # B10's attention pass on mma.sync a single TF32 term a product
    ("attention: one TF32 term (not f32)", [(HDR, SMALL_TERMS, "")]),
    ("attention: no score products", [(OCAB, "for (int ks = 0; ks < KS; ++ks)\n#pragma unroll\n      for",
                                       "for (int ks = 0; ks < 0; ++ks)\n#pragma unroll\n      for")]),
    ("attention: no p v products", [(OCAB, "for (int kb = 4 * half; kb < 4 * half + 4; ++kb) {",
                                     "for (int kb = 4 * half; kb < 4 * half; ++kb) {")]),
    # the key chunks' split into hi / lo images skipped (the images hold stale values)
    ("attention: no k / v split", [(OCAB, "    if (c + 1 < KT) split_chunk(c + 1);", "")]),
]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", nargs="+", metavar="VARIANT", help="build and time only these variants")
    args = parser.parse_args()
    dev = resolve_device("cuda")
    libs = build_all(args.only, VARIANTS, SOURCES, OUT, kernels=("ct_conv", "cb32", "oc32", "mf32", "tfw_gemm"))
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    c, cm, heads, hidden = 180, 60, 6, 360
    x = randn(1, 256, 256, c)
    cab = [1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(3, 3, c, cm, scale=(9 * c) ** -0.5),
           randn(cm, scale=0.1), randn(3, 3, cm, c, scale=(9 * cm) ** -0.5), randn(c, scale=0.1)]
    cab[2], cab[4] = cv.pack_cab_f32_convs(cab[2], cab[4])
    ocab = [1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5), randn(3 * c, scale=0.1),
            randn(c, c, scale=c**-0.5), randn(c, scale=0.1), randn(heads, 256, 576, scale=0.5),
            1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, hidden, scale=c**-0.5), randn(hidden, scale=0.1),
            randn(hidden, c, scale=hidden**-0.5), randn(c, scale=0.1)]
    kw = dict(heads=heads, window_size=16, overlap_ratio=0.5)
    cases = {
        "B11 (HAT f32 serving)": (lambda: cv.fused_cab_body(x, *cab)[0], cv.cab_body_plain(x, *cab)[0]),
        "B10 (HAT f32 serving)": (lambda: oc.fused_ocab_block(x, *ocab, **kw), oc.ocab_plain(x, *ocab, **kw)),
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
