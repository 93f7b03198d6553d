#!/usr/bin/env python3
"""What bounds B1 and B2 in f32: time variants of their kernels.

    python3 scripts/torch_ablate_f32_serving.py [--only VARIANT ...]

Each variant is the checkout's ``csrc/swin_block_f32.cu`` and
``csrc/conv3x3.cu`` (with ``csrc/conv3x3_f32.cuh`` and the other headers)
after the substitutions listed below, built by nvcc with the port's flags
into ``build/ablate/f32_serving/<variant>/`` (all at once) and launched
through the port's own wrappers in f32 at the main path's shapes: B1
(``fused_swin_block``, a 264 x 264 x 180 map, 6 heads, hidden 360, shift 4,
the weights packed once) and B2 (``fused_conv3x3`` 180 -> 180 with the skip
map, the weights packed once). For each, CUDA events over 20 launches after
3 warm-up launches, and the output's largest error against the plain
version relative to the plain output's largest value. A variant that drops
work computes wrong values and only bounds the time of what remains. Prints
one line a variant and kernel, then one JSON line: {"card": nvidia-smi's
name and power limit, "ms": {variant: {kernel: ms}}, "errors": {variant:
{kernel: relative error}}, "registers": {variant: {kernel: registers}},
"spills": {variant: {kernel: spill stores in bytes}}}.
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
from studiosr_tpu_torch.ops.cuda import _build  # noqa: E402
from studiosr_tpu_torch.ops.cuda import conv3x3 as cv  # noqa: E402
from studiosr_tpu_torch.ops.cuda import swin_block as sb  # noqa: E402
from torch_ablate_f32_fwd import _ptxas  # noqa: E402
from torch_time_attn_kernels import time_ms  # noqa: E402

OUT = _build.BUILD_DIR.parent / "ablate" / "f32_serving"
B1, CONV = "swin_block_f32.cu", "conv3x3_f32.cuh"
SOURCES = (("swin_block_f32", sb._F32_SIGNATURES, sb._F32_RESTYPES), ("conv3x3", cv._SIGNATURES, cv._RESTYPES))
B1_TERMS = ("    tfw_rs<SB32_BN>(d, al[kk], bh, kk > 0);\n    tfw_rs<SB32_BN>(d, ah[kk], bl, 1);\n"
            "    tfw_rs<SB32_BN>(d, ah[kk], bh, 1);\n")
CONV_TERMS = ("      tfw_rs<CT_BN>(part, al[kk], bh, kk > 0);\n      tfw_rs<CT_BN>(part, ah[kk], bl, 1);\n"
              "      tfw_rs<CT_BN>(part, ah[kk], bh, 1);\n")
B1_LOAD = "    am_bulk_load(ring + sl * SB32_STAGE, a.w + (size_t)s * SB32_STAGE, SB32_STAGE * 4, &full[sl]);\n"
CONV_WLOAD = "        hm_cp_async<16>(dst + 4 * i, src + 4 * i, true);\n      }\n    }\n    hm_cp_commit();\n  };\n\n  float acc"
CONV_PATCH = "          hm_cp_async<XW>(P + px * CT_PL + c, ok ? xb + ((size_t)gy * W + gx) * Cin + c0 + c : a.x, ok);\n"
B1_CORE = ("      tfw_rs<64>(sc, al[kk], kh, kk > 0);\n      tfw_rs<64>(sc, ah[kk], kl, 1);\n      tfw_rs<64>(sc, ah[kk], kh, 1);\n",
           "        tfw_rs<32>(opart, al[kk], vh, kk > 0);\n        tfw_rs<32>(opart, ah[kk], vl, 1);\n"
           "        tfw_rs<32>(opart, ah[kk], vh, 1);\n")
B1_NEXT = "  auto next_stage = [&]() -> const float* {\n"
B1_LN = ("  for (int r0_ = 16 * wi; r0_ < 16 * wi + 16; r0_ += 4) {  // four rows' loads in flight at once\n"
         "    float4 v[4][2];\n#pragma unroll\n    for (int k = 0; k < 4; ++k) {\n")
B1_LN_ONE = ("  for (int r0_ = 16 * wi; r0_ < 16 * wi + 16; r0_ += 1) {  // one row's loads at a time\n"
             "    float4 v[1][2];\n#pragma unroll\n    for (int k = 0; k < 1; ++k) {\n")
B1_LN_COMPUTE = "#pragma unroll\n    for (int k = 0; k < 4; ++k) {\n      tf_ln_fwd("
# (variant, [(file, text, replacement)]): each text must occur in its file.
VARIANTS = [
    ("full", []),
    # every weight product a single TF32 term (not f32): what the tensor pipes' share is
    ("weight products: one TF32 term (not f32)", [(B1, B1_TERMS, "    tfw_rs<SB32_BN>(d, ah[kk], bh, kk > 0);\n"),
                                                  (CONV, CONV_TERMS,
                                                   "      tfw_rs<CT_BN>(part, ah[kk], bh, kk > 0);\n")]),
    # the weight stages not copied (the ring holds what it held): what their loads cost
    ("no weight loads", [(B1, B1_LOAD, "    am_bar_arrive(&full[sl]);\n"),
                         (CONV, CONV_WLOAD, CONV_WLOAD.replace("hm_cp_async<16>(dst + 4 * i, src + 4 * i, true);",
                                                               "(void)src;"))]),
    # B1's attention products (scores and p v on wgmma) dropped: their share
    ("B1: no attention products", [(B1, B1_CORE[0], ""), (B1, B1_CORE[1], "")]),
    # B1's two warpgroups held in step by a block-wide barrier a stage (the
    # ring on mbarriers lets them run apart)
    ("B1: a block-wide barrier a stage", [(B1, B1_NEXT, B1_NEXT + "    __syncthreads();\n")]),
    # LN1's rows one at a time (the kernel keeps four rows' loads in flight)
    ("B1: LN1 rows one at a time", [(B1, B1_LN, B1_LN_ONE),
                                    (B1, B1_LN_COMPUTE, B1_LN_COMPUTE.replace("k < 4", "k < 1"))]),
    # the conv at two warpgroups (an 8 x 16 tile) instead of three
    ("B2: two warpgroups", [(CONV, "constexpr int CT_WG = 3;", "constexpr int CT_WG = 2;")]),
    # the conv's patch not staged: what the A side's loads cost
    ("B2: no patch loads", [(CONV, CONV_PATCH, "")]),
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
        for src, _, _ in SOURCES:
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
        for src, signatures, restypes in SOURCES:
            lib = ctypes.CDLL(str(d / f"{src}.so"))
            for fn, args in signatures.items():
                getattr(lib, fn).argtypes = list(args)
                getattr(lib, fn).restype = restypes.get(fn, ctypes.c_int)
            built[src] = lib
            r, s = _ptxas((d / f"{src}.log").read_text())
            regs.update({f"{src}: {k}": v for k, v in r.items() if "sb32" in k or "ct_conv" in k})
            spills.update({f"{src}: {k}": v for k, v in s.items() if "sb32" in k or "ct_conv" in k})
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

    hp, c, heads, hidden = 264, 180, 6, 360
    x, skip = randn(1, hp, hp, c), randn(1, hp, hp, c)
    ops = [1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5), randn(3 * c, scale=0.1),
           randn(c, c, scale=c**-0.5), randn(c, scale=0.1), randn(heads, 64, 64, scale=0.5), 1 + randn(c, scale=0.1),
           randn(c, scale=0.1), randn(c, hidden, scale=c**-0.5), randn(hidden, scale=0.1),
           randn(hidden, c, scale=hidden**-0.5), randn(c, scale=0.1)]
    packed = sb.pack_swin_f32(ops[2], ops[4], ops[6], ops[9], ops[11], heads)
    served = [packed if i == 2 else None if i in (4, 6, 9, 11) else t for i, t in enumerate(ops)]
    kw = dict(heads=heads, window_size=8, shift=4)
    w, b = randn(3, 3, c, c, scale=(9 * c) ** -0.5), randn(c, scale=0.1)
    wp = cv.pack_conv3x3_f32_weights(w)
    cases = {"fused_swin_block": (lambda: sb.fused_swin_block(x, *served, **kw), sb.swin_block_plain(x, *ops, **kw)),
             "fused_conv3x3": (lambda: cv.fused_conv3x3(x, wp, b, extra=skip),
                               cv.conv3x3_plain(x, w, b, extra=skip))}
    ms, errors, registers, spills = {}, {}, {}, {}
    load = _build.load
    try:
        for name, (built, regs, spill) in libs.items():
            _build.load = lambda src, *_, built=built: built[src]
            ms[name], errors[name], registers[name], spills[name] = {}, {}, regs, spill
            for kernel, (fn, want) in cases.items():
                got = fn()
                torch.cuda.synchronize()
                errors[name][kernel] = float((got - want).abs().max() / want.abs().max())
                ms[name][kernel] = time_ms(fn)
                print(f"{name} | {kernel}: {ms[name][kernel]:.4f} ms; relative error {errors[name][kernel]:.2e}",
                      flush=True)
            print(f"{name} | registers {regs}; spill stores {spill}", flush=True)
    finally:
        _build.load = load
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "ms": ms, "errors": errors, "registers": registers, "spills": spills}))


if __name__ == "__main__":
    main()
