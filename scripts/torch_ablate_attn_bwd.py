#!/usr/bin/env python3
"""What bounds B8 and B9 in bf16: time ablated copies of their kernels.

    python3 scripts/torch_ablate_attn_bwd.py

Each variant is the checkout's ``csrc/attn_bwd_mma.cu`` (with its headers)
after the substitutions listed below, built by nvcc with the port's flags
into ``build/ablate/attn_bwd/<variant>/`` (all at once) and launched
through the port's own wrapper (``attention_bwd``) in bf16 at the training
shapes: batch 32 of 64 x 64 maps, 180 channels, 6 heads, window 8 with
shift 4 (B8) and window 16 with shift 8 (B9), drop-path scales (0, 1/0.9,
...). For each, ``torch.profiler`` over 10 calls gives the device time of
every kernel a call enqueues (the four passes: am_proj_kernel,
am_attn_kernel, am_rowgemm_kernel for dln, am_wgrad_kernel, and the
reductions). The passes it shares with B5 and B7 live in
``csrc/am_window.cuh`` and ``csrc/am_common.cuh``; their substitutions are
made there.
Variants that drop work compute wrong values and only bound the time of
what remains. Prints one line a variant and then one JSON line: {"card":
nvidia-smi's name and power limit, "passes": {variant: {window: [[kernel,
launches, ms], ...]}}}.
"""

from __future__ import annotations

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
from studiosr_tpu_torch.ops.cuda import attn_bwd as ab  # noqa: E402
from torch_time_attn_kernels import pass_split  # noqa: E402

OUT = _build.BUILD_DIR.parent / "ablate" / "attn_bwd"
SRC = "attn_bwd_mma.cu"
COMMON, WINDOW = "am_common.cuh", "am_window.cuh"  # the pieces it shares with B5 and B7
WGMMA = '"wgmma.mma_async.sync.aligned.'
# (variant, [(file, text, replacement)]): each text must occur in its file.
# Passes 0 (am_ln_kernel), 3b (am_lnb_kernel) and the reductions are
# element-wise and are timed as they are.
VARIANTS = [
    ("full", []),
    # every wgmma instruction commented out of its PTX (operands, fences and waits stay)
    ("no wgmma products", [("wgmma.cuh", WGMMA, '"// wgmma.mma_async.sync.aligned.'),
                           (COMMON, WGMMA, '"// wgmma.mma_async.sync.aligned.')]),
    ("proj: no LN or g_b row copies",
     [(WINDOW, "    am_load_rows(KC, G.SC, a.ln, tile, valid, lnb);\n"
               "    if (DATTN) am_load_rows(KC, G.SC, a.gb, tile, valid, gbb);\n", "")]),
    ("proj: no q|k|v or dattn stores",
     [(WINDOW, "*reinterpret_cast<__nv_bfloat162*>(dst + am_kmajor(j, r, DP)) = __floats2bfloat162_rn(v0, v1);",
       "if (v0 == 12345.f) dst[0] = __float2bfloat16(v1);")]),
    ("attn: no unit copies", [(SRC, "        hm_cp_async<16>(d, s, true);\n", "        (void)d, (void)s;\n")]),
    ("attn: no bias reads", [(SRC, "for (int nt = 0; nt < 8; ++nt) bb[nt] = bias4(c, nt);",
                              "for (int nt = 0; nt < 8; ++nt) bb[nt] = make_float4(c, nt, q0, 0.f);")]),
    # the partials neither pushed nor waited for, the barriers never armed
    ("attn: no dk / dv exchange between the cluster's blocks",
     [(SRC, "        if (!own) {\n          float4* box = inbox", "        if (own && !own) {\n          float4* box = inbox"),
      (SRC, "      am_bar_wait_cluster(full, (n - 1) & 1);\n", ""),
      (SRC, "      if (NCH > 1) am_bar_wait_cluster(credit, (n - 1) & 1);", ""),
      (SRC, "  if (NCH > 1 && n > 0) am_bar_wait_cluster(credit, (n - 1) & 1);", ""),
      (SRC, "      if (tid == 0) {\n        // the next window's phase", "      if (tid < 0) {\n        // the next window's phase"),
      (SRC, "  if (NCH > 1 && tid == 0)  // the first window's phase", "  if (NCH > 1 && tid < 0)  // the first window's phase")]),
    ("attn: no ex2", [(COMMON, 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x;")]),
    ("attn: no d bias accumulation", [(SRC, "        acc = v;\n", "")]),
    ("attn: no transposes",
     [(SRC, "    am_transpose<DP>(Kk, Kt, NCH, 4 * WGS);\n    am_transpose<DP>(Vk, Vt, NCH, 4 * WGS);\n"
            "    am_transpose<DP>(Qk, Qt, 1, 4 * WGS);\n    am_transpose<DP>(Dk, Dt, 1, 4 * WGS);\n", "")]),
    ("dln: no dq|dk|dv copies",
     [(COMMON, "          hm_cp_async<16>(dst + am_kmajor(8 * kg, t, kr), src + (long long)t * q.lda + AM_KSTAGE * s + "
               "8 * kg, true);\n", "          (void)dst, (void)src;\n")]),
    ("dln: no dln stores",
     [(COMMON, "        *reinterpret_cast<float2*>(out + ((long long)tile * AM_TOK + r0 + 8 * hh) * C + c) =\n"
               "            make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);",
       "        if (acc[nt][2 * hh] == 12345.f) out[0] = acc[nt][2 * hh + 1];")]),
    ("wgrad: no copies",
     [(COMMON, "          hm_cp_async<16>(sa + t * AW_LA + 8 * q, A + (k0 + t) * lda + m0 + 8 * q, true);",
       "          (void)sa;"),
      (COMMON, "          hm_cp_async<16>(sb + t * AW_LB + 8 * q, B + (k0 + t) * ldb + n0 + 8 * q, true);",
       "          (void)sb;")]),
]


def build_all() -> dict:
    """{variant: its library}, every variant compiled at once."""
    shutil.rmtree(OUT, ignore_errors=True)
    jobs = []
    for i, (name, subs) in enumerate(VARIANTS):
        d = OUT / f"v{i}"
        d.mkdir(parents=True)
        for p in _build.CSRC.glob("*.cu*"):
            shutil.copy(p, d / p.name)
        for target, old, new in subs:
            text = (d / target).read_text()
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in {target}")
            (d / target).write_text(text.replace(old, new))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / SRC)]
        jobs.append((name, d, subprocess.Popen(cmd, stdout=open(d / "log.txt", "w"), stderr=subprocess.STDOUT)))
    libs = {}
    for name, d, proc in jobs:
        if proc.wait() != 0:
            raise SystemExit(f"{name}: nvcc failed\n{(d / 'log.txt').read_text()[-3000:]}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn, args in ab._SIGNATURES_MMA.items():
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = ab._RESTYPES_MMA.get(fn, ctypes.c_int)
        libs[name] = lib
    return libs


def main() -> None:
    dev = resolve_device("cuda")
    libs = build_all()
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    c, heads = 180, 6
    x, g = randn(32, 64, 64, c).to(bf), randn(32, 64, 64, c, scale=1e-3).to(bf)
    dp = torch.full((32,), 1 / 0.9, device=dev)
    dp[0] = 0.0
    cases = {}
    for ws, shift in ((8, 4), (16, 8)):
        ops = (1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5).to(bf),
               randn(3 * c, scale=0.1), randn(c, c, scale=c**-0.5).to(bf), randn(c, scale=0.1),
               randn(heads, ws * ws, ws * ws, scale=0.5).to(bf))  # the bf16 step's gathered bias
        cases[f"window {ws}"] = (ops, dict(heads=heads, window_size=ws, shift=shift, drop_path=dp))
    passes = {}
    load = _build.load
    try:
        for name, lib in libs.items():
            _build.load = lambda *_, lib=lib: lib
            passes[name] = {k: pass_split(lambda ops=ops, kw=kw: ab.attention_bwd(x, g, *ops, **kw))
                            for k, (ops, kw) in cases.items()}
            for k, split in passes[name].items():
                print(f"{name} [{k}]: " + "; ".join(f"{n.split('(')[0]} x{c:g} {t:.4f}" for n, c, t in split),
                      flush=True)
    finally:
        _build.load = load
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "passes": passes}))


if __name__ == "__main__":
    main()
