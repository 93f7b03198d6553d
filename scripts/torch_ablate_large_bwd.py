#!/usr/bin/env python3
"""What bounds the attention core's backward above window 16 in bf16 (B9's
and B13's large families, ``csrc/lb_core.cuh``): time ablated copies.

    python3 scripts/torch_ablate_large_bwd.py

Each variant is the checkout's ``csrc/attn_bwd_mma.cu`` and
``csrc/oca_bwd_mma.cu`` (with their headers) after the substitutions listed
below, built by nvcc with the port's flags into
``build/ablate/large_bwd/<variant>/`` (all at once) and launched through the
port's own wrappers at HAT x4's window-24 step: B9 (``attention_bwd``) on
batch 32 of 72 x 72 maps, 180 channels, 6 heads, window 24, shift 12,
drop-path scales (0, 1/0.9, ...), the bias in bf16; B13 (``oca_core_bwd``) on
288 windows of 6 heads, 576 queries, 1296 keys, d 30, the OCAB's transposed
views, the bias in bf16. For each, ``torch.profiler`` over 10 calls gives the
device time of every kernel a call enqueues (the core's passes:
``lb_stats_kernel``, ``lb_main_kernel``, ``lb_dq_kernel``,
``lb_dbias_kernel``). Variants that drop work compute wrong values and only
bound the time of what remains. Prints one line a variant and then one JSON
line: {"card": nvidia-smi's name and power limit, "passes": {variant:
{case: [[kernel, launches, ms], ...]}}}.
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
from studiosr_tpu_torch.ops.cuda import oca_core as oc  # noqa: E402
from torch_time_attn_kernels import pass_split  # noqa: E402

OUT = _build.BUILD_DIR.parent / "ablate" / "large_bwd"
SOURCES = {"attn_bwd_mma": ab, "oca_bwd_mma": oc}
CORE, COMMON, WGMMA = "lb_core.cuh", "am_common.cuh", '"wgmma.mma_async.sync.aligned.'
# (variant, [(file, text, replacement)]): each text must occur in its file.
VARIANTS = [
    ("full", []),
    # every wgmma instruction commented out of its PTX (operands, fences and waits stay)
    ("no wgmma products", [("wgmma.cuh", WGMMA, '"// wgmma.mma_async.sync.aligned.'),
                           (COMMON, WGMMA, '"// wgmma.mma_async.sync.aligned.')]),
    ("no ex2", [(COMMON, 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x;")]),
    ("main: no tile loads", [(CORE, "    if (lr >= QTB) return;\n", "    if (lr >= 0) return;\n")]),
    ("main: no q / g transposes", [(CORE, "      lb_transpose<DP>(Qk, Qt);\n      lb_transpose<DP>(Gk, Gt);\n", "")]),
    ("main: no d-bias slab", [(CORE, "          acc = a;\n", "")]),
    ("main: no dq partial stores",
     [(CORE, "        for (int nt = 0; nt < NDT; ++nt) dst[nt * 128 + wt] = make_float4(dq[nt][0], dq[nt][1], dq[nt][2], "
             "dq[nt][3]);", "        if (dq[0][0] == 12345.f) dst[wt] = make_float4(dq[0][1], 0.f, 0.f, 0.f);")]),
    ("no bias reads",
     [("attn_bwd_mma.cu", "{ return am_bias4(a, G.NCH, h, r, c, nt, wt); }",
       "{ return make_float4(r, c, nt, wt); }"),
      ("oca_bwd_mma.cu", "    if (!a.bias16) return reinterpret_cast<const float4*>(a.bfrag)[e];",
       "    return make_float4(r, c, nt, e);")]),
]


def build_all() -> dict:
    """{variant: {source: its library}}, every variant compiled at once."""
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
        for src in SOURCES:
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / f"{src}.so"), str(d / f"{src}.cu")]
            log = open(d / f"{src}.log", "w")
            jobs.append((name, src, d, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    libs: dict = {}
    for name, src, d, proc in jobs:
        if proc.wait() != 0:
            raise SystemExit(f"{name}: nvcc failed on {src}\n{(d / f'{src}.log').read_text()[-3000:]}")
        lib = ctypes.CDLL(str(d / f"{src}.so"))
        module = SOURCES[src]
        restypes = getattr(module, "_RESTYPES_MMA", {})
        for fn, args in module._SIGNATURES_MMA.items():
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = restypes.get(fn, ctypes.c_int)
        libs.setdefault(name, {})[src] = lib
    return libs


def main() -> None:
    dev = resolve_device("cuda")
    libs = build_all()
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    c, heads, ws = 180, 6, 24
    x, g = randn(32, 72, 72, c).to(bf), randn(32, 72, 72, c, scale=1e-3).to(bf)
    dp = torch.full((32,), 1 / 0.9, device=dev)
    dp[0] = 0.0
    ops = (1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5).to(bf),
           randn(3 * c, scale=0.1), randn(c, c, scale=c**-0.5).to(bf), randn(c, scale=0.1),
           randn(heads, ws * ws, ws * ws, scale=0.5).to(bf))
    kw = dict(heads=heads, window_size=ws, shift=ws // 2, drop_path=dp)
    q, k, v, go = (randn(288, n, heads, 30, scale=sc).to(bf).transpose(1, 2)
                   for n, sc in ((576, 2 * 30**-0.5), (1296, 1.0), (1296, 1.0), (576, 1.0)))
    bias = randn(heads, 576, 1296, scale=2.0).to(bf)
    cases = {"B9 hat step ws24": ("attn_bwd_mma", lambda: ab.attention_bwd(x, g, *ops, **kw)),
             "B13 hat step ws24": ("oca_bwd_mma", lambda: oc.oca_core_bwd(q, k, v, bias, go))}
    passes = {}
    load = _build.load
    try:
        for name, by_src in libs.items():
            passes[name] = {}
            for case, (src, fn) in cases.items():
                _build.load = lambda *_, lib=by_src[src]: lib
                passes[name][case] = pass_split(fn)
                split = passes[name][case]
                total = sum(t for _, _, t in split)
                print(f"{name} [{case}] {total:.4f} ms: " + "; ".join(
                    f"{n.split('(')[0]} x{c:g} {t:.4f}" for n, c, t in split if "lb_" in n), flush=True)
    finally:
        _build.load = load
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "passes": passes}))


if __name__ == "__main__":
    main()
