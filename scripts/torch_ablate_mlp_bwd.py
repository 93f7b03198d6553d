#!/usr/bin/env python3
"""What bounds B7 in bf16: time ablated copies of its kernel.

    python3 scripts/torch_ablate_mlp_bwd.py

Each variant is the checkout's ``csrc/mlp_bwd_mma.cu`` (with its headers)
after the substitutions listed below, built by nvcc with the port's flags
into ``build/ablate/mlp_bwd/<variant>/`` (all at once) and launched through
the port's own wrapper (``mlp_bwd``) in bf16 at SwinIR's training shapes:
131,072 rows (batch 32 of 64 x 64), 180 channels, hidden 360, drop-path
scales (0, 1/0.9, ...). For each, ``torch.profiler`` over 10 calls gives the
device time of every kernel a call enqueues (mb_ln_kernel, mb_prod_kernel,
am_rowgemm_kernel for dln, mb_lnb_kernel, am_wgrad_kernel and the
reductions). Variants that drop work compute wrong values and only bound the
time of what remains. Prints one line a variant and then one JSON line:
{"card": nvidia-smi's name and power limit, "passes": {variant: [[kernel,
launches, ms], ...]}}.
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
from studiosr_tpu_torch.ops.cuda import mlp_bwd as mb  # noqa: E402
from torch_time_attn_kernels import pass_split  # noqa: E402

OUT = _build.BUILD_DIR.parent / "ablate" / "mlp_bwd"
SRC, COMMON = "mlp_bwd_mma.cu", "am_common.cuh"
WGMMA = '"wgmma.mma_async.sync.aligned.'
GELU = "            am_gauss(h, cdf, pdf);\n"
STORES = ("          *reinterpret_cast<uint4*>(dst + (long long)r * G.HP + 8 * pc) =\n"
          "              *reinterpret_cast<const uint4*>(stg + r * MB_SROW + 8 * pc);\n")
# (variant, [(file, text, replacement)]): each text must occur in its file.
VARIANTS = [
    ("full", []),
    # every wgmma instruction commented out of its PTX (operands, fences and waits stay)
    ("no wgmma products", [("wgmma.cuh", WGMMA, '"// wgmma.mma_async.sync.aligned.'),
                           (COMMON, WGMMA, '"// wgmma.mma_async.sync.aligned.')]),
    ("prod: no GELU (h and dg1 go out as they are)",
     [(SRC, GELU, "            cdf = 0.5f, pdf = 0.f;\n")]),
    ("prod: no gelu(h1) / dh1 stores",
     [(SRC, STORES, "          (void)dst, (void)r, (void)pc;\n")]),
    ("prod: no LN / g_b row copies",
     [(SRC, "    am_load_rows(KC, G.SC, a.ln, tile, true, lnb);\n"
            "    am_load_rows(KC, G.SC, a.gb, tile, true, gbb);\n", "")]),
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
        for fn, args in mb._SIGNATURES_MMA.items():
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = mb._RESTYPES_MMA.get(fn, ctypes.c_int)
        libs[name] = lib
    return libs


def main() -> None:
    dev = resolve_device("cuda")
    libs = build_all()
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    rows, c, hidden, rps = 32 * 64 * 64, 180, 360, 64 * 64
    x, g = randn(rows, c).to(bf), randn(rows, c, scale=1e-3).to(bf)
    ops = (1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, hidden, scale=c**-0.5).to(bf),
           randn(hidden, scale=0.1), randn(hidden, c, scale=hidden**-0.5).to(bf))
    dp = torch.full((32,), 1 / 0.9, device=dev)
    dp[0] = 0.0
    passes = {}
    load = _build.load
    try:
        for name, lib in libs.items():
            _build.load = lambda *_, lib=lib: lib
            passes[name] = pass_split(lambda: mb.mlp_bwd(x, g, *ops, drop_path=dp, rows_per_sample=rps))
            print(f"{name}: " + "; ".join(f"{n.split('(')[0]} x{k:g} {t:.4f}" for n, k, t in passes[name]),
                  flush=True)
    finally:
        _build.load = load
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "passes": passes}))


if __name__ == "__main__":
    main()
