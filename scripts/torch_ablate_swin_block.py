"""Ablation timing of the port's B1 kernel (csrc/swin_block.cu) on one GPU.

    python3 scripts/torch_ablate_swin_block.py

Builds variants of the bf16 Swin block kernel by source substitution, each
with one part of its work removed (the results are wrong; only the times
matter) or one design choice changed, and times each at the main path's
shape (1 x 264 x 264 x 180, 6 heads, hidden 360, shift 4) with CUDA
events. The gap between the full kernel and a variant is what that part
costs. Variants are built into build/ablate/ and loaded with ctypes like
the real kernel.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from studiosr_tpu_torch.ops.cuda import _build  # noqa: E402
from studiosr_tpu_torch.ops.cuda.swin_block import _ARGS, packed_elements  # noqa: E402

SRC = ROOT / "studiosr_tpu_torch" / "csrc" / "swin_block.cu"
OUT = ROOT / "build" / "ablate"

# name -> [(old, new), ...] substitutions into swin_block.cu
VARIANTS = {
    "full": [],
    "no_gather": [("xs[i] = x[src(t) + (i - t * C)];", "xs[i] = from_f32<T>(0.f);")],
    "no_stage_loads": [("cp_async16(dst + r * SB_BL + c, B + (size_t)(k0 + r) * ldb + n0 + c);", "")],
    "no_pack": [("swin_pack_kernel<T><<<", "if (0) swin_pack_kernel<T><<<")],
    "no_epilogue_loads": [
        ("v = acc + bqkv[part * C + h * d + j];", "v = acc;"),
        ("float v = acc + relbias[(h * SB_TOK + r) * SB_TOK + n];", "float v = acc;"),
        ("(acc + bproj[n])", "acc"),
        ("const float v = acc + b1[n];", "const float v = acc;"),
        ("(acc + b2[n])", "acc"),
    ],
    "no_mma": [("wmma::mma_sync(frag[j], af, bf, frag[j]);", "")],
    # the products whose results no epilogue reads go too (the compiler
    # drops them), so this times the epilogues and the tensor-core work
    "no_epilogues": [("if (n < N) epi(mf * 16", "if (n < 0) epi(mf * 16")],
    "no_skew": [("constexpr int SB_SKEW = 8;", "constexpr int SB_SKEW = 0;")],
    # not a removal: one window per SM (shared memory padded past half the SM's)
    "one_window_per_sm": [("L.total = L.bst + 2 * SB_KC * SB_BL * tsz;", "L.total = 120000;")],
}


def build_variants():
    OUT.mkdir(parents=True, exist_ok=True)
    base = SRC.read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = base
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: pattern not found: {old}")
            text = text.replace(old, new)
        cu = OUT / f"swin_block_{name}.cu"
        cu.write_text(text.replace('#include "common.cuh"', f'#include "{SRC.parent / "common.cuh"}"'))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        regs = [line.split(":", 1)[-1].strip() for line in log.splitlines() if "registers" in line]
        print(f"built {name}: {' | '.join(regs)}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    build_variants()
    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(0)
    c, heads, hidden, hw, shift = 180, 6, 360, 264, 4

    def rnd(*shape, dtype=dt, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    x = rnd(1, hw, hw, c)
    f32 = torch.float32
    ops = [rnd(c, dtype=f32) + 1, rnd(c, dtype=f32), rnd(c, 3 * c, scale=c**-0.5), rnd(3 * c, dtype=f32),
           rnd(c, c, scale=c**-0.5), rnd(c, dtype=f32), rnd(heads, 64, 64, dtype=f32),
           rnd(c, dtype=f32) + 1, rnd(c, dtype=f32), rnd(c, hidden, scale=c**-0.5), rnd(hidden, dtype=f32),
           rnd(hidden, c, scale=hidden**-0.5), rnd(c, dtype=f32)]
    out = torch.empty_like(x)
    pack = packed_elements(c, heads, hidden)
    packed = torch.empty(pack, dtype=dt, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for name in VARIANTS:
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        fn = lib.swin_block_bf16
        fn.argtypes, fn.restype = list(_ARGS), ctypes.c_int

        def launch():
            status = fn(x.data_ptr(), out.data_ptr(), 1, hw, hw, c, heads, hidden, shift,
                        *[t.data_ptr() for t in ops], packed.data_ptr(), pack, stream)
            if status:
                raise RuntimeError(f"{name}: launch error {status}")

        for _ in range(3):
            launch()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(20):
            launch()
        end.record()
        torch.cuda.synchronize()
        print(f"{name}: {start.elapsed_time(end) / 20:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
