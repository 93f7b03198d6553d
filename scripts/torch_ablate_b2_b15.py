#!/usr/bin/env python3
"""What bounds B2 and B15 in bf16: time ablated copies of their kernels.

    python3 scripts/torch_ablate_b2_b15.py

Each variant is the checkout's ``csrc/conv3x3.cu`` or ``csrc/window_attn.cu``
with one substitution in its source (listed below), built by nvcc with the
port's flags into ``build/ablate/<variant>/`` (all at once) and launched
through the port's own wrapper. Times are CUDA events over 30 launches after
5 warm-up launches, in bf16 at the main paths' shapes: B2 on SwinIR's 264 x
264 x 180 map with the skip map and its packed weights (and HAT's 256 x
256), B15 at MaxSR x4's adaptive (256 windows of 256 tokens, no bias) and
static (1024 windows of 64 tokens, a (4, 64, 64) bias) shapes with
``F.scaled_dot_product_attention`` beside them. Variants that drop work
compute wrong values and only bound the time of what remains; the others
are checked against the plain version (relative L2). Prints one JSON line:
{"card": nvidia-smi's name and power limit, "ms": {variant: ms}, "rel_l2":
{variant: error}}.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from studiosr_tpu_torch import resolve_device  # noqa: E402
from studiosr_tpu_torch.ops.attention import attention_plain  # noqa: E402
from studiosr_tpu_torch.ops.cuda import _build  # noqa: E402
from studiosr_tpu_torch.ops.cuda import conv3x3 as conv_mod  # noqa: E402
from studiosr_tpu_torch.ops.cuda import window_attn as attn_mod  # noqa: E402

OUT = _build.BUILD_DIR.parent / "ablate"
B2_LAUNCH = "  return cm_launch<8, 16, 2, 6, 4, 4>(a, stream);"
B15_BOUNDS = "__launch_bounds__(WF_THREADS, KS <= 2 ? 4 : 2)"
B15_EXP = "            const float pe = wf_exp2(fmaf(s[nt][e], WF_LOG2E, -mb[e >> 1]));"
B15_PV = "            hm_mma(o[dn], pa[kk], b0, b1);\n            hm_mma(o[dn + 1], pa[kk], b2, b3);"
# (variant, source file, [(text, replacement)]): each text must occur in the source
VARIANTS = [
    ("b2", "conv3x3_mma.cuh", []),
    ("b2 8 warps of 64 x 48", "conv3x3_mma.cuh",
     [(B2_LAUNCH, "  return cm_launch<8, 16, 4, 6, 2, 4>(a, stream);"),
      ("static_assert(CmShape<8, 16, 2, 6, 4, 4>::NP", "static_assert(CmShape<8, 16, 4, 6, 2, 4>::NP")]),
    ("b2 12 warps, 6 x 24 tile", "conv3x3_mma.cuh",
     [(B2_LAUNCH, "  return cm_launch<6, 24, 3, 6, 3, 4>(a, stream);"),
      ("static_assert(CmShape<8, 16, 2, 6, 4, 4>::NP", "static_assert(CmShape<6, 24, 3, 6, 3, 4>::NP")]),
    ("b2 weights staged once (drops their copies)", "conv3x3_mma.cuh",
     [("      for (int i = tid; i < S::WTS / 8; i += S::THREADS) hm_cp_async<16>",
       "      if (s < CM_STAGES) for (int i = tid; i < S::WTS / 8; i += S::THREADS) hm_cp_async<16>")]),
    ("b2 no mma (copies and ldmatrix only)", "conv3x3_mma.cuh",
     [("        for (int j = 0; j < NT; ++j) hm_mma(acc[i][j], af, bf[j][0], bf[j][1]);",
       "        for (int j = 0; j < NT; ++j) acc[i][j][0] += __uint_as_float(af[0] ^ bf[j][0]);")]),
    ("b15", "window_attn.cu", []),
    ("b15 three blocks an SM", "window_attn.cu", [(B15_BOUNDS, "__launch_bounds__(WF_THREADS, KS <= 2 ? 3 : 2)")]),
    ("b15 no exp2 (softmax without its MUFU)", "window_attn.cu",
     [(B15_EXP, "            const float pe = fmaf(s[nt][e], WF_LOG2E, -mb[e >> 1]);")]),
    ("b15 no p v products", "window_attn.cu",
     [(B15_PV, "            o[dn][0] += __uint_as_float(pa[kk][0] ^ b0 ^ b1);\n"
               "            o[dn + 1][0] += __uint_as_float(pa[kk][1] ^ b2 ^ b3);")]),
]


def build_all() -> dict:
    """{variant: its library}, every variant compiled at once."""
    shutil.rmtree(OUT, ignore_errors=True)
    jobs = []
    for i, (name, target, subs) in enumerate(VARIANTS):
        d = OUT / f"v{i}"
        d.mkdir(parents=True)
        for p in _build.CSRC.glob("*.cu*"):
            shutil.copy(p, d / p.name)
        text = (d / target).read_text()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in {target}")
            text = text.replace(old, new)
        (d / target).write_text(text)
        source = "conv3x3.cu" if name.startswith("b2") else "window_attn.cu"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / source)]
        jobs.append((name, d, subprocess.Popen(cmd, stdout=open(d / "log.txt", "w"), stderr=subprocess.STDOUT)))
    libs = {}
    for name, d, proc in jobs:
        if proc.wait() != 0:
            raise SystemExit(f"{name}: nvcc failed\n{(d / 'log.txt').read_text()[-3000:]}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        signatures = conv_mod._SIGNATURES if name.startswith("b2") else attn_mod._SIGNATURES
        for fn, args in signatures.items():
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_l2(a, b) -> float:
    return float((a.float() - b).norm() / b.norm())


def main() -> None:
    dev = resolve_device("cuda")
    libs = build_all()
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    x = torch.randn(1, 264, 264, 180, generator=gen).to(dev, bf)
    x256 = torch.randn(1, 256, 256, 180, generator=gen).to(dev, bf)
    w = (torch.randn(3, 3, 180, 180, generator=gen) * (9 * 180) ** -0.5).to(dev, bf)
    b = (torch.randn(180, generator=gen) * 0.1).to(dev)
    wp = conv_mod.pack_conv3x3_weights(w)
    want = conv_mod.conv3x3_plain(x.float(), w.float(), b, extra=x.float())
    attn = {}
    for mode, windows, n, with_bias in (("adaptive", 256, 256, False), ("static", 1024, 64, True)):
        qkv = torch.randn(windows, n, 3, 4, 32, generator=gen).to(dev, bf).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * 32**-0.5, qkv[1], qkv[2]
        bias = torch.randn(4, n, n, generator=gen).to(dev) if with_bias else None
        attn[mode] = (q, k, v, bias, attention_plain(q.float(), k.float(), v.float(), bias, None))
    ms, errors = {}, {}
    load = _build.load
    try:
        for name, lib in libs.items():
            _build.load = lambda *_, lib=lib: lib
            if name.startswith("b2"):
                errors[name] = rel_l2(conv_mod.fused_conv3x3(x, wp, b, extra=x), want)
                ms[f"{name} @264"] = time_ms(lambda: conv_mod.fused_conv3x3(x, wp, b, extra=x))
                ms[f"{name} @256"] = time_ms(lambda: conv_mod.fused_conv3x3(x256, wp, b, extra=x256))
            else:
                for mode, (q, k, v, bias, ref) in attn.items():
                    errors[f"{name} {mode}"] = rel_l2(attn_mod.window_attention(q, k, v, bias=bias), ref)
                    ms[f"{name} {mode}"] = time_ms(lambda: attn_mod.window_attention(q, k, v, bias=bias))
    finally:
        _build.load = load
    w_oihw, x_nchw = w.permute(3, 2, 0, 1).contiguous(), x.permute(0, 3, 1, 2)
    ms["cuDNN conv2d + add @264"] = time_ms(lambda: F.conv2d(x_nchw, w_oihw, b.to(bf), padding=1).permute(0, 2, 3, 1) + x)
    for mode, (q, k, v, bias, _) in attn.items():
        mask = None if bias is None else bias.to(bf)
        ms[f"SDPA {mode}"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "ms": ms, "rel_l2": errors}))


if __name__ == "__main__":
    main()
