#!/usr/bin/env python3
"""Design choices of B11 and B12 in bf16, measured: time altered copies of their kernels.

    python3 scripts/torch_ablate_cab_oca.py

Each variant is the checkout's ``csrc/cab_mma.cu`` or ``csrc/oca_fwd_mma.cu``
(with its headers) after the substitutions listed below, built by nvcc with
the port's flags into ``build/ablate/cab_oca/<variant>/`` (all at once) and
launched through the port's own wrapper in bf16: B11 (``fused_cab_body``) at
HAT x4 serving's shapes (a 256 x 256 x 180 map, Cm 60, the convs packed once
as serving holds them), B12 (``oca_core_fwd``) at HAT's training step (512
windows, 6 heads, 256 | 576 tokens, d 30, the OCAB's transposed views), its
bias in bf16 as the bf16 step hands it over and in f32. For each,
``torch.profiler`` over 10 calls gives the device time of every kernel a
call enqueues: B11's four passes (LN, conv1, conv2, the sum), B12's two
(pack, attention).

* B11 "no wgmma products", "no GELU": bound the time of what remains of the
  convs (staging, the ring, the epilogues).
* B11 "3-slot ring": one step in flight beyond the one multiplied instead
  of two (less shared memory, a slot's copy less hidden).
* B11 "LN in conv1's staging": no LN row pass; conv1's blocks compute the
  LayerNorm of each patch pixel from x (a warp a pixel, halo pixels
  recomputed) and store it into the patch's planes: the alternative to the
  row pass (one 49 MB round trip less, the LN on the conv's critical path).
* B12 "no bias reads": the bias fragments are zeros: what the bias reads
  (1.8 GB from L2 in f32, 0.9 in bf16) cost the attention pass.
* B12 "no wgmma products": bounds the softmax and the copies.

Variants that drop work compute wrong values and only bound the time of
what remains. Prints one line a variant and then one JSON line: {"card":
nvidia-smi's name and power limit, "passes": {variant: [[kernel, launches,
ms], ...]}}.
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
from studiosr_tpu_torch.ops.cuda import conv3x3 as cv  # noqa: E402
from studiosr_tpu_torch.ops.cuda import oca_core as oc  # noqa: E402
from torch_time_attn_kernels import pass_split  # noqa: E402

OUT = _build.BUILD_DIR.parent / "ablate" / "cab_oca"
CB, OF = "cab_mma.cu", "oca_fwd_mma.cu"
WGMMA = '"wgmma.mma_async.sync.aligned.'
NO_WGMMA = [("wgmma.cuh", WGMMA, '"// wgmma.mma_async.sync.aligned.'),
            ("am_common.cuh", WGMMA, '"// wgmma.mma_async.sync.aligned.')]

LN_ARGS = ("  float res_scale;\n};",
           "  float res_scale;\n  const cb_bf16* x;\n  const float *lnw, *lnb;\n  int C;\n};")
LN_PASS = """  cb_ln_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>((const cb_bf16*)x, (const float*)ln_w,
                                                          (const float*)ln_b, (cb_bf16*)ln, rows, C, KP);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const CbArgs a1{(const cb_bf16*)ln, (const cb_bf16*)w1, (const float*)b1, (cb_bf16*)h1, nullptr, H, W, Cm,
                  CB_N1, 1.f};"""
LN_FOLDED = """  (void)rows;
  cudaError_t err = cudaSuccess;
  CbArgs a1{(const cb_bf16*)ln, (const cb_bf16*)w1, (const float*)b1, (cb_bf16*)h1, nullptr, H, W, Cm, CB_N1, 1.f};
  a1.x = (const cb_bf16*)x, a1.lnw = (const float*)ln_w, a1.lnb = (const float*)ln_b, a1.C = C;"""
PATCH_COPY = """  for (int i = tid; i < CB_PH * CB_PW * PLANES; i += CB_THREADS) {
    const int px = i / PLANES, cg = i - px * PLANES;
    const int gy = y0 - 1 + px / CB_PW, gx = x0 - 1 + px % CB_PW;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    hm_cp_async<16>(patch + cg * CB_PLANE + px * 16, ok ? xb + ((size_t)gy * W + gx) * KP + 8 * cg : a.in, ok);
  }"""
PATCH_LN = """  if constexpr (!CONV2) {  // a warp a patch pixel: its LN from x into the planes, zero outside the image
    for (int px = warp; px < CB_PH * CB_PW; px += CB_THREADS / 32) {
      const int gy = y0 - 1 + px / CB_PW, gx = x0 - 1 + px % CB_PW;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const cb_bf16* xr = a.x + (((size_t)b * H + (ok ? gy : 0)) * W + (ok ? gx : 0)) * a.C;
      float2 v[3];
      float sm = 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int c = 2 * (lane + 32 * j);
        v[j] = ok && c < a.C ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + c))
                             : make_float2(0.f, 0.f);
        sm += v[j].x + v[j].y;
      }
      const float mean = warp_sum(sm) / a.C;
      float qv = 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (2 * (lane + 32 * j) < a.C) qv += (v[j].x - mean) * (v[j].x - mean) + (v[j].y - mean) * (v[j].y - mean);
      const float rstd = rsqrtf(warp_sum(qv) / a.C + 1e-5f);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int c = 2 * (lane + 32 * j);
        if (c >= KP) continue;
        const bool in = ok && c < a.C;
        *reinterpret_cast<__nv_bfloat162*>(patch + (c / 8) * CB_PLANE + px * 16 + (c % 8) * 2) =
            __floats2bfloat162_rn(in ? (v[j].x - mean) * rstd * a.lnw[c] + a.lnb[c] : 0.f,
                                  in ? (v[j].y - mean) * rstd * a.lnw[c + 1] + a.lnb[c + 1] : 0.f);
      }
    }
  } else {
""" + PATCH_COPY + "\n  }"

# (kernel, variant, [(file, text, replacement)]): each text must occur in its file.
VARIANTS = [
    ("B11", "full", []),
    ("B11", "no wgmma products", NO_WGMMA),
    ("B11", "no GELU", [(CB, "{ return 0.5f * v * (1.f + erff(v * 0.70710678118654752f)); }", "{ return v; }")]),
    ("B11", "3-slot ring", [(CB, "constexpr int CB_STAGES = 4;", "constexpr int CB_STAGES = 3;")]),
    ("B11", "LN in conv1's staging", [(CB, *LN_ARGS), (CB, LN_PASS, LN_FOLDED), (CB, PATCH_COPY, PATCH_LN)]),
    ("B12", "full", []),
    ("B12", "no bias reads", [(OF, "    of_bias16<BT>(a, h, r0, key0, bv);",
                               "    for (int i = 0; i < 32; ++i) bv[i / 16][i % 16] = 0.f;")]),
    ("B12", "no wgmma products", NO_WGMMA),
]


def build_all() -> dict:
    """{(kernel, variant): its library}, every variant compiled at once."""
    shutil.rmtree(OUT, ignore_errors=True)
    jobs = []
    for i, (kernel, name, subs) in enumerate(VARIANTS):
        d = OUT / f"v{i}"
        d.mkdir(parents=True)
        for p in _build.CSRC.glob("*.cu*"):
            shutil.copy(p, d / p.name)
        for target, old, new in subs:
            text = (d / target).read_text()
            if old not in text:
                raise SystemExit(f"{kernel} {name}: {old!r} is not in {target}")
            (d / target).write_text(text.replace(old, new))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / (CB if kernel == "B11" else OF))]
        log = open(d / "log.txt", "w")
        jobs.append((kernel, name, d, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    libs = {}
    for kernel, name, d, proc in jobs:
        if proc.wait() != 0:
            raise SystemExit(f"{kernel} {name}: nvcc failed\n{(d / 'log.txt').read_text()[-3000:]}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        sigs = cv._CAB_MMA_SIGNATURES if kernel == "B11" else oc._SIGNATURES_FWD_MMA
        for fn, args in sigs.items():
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = ctypes.c_int
        libs[(kernel, name)] = lib
    return libs


def main() -> None:
    dev = resolve_device("cuda")
    libs = build_all()
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    x = randn(1, 256, 256, 180).to(bf)
    w1, w2 = cv.pack_cab_convs(randn(3, 3, 180, 60, scale=(9 * 180) ** -0.5).to(bf),
                               randn(3, 3, 60, 180, scale=(9 * 60) ** -0.5).to(bf))
    cab = (1 + randn(180, scale=0.1), randn(180, scale=0.1), w1, randn(60, scale=0.1), w2, randn(180, scale=0.1))

    def view(n, scale):  # (512, 6, n, 30) over (512, n, 6, 30) storage, as the OCAB's views
        return randn(512, n, 6, 30, scale=scale).to(bf).transpose(1, 2)

    q, k, v = view(256, 2 * 30**-0.5), view(576, 1.0), view(576, 1.0)
    bias = randn(6, 256, 576, scale=2.0)
    bias16 = bias.to(bf)
    calls = {"B11": [("", lambda: cv.fused_cab_body(x, *cab))],
             "B12": [(" (bf16 bias)", lambda: oc.oca_core_fwd(q, k, v, bias16)),
                     (" (f32 bias)", lambda: oc.oca_core_fwd(q, k, v, bias))]}
    passes = {}
    load = _build.load
    try:
        for (kernel, name), lib in libs.items():
            _build.load = lambda *_, lib=lib: lib
            for suffix, call in calls[kernel]:
                key = f"{kernel} {name}{suffix}"
                passes[key] = pass_split(call)
                total = sum(t for _, _, t in passes[key])
                print(f"{key}: {total:.4f} ms; " + "; ".join(f"{n.split('(')[0]} x{n_:g} {t:.4f}"
                                                            for n, n_, t in passes[key]), flush=True)
    finally:
        _build.load = load
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "passes": passes}))


if __name__ == "__main__":
    main()
