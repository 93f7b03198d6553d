#!/usr/bin/env python3
"""Design choices of B6 and B13 in bf16, measured: time altered copies of their kernels.

    python3 scripts/torch_ablate_mlp_oca.py

Each variant is the checkout's ``csrc/mlp_block_mma.cu`` or
``csrc/oca_bwd_mma.cu`` (with its headers) after the substitutions listed
below, built by nvcc with the port's flags into
``build/ablate/mlp_oca/<variant>/`` (all at once) and launched through the
port's own wrapper in bf16: B6 (``fused_mlp_block``) at SwinIR's training
shapes (131,072 rows, 180 channels, hidden 360, drop-path scales (0, 1/0.9,
...)), B13 (``oca_core_bwd``) at HAT's (512 windows, 6 heads, 256 | 576
tokens, d 30, the OCAB's transposed views). For each, ``torch.profiler``
over 10 calls gives the device time of every kernel a call enqueues.

* B6 "LN row pass": the LayerNorm moved out of the product kernel into a
  pass a warp a row at full occupancy (``am_ln_row``), its rows written to
  the output tensor and copied into the product kernel's K-major LN tile by
  cp.async: the alternative to the in-block LN, one 47 MB round trip more.
  Right for the drop-path form only (the variant drops HAT's join).
* B6 "no GELU", "no wgmma products": bound the time of what remains.
* B13 "in place (b)": no pack pass; the statistics and main passes copy
  their tiles straight from the strided views in 4-byte pieces into the same
  K-major images (the main pass keeps its one-window-ahead prefetch): the
  alternative to pass 0.
* B13 "no dq partials": the main pass stores no dq partial and the dq pass
  is not launched (dq wrong): what dq's chunk partials cost.

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
from studiosr_tpu_torch.ops.cuda import mlp_block as mf  # noqa: E402
from studiosr_tpu_torch.ops.cuda import oca_core as oc  # noqa: E402
from torch_time_attn_kernels import pass_split  # noqa: E402

OUT = _build.BUILD_DIR.parent / "ablate" / "mlp_oca"
MF, OB = "mlp_block_mma.cu", "oca_bwd_mma.cu"
WGMMA = '"wgmma.mma_async.sync.aligned.'

LN_PASS_KERNEL = '''__global__ void __launch_bounds__(256) mf_ln_pass(const MfArgs a, const MfGeom G) {
  for (long long row = blockIdx.x * 8LL + (threadIdx.x >> 5); row < a.rows; row += gridDim.x * 8LL)
    am_ln_row<false>(a.x + row * G.C, nullptr, 1.f, G.C, G.C, a.ln_w, a.ln_b, nullptr, a.out + row * G.C, nullptr);
}

static bool mf_geometry_ok('''
LN_PASS_LOAD = '''    for (int i = tid & 127; i < AM_TOK * (KC / 4); i += 128) {
      const int t = i / (KC / 4), g4 = i % (KC / 4);
      const bool in = row0 + t < a.rows && 4 * g4 < G.C;
      hm_cp_async<8>(lnb + am_kmajor(4 * g4, t, KC), in ? a.out + (row0 + t) * G.C + 4 * g4 : a.out, in);
    }
    hm_cp_commit();
    hm_cp_wait_upto(0);
'''
LN_RUN = "  const int npairs = (a.tiles + 1) / 2, blocks"
LN_PASS_LAUNCH = '''  mf_ln_pass<<<8 * sms, 256, 0, st>>>(a, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
''' + LN_RUN

STATS_COPY = '''    const bf16* src = a.img + u * a.unit_elems;
    const int kv = 2 * a.KT * (int)tile / 8, qg = 2 * (int)tile / 8;  // 16-byte pieces
    const int q0 = 2 * (blockIdx.x % npair);
    for (int e = tid; e < kv + 2 * qg; e += 256) {
      if (e < kv) {
        hm_cp_async<16>(K + 8 * e, src + 2 * a.QT * tile + 8 * e, true);
      } else {
        const int f = e - kv, part = f / qg, r = f % qg;  // part 0: q, 1: g
        // tile q0 + 1 may lie past the last: a copy of the next tile's place, never stored from
        hm_cp_async<16>(QG + part * 2 * tile + 8 * r, src + (part * a.QT + q0) * tile + 8 * r, true);
      }
    }
'''
STATS_IN_PLACE = '''    const int q0 = 2 * (blockIdx.x % npair), P = AM_TOK * DP / 2;  // 4-byte pieces a tile
    for (int e = tid; e < (2 * a.KT + 4) * P; e += 256) {
      const int tl = e / P, t = (e % P) / (DP / 2), j = 2 * (e % (DP / 2));
      int which, ti, n;
      bf16* dst;
      if (tl < a.KT) which = OB_K, ti = tl, n = a.nk, dst = K + tl * tile;
      else if (tl < 2 * a.KT) which = OB_V, ti = tl - a.KT, n = a.nk, dst = V + (tl - a.KT) * tile;
      else if (tl < 2 * a.KT + 2) which = OB_Q, ti = q0 + tl - 2 * a.KT, n = a.nq;
      else which = OB_G, ti = q0 + tl - 2 * a.KT - 2, n = a.nq;
      if (tl >= 2 * a.KT) dst = QG + (tl - 2 * a.KT) * tile;
      const int token = ti * AM_TOK + t;
      const bool in = token < n && j < a.d;
      const bf16* base = which == OB_Q ? a.q : which == OB_G ? a.g : which == OB_K ? a.k : a.v;
      const bf16* s = base + (u / a.heads) * a.st[which][0] + (u % a.heads) * a.st[which][1] +
                      (long long)token * a.st[which][2] + j;
      hm_cp_async<4>(dst + am_kmajor(j, t, DP), in ? s : base, in);
    }
'''
MAIN_COPY = '''    const bf16* img = a.img + u * a.unit_elems;
    const int qp = QT * AM_TOK * DP / 8, kp = AM_TOK * DP / 8, sp = QT * AM_TOK * 3 / 4;  // 16-byte pieces
    const float* sts = a.stats + u * QT * AM_TOK * 3;
    for (int e = tid; e < 2 * qp + 2 * kp + sp; e += 256) {
      if (e < qp) hm_cp_async<16>(Qk + 8 * e, img + 8 * e, true);
      else if (e < 2 * qp) hm_cp_async<16>(Gk + 8 * (e - qp), img + QT * tile_elems + 8 * (e - qp), true);
      else if (e < 2 * qp + kp)
        hm_cp_async<16>(Kk + 8 * (e - 2 * qp), img + (2 * QT + c) * tile_elems + 8 * (e - 2 * qp), true);
      else if (e < 2 * qp + 2 * kp)
        hm_cp_async<16>(Vk + 8 * (e - 2 * qp - kp), img + (2 * QT + KT + c) * tile_elems + 8 * (e - 2 * qp - kp),
                        true);
      else hm_cp_async<16>(stat + 4 * (e - 2 * qp - 2 * kp), sts + 4 * (e - 2 * qp - 2 * kp), true);
    }
'''
MAIN_IN_PLACE = '''    // 4-byte pieces a tile; the statistics in 16-byte pieces
    const int P = AM_TOK * DP / 2, sp = QT * AM_TOK * 3 / 4;
    const float* sts = a.stats + u * QT * AM_TOK * 3;
    for (int e = tid; e < (2 * QT + 2) * P + sp; e += 256) {
      if (e >= (2 * QT + 2) * P) {
        hm_cp_async<16>(stat + 4 * (e - (2 * QT + 2) * P), sts + 4 * (e - (2 * QT + 2) * P), true);
        continue;
      }
      const int tl = e / P, t = (e % P) / (DP / 2), j = 2 * (e % (DP / 2));
      int which, ti, n;
      bf16* dst;
      if (tl < QT) which = OB_Q, ti = tl, n = a.nq, dst = Qk + tl * tile_elems;
      else if (tl < 2 * QT) which = OB_G, ti = tl - QT, n = a.nq, dst = Gk + (tl - QT) * tile_elems;
      else if (tl == 2 * QT) which = OB_K, ti = c, n = a.nk, dst = Kk;
      else which = OB_V, ti = c, n = a.nk, dst = Vk;
      const int token = ti * AM_TOK + t;
      const bool in = token < n && j < a.d;
      const bf16* base = which == OB_Q ? a.q : which == OB_G ? a.g : which == OB_K ? a.k : a.v;
      const bf16* s = base + (long long)w * a.st[which][0] + h * a.st[which][1] +
                      (long long)token * a.st[which][2] + j;
      hm_cp_async<4>(dst + am_kmajor(j, t, DP), in ? s : base, in);
    }
'''
PACK_LAUNCH = ("  ob_pack_kernel<DP><<<(int)((pieces + 255) / 256 < 8192 ? (pieces + 255) / 256 : 8192), 256, 0, "
               "st>>>(a);\n  cudaError_t err = cudaGetLastError();\n")
DQ_STORE = '''      if (i < QT) {
        float4* part = (float4*)a.dqp + ((u * KT + c) * QT + i) * NDT * 128;'''
DQ_LAUNCH = '''  ob_dq_kernel<DP><<<(int)((quads + 255) / 256 < 8192 ? (quads + 255) / 256 : 8192), 256, 0, st>>>(a);
'''

# (kernel, variant, [(file, text, replacement)]): each text must occur in its file.
VARIANTS = [
    ("B6", "full", []),
    ("B6", "LN row pass", [(MF, "static bool mf_geometry_ok(", LN_PASS_KERNEL),
                           (MF, "    mf_layernorm16<EXTRA>(a, G, row0 + 16 * wr, lnb, 16 * wr);\n", LN_PASS_LOAD),
                           (MF, LN_RUN, LN_PASS_LAUNCH)]),
    ("B6", "no GELU", [(MF, "            am_gauss(h, cdf, pdf);\n", "            cdf = 0.5f, pdf = 0.f;\n")]),
    ("B6", "no wgmma products", [("wgmma.cuh", WGMMA, '"// wgmma.mma_async.sync.aligned.'),
                                 ("am_common.cuh", WGMMA, '"// wgmma.mma_async.sync.aligned.')]),
    ("B13", "full", []),
    ("B13", "in place (b)", [(OB, STATS_COPY, STATS_IN_PLACE), (OB, MAIN_COPY, MAIN_IN_PLACE),
                             (OB, PACK_LAUNCH, "  (void)pieces;\n  cudaError_t err = cudaSuccess;\n")]),
    ("B13", "no dq partials", [(OB, DQ_STORE, "      if (false) {\n        float4* part = nullptr;"),
                               (OB, DQ_LAUNCH, "  (void)quads;\n")]),
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
        src = MF if kernel == "B6" else OB
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / src)]
        log = open(d / "log.txt", "w")
        jobs.append((kernel, name, d, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    libs = {}
    for kernel, name, d, proc in jobs:
        if proc.wait() != 0:
            raise SystemExit(f"{kernel} {name}: nvcc failed\n{(d / 'log.txt').read_text()[-3000:]}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        sigs, rest = (mf._SIGNATURES_MMA, mf._RESTYPES_MMA) if kernel == "B6" else (oc._SIGNATURES_MMA, {})
        for fn, args in sigs.items():
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = rest.get(fn, ctypes.c_int)
        libs[(kernel, name)] = lib
    return libs


def main() -> None:
    dev = resolve_device("cuda")
    libs = build_all()
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    rows, c, hidden, rps = 32 * 64 * 64, 180, 360, 64 * 64
    x = randn(rows, c).to(bf)
    ops = (1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, hidden, scale=c**-0.5).to(bf),
           randn(hidden, scale=0.1), randn(hidden, c, scale=hidden**-0.5).to(bf), randn(c, scale=0.1))
    dp = torch.full((32,), 1 / 0.9, device=dev)
    dp[0] = 0.0

    def view(n, scale):  # (512, 6, n, 30) over (512, n, 6, 30) storage, as the OCAB's views
        return randn(512, n, 6, 30, scale=scale).to(bf).transpose(1, 2)

    q, k, v, go = view(256, 2 * 30**-0.5), view(576, 1.0), view(576, 1.0), view(256, 1.0)
    bias = randn(6, 256, 576, scale=2.0)
    calls = {"B6": lambda: mf.fused_mlp_block(x, *ops, drop_path=dp, rows_per_sample=rps),
             "B13": lambda: oc.oca_core_bwd(q, k, v, bias, go)}
    passes = {}
    load = _build.load
    try:
        for (kernel, name), lib in libs.items():
            _build.load = lambda *_, lib=lib: lib
            key = f"{kernel} {name}"
            passes[key] = pass_split(calls[kernel])
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
