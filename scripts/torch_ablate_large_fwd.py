#!/usr/bin/env python3
"""What bounds the bf16 attention forward above window 16 (B5's large
family, B12's large entry and B10's attention pass above 576 keys): time
ablated copies.

    python3 scripts/torch_ablate_large_fwd.py [--only VARIANT ...]
    PYTHONPATH=<checkout> python3 scripts/torch_ablate_large_fwd.py

Each variant is the package's ``csrc/window_attention_mma.cu``,
``csrc/oca_fwd_mma.cu`` and ``csrc/ocab_mma.cu`` (with their headers) after
the substitutions listed below, built by nvcc with the port's flags into
``build/ablate/large_fwd/<variant>/`` (all at once) and launched through the
package's own wrappers: B5 (``fused_window_attention_block``) at HAT x4's
window-24 step (batch 32 of 72 x 72 maps, C 180, 6 heads, shift 12, drop-path
scales, the bias in bf16), at MaxSR x4's adaptive step on a 289 x 289 crop
(window 17, C 128, 4 heads, no shift, the bias in bf16) and at SwinIR x4
serving at window 24 (one 264 x 264 map, shift 12, the weights and the f32
bias packed once); B12
(``oca_core_fwd``) at the window-24 step's OCA geometry (288 windows, 6
heads, 576 queries, 1296 keys, d 30, the OCAB's transposed views, the bias in
bf16); B10 (``fused_ocab_block``) at HAT x4 serving at window 24 (one 264 x
264 map, overlap 0.5, the blob and a bf16 bias). For each, ``torch.profiler``
over 10 calls gives the device time of every kernel a call enqueues. A
variant lists alternatives, one a design of the attention pass (before the
forward core ``csrc/lf_core.cuh``: ``wa_attn_large_kernel`` and
``of_fwd_ring_kernel``; after it: ``lf_fwd_kernel``); the first whose texts
all occur in the package's sources is applied, and a variant none of whose
alternatives applies is skipped. Variants that drop work compute wrong values
and only bound the time of what remains. Prints one line a variant and case,
then one JSON line: {"package": path, "card": nvidia-smi's name and power
limit, "passes": {variant: {case: [[kernel, launches, ms], ...]}},
"applied": {variant: the alternative's index}}.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if "PYTHONPATH" not in os.environ:
    sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from studiosr_tpu_torch import resolve_device  # noqa: E402
from studiosr_tpu_torch.ops.cuda import _build  # noqa: E402
from studiosr_tpu_torch.ops.cuda import oca_core as oc  # noqa: E402
from studiosr_tpu_torch.ops.cuda import ocab as ob  # noqa: E402
from studiosr_tpu_torch.ops.cuda import window_attention as wa  # noqa: E402
from torch_time_attn_kernels import pass_split  # noqa: E402

OUT = _build.BUILD_DIR.parent / "ablate" / "large_fwd"
# source -> (its wrapper module, the module's signature and restype tables)
SOURCES = {"window_attention_mma": (wa, "_SIGNATURES_MMA", "_RESTYPES_MMA"),
           "oca_fwd_mma": (oc, "_SIGNATURES_FWD_MMA", None), "ocab_mma": (ob, "_SIGNATURES_MMA", "_RESTYPES_MMA")}
WA, OF, LF, COMMON, WINDOW = "window_attention_mma.cu", "of_attn.cuh", "lf_core.cuh", "am_common.cuh", "am_window.cuh"
WGMMA = '"wgmma.mma_async.sync.aligned.'
# (variant, [alternative, ...]), an alternative a list of (file, text, replacement)
VARIANTS = [
    ("full", [[]]),
    # every wgmma instruction commented out of its PTX (operands, fences and waits stay)
    ("no wgmma products", [[("wgmma.cuh", WGMMA, '"// wgmma.mma_async.sync.aligned.'),
                            (COMMON, WGMMA, '"// wgmma.mma_async.sync.aligned.')]]),
    ("no ex2", [[(COMMON, 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x;")]]),
    # the bias: B5 reads a constant, B12 / B10 zeros
    ("no bias reads", [
        [(LF, "      lf_arrive_expect(bar, L.kv_bytes() + BT);", "      lf_arrive_expect(bar, L.kv_bytes());"),
         (LF, "      lf_copy(sb + L.kv_bytes(), bias + (size_t)c * BT, BT, bar);\n", ""),
         (LF, "    lf_add_bias<B16>(s, sbuf + L.kv_bytes());\n", "")],
        [(WINDOW, "  const size_t e = (((size_t)(h * nch + r) * nch + c) * 8 + nt) * 128 + wt;\n  if (!a.bias16)",
          "  const size_t e = (((size_t)(h * nch + r) * nch + c) * 8 + nt) * 128 + wt;\n"
          "  return make_float4(r, c, nt, wt);\n  if (!a.bias16)"),
         (OF, "    if (row < a.nq && a.vec && col + 16 <= a.nk) {", "    if (false) {"),
         (OF, "      for (int i = 0; i < 16; ++i) bv[hh][i] = row < a.nq && col + i < a.nk ? to_f32(__ldg(p + i)) : 0.f;",
          "      for (int i = 0; i < 16; ++i) bv[hh][i] = 0.f;")]]),
    # the shift's regions all equal: no -100 anywhere
    ("no mask regions", [[(WINDOW, "  const int y = (wi / a.nwx) * G.ws + n / G.ws, x = (wi % a.nwx) * G.ws + n % G.ws;\n"
                                   "  return 3 *", "  return 0;\n  const int y = 0, x = 0;\n  return 3 *")]]),
    # the chunk loop's block-wide barriers (the results race)
    ("no block barriers", [
        [(WA, "    __syncthreads();  // chunk c (and q) in for every thread\n", ""),
         (WA, "    __syncthreads();  // every warp is done with buffer c & 1 before chunk c + 2 fills it\n", ""),
         (OF, "    wg_proxy_fence();\n    __syncthreads();\n    const int b = c % OF_STAGES;",
          "    wg_proxy_fence();\n    const int b = c % OF_STAGES;"),
         (OF, "      __syncthreads();  // both warpgroups are done with buffer b\n", "")]]),
    # chunk c's p v waited for with chunk c + 1's scores (the softmax under no product)
    ("no overlap", [[(LF, "    wg_wait1();  // the scores are in", "    wg_wait0();  // the scores are in")]]),
    # other shapes of the same design (a case whose shared memory the shape cannot hold reads NaN)
    ("design: three blocks an SM", [[(LF, "constexpr int LF_BLOCKS = 4;", "constexpr int LF_BLOCKS = 3;")]]),
    ("design: up to six stages", [[(LF, "LF_MIN_STAGES = 2, LF_MAX_STAGES = 4;", "LF_MIN_STAGES = 2, LF_MAX_STAGES = 6;")]]),
    # the softmax of every chunk after the first skipped (p = the raw scores)
    ("no softmax", [[(LF, "    softmax(c + 1, masked);\n", "    sc[0] = sc[1] = 1.f;\n")]]),
    # the key chunks' k and v loaded once (the first buffers serve every chunk)
    ("chunk loads once", [
        [(LF, "      lf_arrive_expect(bar, L.kv_bytes() + BT);\n      lf_copy(sb, f.k(u, c), L.kv_bytes() / 2, bar);\n"
              "      lf_copy(sb + L.kv_bytes() / 2, f.v(u, c), L.kv_bytes() / 2, bar);\n",
          "      lf_arrive_expect(bar, (c < S ? L.kv_bytes() : 0) + BT);\n"
          "      if (c < S) lf_copy(sb, f.k(u, c), L.kv_bytes() / 2, bar), "
          "lf_copy(sb + L.kv_bytes() / 2, f.v(u, c), L.kv_bytes() / 2, bar);\n")],
        [(WA, "      hm_cp_async<16>((v ? Vb : Kb) + b * CH + j * 8, unit + (v ? 2 : 1) * (long long)N * DP + c * CH + j * 8, true);",
          "      if (c == 0) hm_cp_async<16>((v ? Vb : Kb) + b * CH + j * 8, unit + (v ? 2 : 1) * (long long)N * DP + c * CH + j * 8, true);"),
         (OF, "      if (e < cp) hm_cp_async<16>(K + b * tile + 8 * e, kv + c * tile + 8 * e, true);\n"
              "      else if (e < 2 * cp) hm_cp_async<16>(VT + b * tile + 8 * (e - cp), kv + (KT + c) * tile + 8 * (e - cp), true);\n"
              "      else hm_cp_async<16>(Q + 8 * (e - 2 * cp), qs + 8 * (e - 2 * cp), true);\n    }\n    hm_cp_commit();\n  };",
          "      if (e >= 2 * cp || c < OF_STAGES) {\n"
          "      if (e < cp) hm_cp_async<16>(K + b * tile + 8 * e, kv + c * tile + 8 * e, true);\n"
          "      else if (e < 2 * cp) hm_cp_async<16>(VT + b * tile + 8 * (e - cp), kv + (KT + c) * tile + 8 * (e - cp), true);\n"
          "      else hm_cp_async<16>(Q + 8 * (e - 2 * cp), qs + 8 * (e - 2 * cp), true);\n      }\n    }\n"
          "    hm_cp_commit();\n  };")]]),
]


def apply(text_of: dict, alternatives: list):
    """The index of the first alternative whose texts all occur, or None."""
    for i, subs in enumerate(alternatives):
        if all(f in text_of and old in text_of[f] for f, old, _ in subs):
            return i
    return None


def build_all(only=None) -> tuple:
    """({variant: {source: its library}}, {variant: alternative}), every
    variant (of ``only``, and "full") compiled at once."""
    shutil.rmtree(OUT, ignore_errors=True)
    originals = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu*")}
    jobs, applied = [], {}
    for i, (name, alternatives) in enumerate(VARIANTS):
        if only and name != "full" and name not in only:
            continue
        pick = apply(originals, alternatives)
        if pick is None:
            print(f"{name}: no alternative applies to this package, skipped", flush=True)
            continue
        applied[name] = pick
        d = OUT / f"v{i}"
        d.mkdir(parents=True)
        texts = dict(originals)
        for target, old, new in alternatives[pick]:
            texts[target] = texts[target].replace(old, new)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        for src in SOURCES:
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / f"{src}.so"), str(d / f"{src}.cu")]
            log = open(d / f"{src}.log", "w")
            jobs.append((name, src, d, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    libs: dict = {}
    for name, src, d, proc in jobs:
        if proc.wait() != 0:
            raise SystemExit(f"{name}: nvcc failed on {src}\n{(d / f'{src}.log').read_text()[-3000:]}")
        lib = ctypes.CDLL(str(d / f"{src}.so"))
        module, sigs, res = SOURCES[src]
        restypes = getattr(module, res) if res else {}
        for fn, args in getattr(module, sigs).items():
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = restypes.get(fn, ctypes.c_int)
        libs.setdefault(name, {})[src] = lib
    return libs, applied


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", nargs="+", metavar="VARIANT", help="build and time only these variants and full")
    dev = resolve_device("cuda")
    libs, applied = build_all(parser.parse_args().only)
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    real_load = _build.load
    current: dict = {}
    _build.load = lambda name, *a, **k: current[name] if name in current else real_load(name, *a, **k)
    current.update(libs["full"])
    c, heads, ws = 180, 6, 24
    n = ws * ws

    def dense(dt_bias):
        return [1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5).to(bf),
                randn(3 * c, scale=0.1), randn(c, c, scale=c**-0.5).to(bf), randn(c, scale=0.1),
                randn(heads, n, n, scale=0.5).to(dt_bias)]

    x72 = randn(32, 72, 72, c).to(bf)
    dp = torch.full((32,), 1 / 0.9, device=dev)
    dp[0] = 0.0
    step = dense(bf)
    serve = dense(torch.float32)
    serve[2:7] = [wa.pack_window_attention(serve[2], serve[4], serve[6], heads), serve[3], None, serve[5], None]
    x264 = randn(1, 264, 264, c).to(bf)
    q, k, v = (randn(288, m, heads, 30, scale=sc).to(bf).transpose(1, 2)
               for m, sc in ((576, 2 * 30**-0.5), (1296, 1.0), (1296, 1.0)))
    bias = randn(heads, 576, 1296, scale=2.0).to(bf)
    nk = (3 * ws // 2) ** 2
    ocab = [1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5).to(bf),
            randn(3 * c, scale=0.1), randn(c, c, scale=c**-0.5).to(bf), randn(c, scale=0.1),
            randn(heads, n, nk, scale=0.5).to(bf), 1 + randn(c, scale=0.1), randn(c, scale=0.1),
            randn(c, 2 * c, scale=c**-0.5).to(bf), randn(2 * c, scale=0.1),
            randn(2 * c, c, scale=(2 * c)**-0.5).to(bf), randn(c, scale=0.1)]
    ocab[2], ocab[4], ocab[9], ocab[11] = ob.pack_ocab_block(ocab[2], ocab[4], ocab[9], ocab[11], heads), None, None, None
    kw = dict(heads=heads, window_size=ws, shift=ws // 2)
    ops17 = [1 + randn(128, scale=0.1), randn(128, scale=0.1), randn(128, 384, scale=128**-0.5).to(bf),
             randn(384, scale=0.1), randn(128, 128, scale=128**-0.5).to(bf), randn(128, scale=0.1),
             randn(4, 289, 289, scale=0.5).to(bf)]
    x289 = randn(1, 289, 289, 128).to(bf)
    cases = {"B5 hat step ws24": lambda: wa.fused_window_attention_block(x72, *step, drop_path=dp, **kw),
             "B5 maxsr step 289": lambda: wa.fused_window_attention_block(
                 x289, *ops17, heads=4, window_size=17, shift=0, drop_path=torch.ones(1, device=dev)),
             "B5 swinir serving ws24": lambda: wa.fused_window_attention_block(x264, *serve, drop_path=None, **kw),
             "B12 hat step ws24": lambda: oc.oca_core_fwd(q, k, v, bias),
             "B10 hat serving ws24": lambda: ob.fused_ocab_block(x264, *ocab, heads=heads, window_size=ws,
                                                                 overlap_ratio=0.5)}
    passes = {}
    try:
        for name, by_src in libs.items():
            current.clear()
            current.update(by_src)
            passes[name] = {}
            for case, fn in cases.items():
                try:
                    split = passes[name][case] = pass_split(fn)
                except RuntimeError as e:  # a variant's launch the card refuses
                    print(f"{name} [{case}] nan: {e}", flush=True)
                    torch.cuda.synchronize()
                    continue
                total = sum(t for _, _, t in split)
                print(f"{name} [{case}] {total:.4f} ms: " + "; ".join(
                    f"{kn.split('(')[0]} x{cn:g} {t:.4f}" for kn, cn, t in split), flush=True)
    finally:
        _build.load = real_load
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"package": str(Path(wa.__file__).resolve().parents[2]), "card": card, "passes": passes,
                      "applied": applied}))


if __name__ == "__main__":
    main()
