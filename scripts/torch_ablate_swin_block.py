"""Ablation timing of the port's bf16 B1 kernel on one GPU.

    python3 scripts/torch_ablate_swin_block.py [--checkout DIR] [--kernel mma|legacy]

Builds variants of a checkout's bf16 Swin block kernel by source
substitution, each with one part of its work removed (the results are
wrong; only the times matter) or one design choice changed, and times each
at the main path's shape (1 x 264 x 264 x 180, 6 heads, hidden 360, shift
4) with CUDA events over 20 launches after 3. The gap between the full
kernel and a variant is what that part costs. Variants are built into
build/ablate/<kernel>/ (the checkout's csrc/ copied with the substitutions)
and loaded with ctypes like the real kernel.

``--kernel mma`` (the default) ablates ``csrc/swin_block_mma.cu``, the
kernel written for the H100, on weights packed by this tree's
``pack_swin_weights``; ``--kernel legacy`` ablates the bf16 entry of
``csrc/swin_block.cu`` as the port had it before that kernel (point
``--checkout`` at such a checkout).
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from studiosr_tpu_torch.ops.cuda import _build  # noqa: E402

OUT = ROOT / "build" / "ablate"

# kernel -> (source, {variant: [(old, new), ...]}); each pattern is replaced
# in whichever files of csrc/ hold it, and must be found in one
VARIANTS = {
    "mma": ("swin_block_mma.cu", {
        "full": [],
        # x rows zero-filled, not read
        "no_gather": [("hm_cp_async<8>(xw + r * LX + c, valid ? a.x + src(r) + c : a.x, valid);",
                       "hm_cp_async<8>(xw + r * LX + c, a.x, false);")],
        "no_store": [("*reinterpret_cast<uint2*>(a.out + src(r) + c) = *reinterpret_cast<const uint2*>(xw + r * LX + c);",
                      "")],
        # the ring's stages marked full without a byte copied
        "no_bulk_copies": [("sm_bulk_load(slots + (size_t)sl * SM_SLOT_BYTES, w + off[j], 2 * (off[j + 1] - off[j]), &full[sl]);",
                            "sm_bar_arrive(&full[sl]);")],
        # every wgmma instruction commented out of its PTX (operands, fences and waits stay)
        "no_products": [('"wgmma.mma_async.sync.aligned.', '"// wgmma.mma_async.sync.aligned.')],
        "no_layernorms": [("sm_layernorm16(xw, LX, lnb, 16 * wr, KC, C, a.ln1_w, a.ln1_b);", ""),
                          ("sm_layernorm16(xw, LX, lnb, 16 * wr, KC, C, a.ln2_w, a.ln2_b);", "")],
        "no_exp": [("s[nt][i] = sm_exp2(fmaf(s[nt][i], SM_LOG2E, -mb[i >> 1]));",
                    "s[nt][i] = fmaf(s[nt][i], SM_LOG2E, -mb[i >> 1]);")],
        "no_gelu": [("return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));", "return v;")],
        "no_window_sync": [('asm volatile("bar.sync %0, 128;\\n" ::"r"(1 + win) : "memory");', "")],
        # not a removal: one window a block, so every staged byte serves 64 tokens
        "one_window_a_block": [("constexpr int SM_WINDOWS = 2;", "constexpr int SM_WINDOWS = 1;")],
    }),
    "legacy": ("swin_block.cu", {
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
    }),
}


def build_variants(checkout: Path, kernel: str) -> dict:
    source, variants = VARIANTS[kernel]
    csrc = checkout / "studiosr_tpu_torch" / "csrc"
    files = {p.name: p.read_text() for p in csrc.iterdir() if p.suffix in (".cu", ".cuh")}
    procs, libs = {}, {}
    for name, subs in variants.items():
        texts = dict(files)
        for old, new in subs:
            hits = [f for f, t in texts.items() if old in t]
            if not hits:
                raise SystemExit(f"variant {name}: pattern not found: {old}")
            for f in hits:
                texts[f] = texts[f].replace(old, new)
        out = OUT / kernel / name
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        for f, t in texts.items():
            (out / f).write_text(t)
        libs[name] = out / "variant.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(libs[name]), str(out / source)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        regs = [line.split(":", 1)[-1].strip() for line in log.splitlines() if "registers" in line or "spill" in line]
        print(f"built {name}: {' | '.join(regs)}", flush=True)
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", type=Path, default=ROOT, help="checkout whose csrc/ is ablated")
    parser.add_argument("--kernel", choices=sorted(VARIANTS), default="mma")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print(f"ablating the {args.kernel} kernel of {args.checkout.resolve()}", flush=True)
    libs = build_variants(args.checkout.resolve(), args.kernel)
    dev, dt, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    g = torch.Generator().manual_seed(0)
    c, heads, hidden, hw, shift = 180, 6, 360, 264, 4

    def rnd(*shape, dtype=dt, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    x = rnd(1, hw, hw, c)
    ln1_w, ln1_b, wqkv, bqkv = rnd(c, dtype=f32) + 1, rnd(c, dtype=f32), rnd(c, 3 * c, scale=c**-0.5), rnd(3 * c, dtype=f32)
    wproj, bproj, bias = rnd(c, c, scale=c**-0.5), rnd(c, dtype=f32), rnd(heads, 64, 64, dtype=f32)
    ln2_w, ln2_b, w1, b1 = rnd(c, dtype=f32) + 1, rnd(c, dtype=f32), rnd(c, hidden, scale=c**-0.5), rnd(hidden, dtype=f32)
    w2, b2 = rnd(hidden, c, scale=hidden**-0.5), rnd(c, dtype=f32)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    if args.kernel == "mma":
        from studiosr_tpu_torch.ops.cuda.swin_block import _MMA_ARGS, pack_swin_weights

        blob = pack_swin_weights(wqkv, wproj, bias, w1, w2, heads)
        ptrs = [t.data_ptr() for t in (ln1_w, ln1_b, bqkv, bproj, ln2_w, ln2_b, b1, b2)]
        entry, argtypes = "swin_block_mma_bf16", _MMA_ARGS
        call = (x.data_ptr(), out.data_ptr(), blob.data_ptr(), *ptrs, 1, hw, hw, c, heads, hidden, shift,
                blob.numel(), stream)
    else:
        from studiosr_tpu_torch.ops.cuda.swin_block import _ARGS, packed_elements

        pack = packed_elements(c, heads, hidden)
        scratch = torch.empty(pack, dtype=dt, device=dev)
        ops = (ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2)
        entry, argtypes = "swin_block_bf16", _ARGS
        call = (x.data_ptr(), out.data_ptr(), 1, hw, hw, c, heads, hidden, shift, *[t.data_ptr() for t in ops],
                scratch.data_ptr(), pack, stream)
    for name, path in libs.items():
        fn = getattr(ctypes.CDLL(str(path)), entry)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int

        def launch():
            status = fn(*call)
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
