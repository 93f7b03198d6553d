#!/usr/bin/env python3
"""What bounds B3 and B4 in bf16: time ablated copies of their kernels.

    python3 scripts/torch_ablate_upsampler.py

Each variant is the checkout's ``csrc/upsampler.cu`` (with its headers)
after one substitution (listed below), built by nvcc with the port's flags
into ``build/ablate/upsampler/<variant>/`` (all at once) and launched
through the port's own wrappers on weights packed as serving packs them.
Times are CUDA events over 20 launches after 3 warm-up launches, in bf16 at
SwinIR serving's 264 x 264 x 64 tail input: B3 (``fused_upsample_x4``), B4
x2 and x3 (``fused_upsample_s``), and B3's three passes (conv0, conv1,
conv_last) by ``torch.profiler`` over 10 calls. Variants that drop work
compute wrong values and only bound the time of what remains; the others
are checked against the plain version (relative L2). Prints one JSON line:
{"card": nvidia-smi's name and power limit, "ms": {variant: {tail: ms}},
"passes": {variant: [[kernel, ms], ...]}, "rel_l2": {variant: error}}.
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
from studiosr_tpu_torch.ops.cuda import upsampler as up  # noqa: E402
from torch_time_conv_kernels import pass_split, time_ms  # noqa: E402

OUT = _build.BUILD_DIR.parent / "ablate" / "upsampler"
STAGE_COPY = ("      for (int i = tid; i < UP_STAGE_BYTES<NC> / 16; i += UP_THREADS) "
              "hm_cp_async<16>(dst + 16 * i, src + 16 * i, true);")
PATCH_COPY = ("    hm_cp_async<16>(patch + cg * plane + px * 16, "
              "ok ? xb + ((size_t)gy * W + gx) * Cin + 8 * cg : a.x, ok);")
COPY_OUT = "          if (gy < H && gx < W && co < Cout) {"
LAST_BLOCKS = "constexpr int UL_MIN_BLOCKS = 2;"
MT = "constexpr int UP_MT = 1;"
# (variant, file, [(text, replacement)]): each text must occur in the file
VARIANTS = [
    ("full", "upsampler.cu", []),
    # not removals: a 16 x 16 pixel tile (128 accumulators a thread), one block an SM; a 3-slot ring;
    # conv_last at three blocks an SM
    ("16 x 16 tile, one block an SM", "upsampler.cu", [(MT, "constexpr int UP_MT = 2;")]),
    ("3-slot ring", "upsampler.cu", [("constexpr int UP_STAGES = 4;", "constexpr int UP_STAGES = 3;")]),
    ("conv_last three blocks an SM", "upsampler.cu", [(LAST_BLOCKS, "constexpr int UL_MIN_BLOCKS = 3;")]),
    # every wgmma instruction commented out of its PTX (operands, fences and waits stay)
    ("no wgmma products", "wgmma.cuh", [('"wgmma.mma_async.sync.aligned.', '"// wgmma.mma_async.sync.aligned.')]),
    ("no weight copies (the ring's slots never filled)", "upsampler.cu", [(STAGE_COPY, "")]),
    ("no patch copies", "upsampler.cu", [(PATCH_COPY, "")]),
    # the epilogue's bias and staging stay; its copy-out to device memory goes
    ("no copy-out of the conv epilogues", "upsampler.cu", [(COPY_OUT, "          if (gy < H && gx < W && co < 0) {")]),
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
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "upsampler.cu")]
        jobs.append((name, d, subprocess.Popen(cmd, stdout=open(d / "log.txt", "w"), stderr=subprocess.STDOUT)))
    libs = {}
    for name, d, proc in jobs:
        if proc.wait() != 0:
            raise SystemExit(f"{name}: nvcc failed\n{(d / 'log.txt').read_text()[-3000:]}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn, args in up._SIGNATURES.items():
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    dev = resolve_device("cuda")
    libs = build_all()
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def conv_w(cin, cout):
        return [randn(3, 3, cin, cout, scale=(9 * cin) ** -0.5).to(bf), randn(cout, scale=0.1)]

    x = randn(1, 264, 264, 64).to(bf)
    tail = conv_w(64, 256) + conv_w(64, 256) + conv_w(64, 3)
    tail_s = {s: conv_w(64, s * s * 64) + conv_w(64, 3) for s in (2, 3)}
    want = up.upsample_x4_plain(x.float(), *tail)
    tail, tail_s = up.pack_tail(tail, 4), {s: up.pack_tail(t, s) for s, t in tail_s.items()}
    ms, passes, errors = {}, {}, {}
    load = _build.load
    try:
        for name, lib in libs.items():
            _build.load = lambda *_, lib=lib: lib
            got = up.fused_upsample_x4(x, *tail)
            errors[name] = float((got.float() - want).norm() / want.norm())
            ms[name] = {"x4": time_ms(lambda: up.fused_upsample_x4(x, *tail)),
                        **{f"x{s}": time_ms(lambda s=s: up.fused_upsample_s(x, *tail_s[s], s)) for s in (2, 3)}}
            passes[name] = pass_split(lambda: up.fused_upsample_x4(x, *tail))
            print(name, json.dumps(ms[name]), json.dumps(passes[name]), f"rel_l2 {errors[name]:.3e}", flush=True)
    finally:
        _build.load = load
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "ms": ms, "passes": passes, "rel_l2": errors}))


if __name__ == "__main__":
    main()
