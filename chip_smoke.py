#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path -- SwinIR classical x4 at full width (embed 180,
depths [6]x6, 6 heads, window 8), bf16, batch 1, 256x256 LR input, served
through ``swinir_fast_forward`` -- and holds every kernel of that path
against its plain PyTorch version. Phases, in order; any failure exits
non-zero before the final line:

1. device: requires CUDA; prints nvidia-smi's name and power limit;
2. build: compiles ``studiosr_tpu_torch/csrc/*.cu`` (one nvcc per source,
   in parallel) and prints the seconds and ptxas register/spill lines;
3. kernels vs plain at the main path's shapes, f32 and bf16: B1 (shift 0
   and 4), B2 (plain, extra, lrelu0.01, residual), B3;
4. end to end: three seeded 256x256 uint8 requests through ``inference``
   (bf16, fused) with launch counts checked per forward, and the fused
   forward against the plain port forward in f32 and bf16;
5. timing with CUDA events: the forward, each kernel, its plain version,
   B2's library call, and each kernel's bound from its shapes.

Prints the card line, a ``{"kernels": [...]}`` JSON line, and last
``{"ok": true, "device": {...}}``. Random weights come from a seeded
``torch.Generator``; nothing is downloaded.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import studiosr_tpu_torch
from studiosr_tpu_torch import SwinIR, resolve_device
from studiosr_tpu_torch.ops.cuda import _build, engagement
from studiosr_tpu_torch.ops.cuda.conv3x3 import conv3x3_plain, fused_conv3x3
from studiosr_tpu_torch.ops.cuda.swin_block import fused_swin_block, swin_block_plain
from studiosr_tpu_torch.ops.cuda.upsampler import fused_upsample_x4, upsample_x4_plain
from studiosr_tpu_torch.serving.swinir_fast import prepare_serving

MAIN = dict(scale=4, embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=8, mlp_ratio=2.0)
LR = 256
SEED = 0
REQUESTS = 3
# H100 SXM dense bf16 tensor-core rate and HBM3 bandwidth (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# f32: max|k - p| <= F32_RTOL * max|p| + F32_ATOL (TF32 off on both sides).
F32_RTOL, F32_ATOL = 1e-4, 1e-5
# bf16: relative L2 against the plain version in f32 on the same bf16 inputs.
BF16_REL_L2 = 1e-2
E2E_F32_REL_L2, E2E_BF16_REL_L2 = 1e-4, 2e-2

KERNELS = {
    "fused_swin_block": ("studiosr_tpu_torch/csrc/swin_block.cu", "studiosr_tpu/ops/pallas/swin_block.py:691"),
    "fused_conv3x3": ("studiosr_tpu_torch/csrc/conv3x3.cu", "studiosr_tpu/ops/pallas/conv3x3.py:212"),
    "fused_upsample_x4": ("studiosr_tpu_torch/csrc/upsampler.cu", "studiosr_tpu/ops/pallas/upsampler.py:274"),
}
PER_FORWARD = {"fused_swin_block": 36, "fused_conv3x3": 7, "fused_upsample_x4": 1}


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
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


def bound_ms(flops: float, nbytes: float):
    """(least time in ms, what bounds it) at the bf16 tensor-core and HBM peaks."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# -- phases --------------------------------------------------------------------


def phase_device() -> torch.device:
    if Path(studiosr_tpu_torch.__file__).resolve().parents[1] != Path(__file__).resolve().parent:
        raise SystemExit("chip_smoke: studiosr_tpu_torch must be the package of this checkout")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card")
    dev = resolve_device("cuda")  # also turns TF32 off
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    return dev


def phase_build() -> None:
    seconds = _build.build()
    log(f"build: {seconds:.1f} s for {', '.join(_build.SOURCES)}")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def kernel_cases(model: SwinIR, dev: torch.device, dtype: torch.dtype):
    """(name, label, kernel fn, plain fn, operands) at the main path's shapes,
    with this model's weights laid out for ``dtype``."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    hp = LR + MAIN["window_size"]  # the flip-padded map
    c = MAIN["embed_dim"]
    heads = MAIN["num_heads"][0]
    ws = MAIN["window_size"]

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    prep = prepare_serving(model.module, model.config, dtype)
    x = randn(1, hp, hp, c)
    skip = randn(1, hp, hp, c)
    x64 = randn(1, hp, hp, 64)
    cases = []
    for shift in (0, ws // 2):
        ops = dict(prep["blocks"][0][1 if shift else 0])
        kw = dict(heads=heads, window_size=ws, shift=shift)
        cases.append(
            ("fused_swin_block", f"shift {shift}", lambda *a, kw=kw: fused_swin_block(*a, **kw),
             lambda *a, kw=kw: swin_block_plain(*a, **kw), (x, *ops.values()))
        )
    w, b = prep["convs"][0]
    for label, kw, extra in (
        ("plain", {}, None),
        ("extra", {}, skip),
        ("lrelu0.01", {"activation": "lrelu0.01"}, None),
        ("residual", {"residual": True}, None),
    ):
        cases.append(
            ("fused_conv3x3", label, lambda x_, w_, b_, e_, kw=kw: fused_conv3x3(x_, w_, b_, extra=e_, **kw),
             lambda x_, w_, b_, e_, kw=kw: conv3x3_plain(x_, w_, b_, extra=e_, **kw), (x, w, b, extra))
        )
    cases.append(("fused_upsample_x4", "x4", fused_upsample_x4, upsample_x4_plain, (x64, *prep["tail"])))
    return cases


def phase_kernels(model: SwinIR, dev: torch.device) -> dict:
    """Every kernel against its plain version, f32 then bf16. Returns the
    bf16 max abs error per kernel (the main path's dtype)."""
    errors: dict = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, label, kernel, plain, ops in kernel_cases(model, dev, dtype):
            got = kernel(*ops)
            torch.cuda.synchronize()
            want = plain(*[None if t is None else t.float() for t in ops])
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"{name} [{label}] {dtype}: non-finite output")
            err = float((got.float() - want).abs().max())
            if dtype == torch.float32:
                limit = F32_RTOL * float(want.abs().max()) + F32_ATOL
                ok = err <= limit
                log(f"check {name} [{label}] f32: max_abs_err {err:.3e} limit {limit:.3e}")
            else:
                rel = rel_l2(got, want)
                ok = rel <= BF16_REL_L2
                errors[name] = max(errors.get(name, 0.0), err)
                log(f"check {name} [{label}] bf16: rel_l2 {rel:.3e} limit {BF16_REL_L2:.0e} max_abs_err {err:.3e}")
            if not ok:
                raise AssertionError(f"{name} [{label}] {dtype} disagrees with its plain version")
    return errors


def requests():
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, 256, (LR, LR, 3), dtype=np.uint8) for _ in range(REQUESTS)]


def phase_end_to_end(model: SwinIR, dev: torch.device) -> dict:
    """Fused vs plain forward (f32, then bf16), then the served requests."""
    images = requests()
    x = torch.from_numpy(images[0]).to(dev).float()[None] / 255.0
    plain = model.enable_fused(False)(x)
    fused = model.enable_fused(True)(x)
    torch.cuda.synchronize()
    rel32 = rel_l2(fused, plain)
    log(f"e2e f32 fused vs plain: rel_l2 {rel32:.3e} limit {E2E_F32_REL_L2:.0e}")
    if not rel32 <= E2E_F32_REL_L2:
        raise AssertionError("f32 fused forward disagrees with the plain forward")

    model.half()
    fused16 = model(x)
    torch.cuda.synchronize()
    rel16 = rel_l2(fused16, plain)
    log(f"e2e bf16 fused vs f32 plain: rel_l2 {rel16:.3e} limit {E2E_BF16_REL_L2:.0e}")
    if not rel16 <= E2E_BF16_REL_L2:
        raise AssertionError("bf16 fused forward disagrees with the plain forward")

    model.serving_prep()  # load-time weight layout, outside the counted run
    engagement.reset()
    t0 = time.perf_counter()
    outs = [model.inference(im) for im in images]
    seconds = time.perf_counter() - t0
    launches = engagement.counters()
    log(f"served {len(outs)} requests in {seconds:.3f} s (host clock); launches {launches}")
    for out in outs:
        if out.shape != (4 * LR, 4 * LR, 3) or out.dtype != np.uint8:
            raise AssertionError(f"bad output {out.shape} {out.dtype}")
    if not all(np.isfinite(fused16.cpu().numpy()).ravel()):
        raise AssertionError("non-finite bf16 forward")
    for name, per in PER_FORWARD.items():
        if launches.get(name, 0) != per * REQUESTS:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches, expected {per} per forward")
    return launches


def phase_timing(model: SwinIR, dev: torch.device, errors: dict, launches: dict) -> list:
    x = torch.from_numpy(requests()[0]).to(dev).float()[None] / 255.0
    fwd = time_ms(lambda: model(x), iters=5)
    log(f"forward bf16 batch 1 {LR}x{LR}: {fwd:.3f} ms, {LR * LR / 1e6 / (fwd / 1e3):.3f} LR MP/s")

    rows = []
    for name, label, kernel, plain, ops in kernel_cases(model, dev, torch.bfloat16):
        if label not in ("shift 4", "extra", "x4"):  # the variant each kernel runs most on the path
            continue
        ms = time_ms(lambda: kernel(*ops), iters=10)
        plain_ms = time_ms(lambda: plain(*ops), iters=10)
        library_ms = None
        x_ = ops[0]
        if name == "fused_swin_block":
            c = x_.shape[-1]
            hidden = ops[10].shape[-1]
            tokens = x_.numel() // c
            flops = 2 * tokens * c * (3 * c + c + 2 * hidden) + 4 * tokens * 64 * c
            moved = 2 * nbytes(x_) + nbytes(*ops[1:])
        elif name == "fused_conv3x3":
            w, b, extra = ops[1], ops[2], ops[3]
            flops = 2 * (x_.numel() // x_.shape[-1]) * 9 * w.shape[2] * w.shape[3]
            moved = nbytes(x_, w, b, extra) + x_.numel() // x_.shape[-1] * w.shape[3] * x_.element_size()
            w_oihw, b_lib = w.permute(3, 2, 0, 1).contiguous(), b.to(x_.dtype)
            library_ms = time_ms(
                lambda: F.conv2d(x_.permute(0, 3, 1, 2), w_oihw, b_lib, padding=1).permute(0, 2, 3, 1) + extra,
                iters=10,
            )
        else:
            pix = x_.numel() // x_.shape[-1]
            cin = x_.shape[-1]
            n_colors = ops[5].shape[-1]
            flops = 2 * 9 * cin * (pix * 4 * cin + 4 * pix * 4 * cin + 16 * pix * n_colors)
            moved = nbytes(*ops) + 16 * pix * n_colors * x_.element_size()
        bms, by = bound_ms(flops, moved)
        source, replaces = KERNELS[name]
        rows.append(
            dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches.get(name, 0),
                 max_abs_err=errors[name], ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                 library_ms=library_ms)
        )
        log(f"time {name} [{label}] bf16: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), "
            f"library {library_ms if library_ms is None else round(library_ms, 4)} ms, {flops / 1e9:.2f} GFLOP, "
            f"{moved / 1e6:.1f} MB")
    return rows


def main() -> int:
    dev = phase_device()
    phase_build()
    model = SwinIR.build(**MAIN, seed=SEED, device=dev)
    log(f"model: SwinIR x4 embed {MAIN['embed_dim']} depths {MAIN['depths']}, {model.count_parameters()} parameters")
    errors = phase_kernels(model, dev)
    launches = phase_end_to_end(model, dev)
    rows = phase_timing(model, dev, errors, launches)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
