#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths at the full width of SwinIR classical x4
(embed 180, depths [6]x6, 6 heads, window 8) and holds every kernel of them
against its plain PyTorch version:

* serving: bf16, batch 1, 256x256 LR input, through ``swinir_fast_forward``
  (kernels B1-B3);
* training: ``Trainer.run`` at the JAX package's recipe, batch 32 of 64x64
  LR / 256x256 HR crops, bf16 compute over f32 master weights, Adam,
  drop_path_rate 0.1, ``fused_train`` on (kernels B5-B8, 36 launches each
  per step).

Phases, in order; any failure exits non-zero before the final line:

1. device: requires CUDA; prints nvidia-smi's name and power limit;
2. build: compiles ``studiosr_tpu_torch/csrc/*.cu`` (one nvcc per source,
   in parallel) and prints the seconds and ptxas register/spill lines;
3. serving kernels vs plain at the main path's shapes, f32 and bf16: B1
   (shift 0 and 4), B2 (plain, extra, lrelu0.01, residual), B3;
4. serving end to end: three seeded 256x256 uint8 requests through
   ``inference`` (bf16, fused) with launch counts checked per forward, and
   the fused forward against the plain port forward in f32 and bf16;
5. serving timing with CUDA events: the forward, each kernel, its plain
   version, B2's library call, and each kernel's bound from its shapes;
6. training kernels vs plain, batch 4 and the path's batch 32 of 64x64
   maps, f32 and bf16: B5 and B8 (shift 0 and 4), B6, B7, with drop-path
   scales that include a 0;
7. training gradients end to end, batch 4: loss and every parameter's
   gradient of the fused-train module, in f32 and in bf16 (bf16 copies of
   the weights, as the train step runs), against an f64 witness (plain
   autograd of the port's SwinIR in f64, same weights, batch and
   drop-path draws, every run on the witness's side of the L1 and
   LeakyReLU kinks), with plain autograd in f32 and bf16 as controls;
8. training: ``Trainer.run`` for 9 steps on a seeded in-memory uint8
   dataset (96x96 / 384x384 images, so the crops move), launch counts per
   step, finite losses, moved weights; ``latest`` saved at step 8 and
   resumed by a new Trainer, whose step 9 must match the first run's;
9. training timing: step ms and images/s over 5 steps after 2 warm-up
   steps, and each training kernel's ms, plain ms and bound at batch 32.

Prints the card line, a ``{"kernels": [...]}`` JSON line, and last
``{"ok": true, "device": {...}}``. Random weights come from a seeded
``torch.Generator``; nothing is downloaded.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

import studiosr_tpu_torch
from studiosr_tpu_torch import SwinIR, Trainer, resolve_device
from studiosr_tpu_torch.data import PairedImageDataset
from studiosr_tpu_torch.ops.cuda import _build, engagement
from studiosr_tpu_torch.ops.cuda.attn_bwd import attention_bwd, attention_bwd_plain
from studiosr_tpu_torch.ops.cuda.conv3x3 import conv3x3_plain, fused_conv3x3
from studiosr_tpu_torch.ops.cuda.mlp_block import fused_mlp_block, mlp_block_plain
from studiosr_tpu_torch.ops.cuda.mlp_bwd import mlp_bwd, mlp_bwd_plain
from studiosr_tpu_torch.ops.cuda.swin_block import fused_swin_block, swin_block_plain
from studiosr_tpu_torch.ops.cuda.upsampler import fused_upsample_x4, upsample_x4_plain
from studiosr_tpu_torch.ops.cuda.window_attention import fused_window_attention_block, window_attention_plain
from studiosr_tpu_torch.ops.windows import gather_rel_bias, relative_position_index
from studiosr_tpu_torch.parallel import build_optimizer, make_train_step, prepare_state
from studiosr_tpu_torch.serving.swinir_fast import prepare_serving
from studiosr_tpu_torch.utils import l1_loss

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

# Training: the JAX package's recipe (engine/trainer.py defaults,
# scripts/exp_train_step.py config #5): batch 32 of 64x64 LR crops, bf16
# over f32 masters, Adam 2e-4 (0.9, 0.99), L1, drop_path_rate 0.1.
TRAIN_MODEL = dict(MAIN, drop_path_rate=0.1)
TRAIN_BATCH, TRAIN_CROP, TRAIN_STEPS = 32, 64, 8
CHECK_BATCH = 4  # the f32 plain versions at the kernel checks and the gradient check
DATA_IMAGES, DATA_LR = 64, 96
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
KERNELS.update({
    "fused_window_attention_block": (
        "studiosr_tpu_torch/csrc/window_attention.cu", "studiosr_tpu/ops/pallas/swin_block.py:549"),
    "fused_mlp_block": ("studiosr_tpu_torch/csrc/mlp_block.cu", "studiosr_tpu/ops/pallas/swin_block.py:904"),
    "mlp_bwd": ("studiosr_tpu_torch/csrc/mlp_bwd.cu", "studiosr_tpu/ops/pallas/mlp_vjp.py:148"),
    "attention_bwd": ("studiosr_tpu_torch/csrc/attn_bwd.cu", "studiosr_tpu/ops/pallas/attn_bwd.py:209"),
})
PER_STEP = {"fused_window_attention_block": 36, "fused_mlp_block": 36, "mlp_bwd": 36, "attention_bwd": 36}
# End-to-end gradients, held against an f64 witness (plain autograd of the
# port's SwinIR in f64 on the same inputs, each kink on the witness's side:
# see train_grads), with plain autograd in f32 and in bf16 as controls.
# Relative L2 of the loss and of every parameter's gradient (and, in bf16,
# of all gradients together). f32: plain and fused autograd both read at
# most 1.7e-6 from the witness over seeds 0-3, so 1e-5 leaves 6x for sums
# in another order. bf16: both read at most 1.7e-2 on a parameter (a rel-pos
# bias table, a sum of cancelling terms over every window) and 9e-3 over
# all; a missing or wrong gradient reads near 1.
GRAD_RUNS = (("plain", torch.float64), ("plain", torch.float32), ("fused", torch.float32),
             ("plain", torch.bfloat16), ("fused", torch.bfloat16))
GRAD_F32_REL_L2, GRAD_BF16_REL_L2 = 1e-5, 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
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


# -- training phases --------------------------------------------------------------


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def train_kernel_cases(model: SwinIR, dev: torch.device, dtype: torch.dtype, batch: int):
    """(name, label, kernel fn, plain fn, operands) for B5-B8 at the training
    shapes (64x64 maps, C 180), with block 0's (shift 0) and block 1's (shift
    4) weights, drop-path scales (0, 1/0.9, ...) and a seeded cotangent."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    c, heads, ws = MAIN["embed_dim"], MAIN["num_heads"][0], MAIN["window_size"]

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    x = randn(batch, TRAIN_CROP, TRAIN_CROP, c)
    g = randn(batch, TRAIN_CROP, TRAIN_CROP, c, scale=1e-3)
    dp = torch.full((batch,), 1 / 0.9, device=dev)
    dp[0] = 0.0
    rows, rps = batch * TRAIN_CROP * TRAIN_CROP, TRAIN_CROP * TRAIN_CROP
    cases = []
    for shift in (0, ws // 2):
        blk = model.module.layers[0].residual_group.blocks[1 if shift else 0]
        a = blk.attn
        w = lambda t: t.detach().t().to(dtype).contiguous()  # noqa: E731
        f = lambda t: t.detach().float().contiguous()  # noqa: E731
        bias = gather_rel_bias(f(a.relative_position_bias_table), relative_position_index(ws), heads).contiguous()
        attn_ops = (f(blk.norm1.weight), f(blk.norm1.bias), w(a.qkv.weight), f(a.qkv.bias), w(a.proj.weight),
                    f(a.proj.bias), bias)
        kw = dict(heads=heads, window_size=ws, shift=shift, drop_path=dp)
        label = f"shift {shift}"
        cases.append(("fused_window_attention_block", label,
                      lambda *o, kw=kw: fused_window_attention_block(*o, **kw),
                      lambda *o, kw=kw: window_attention_plain(*o, **kw), (x, *attn_ops)))
        cases.append(("attention_bwd", label, lambda *o, kw=kw: attention_bwd(*o, **kw),
                      lambda *o, kw=kw: attention_bwd_plain(*o, **kw), (x, g, *attn_ops)))
        if shift:
            continue
        m = blk.mlp
        mlp_ops = (f(blk.norm2.weight), f(blk.norm2.bias), w(m.fc1.weight), f(m.fc1.bias), w(m.fc2.weight))
        kw = dict(drop_path=dp, rows_per_sample=rps)
        xr, gr = x.reshape(rows, c), g.reshape(rows, c)
        cases.append(("fused_mlp_block", "rows", lambda *o, kw=kw: fused_mlp_block(*o, **kw),
                      lambda *o, kw=kw: mlp_block_plain(*o, **kw), (xr, *mlp_ops, f(m.fc2.bias))))
        cases.append(("mlp_bwd", "rows", lambda *o, kw=kw: mlp_bwd(*o, **kw),
                      lambda *o, kw=kw: mlp_bwd_plain(*o, **kw), (xr, gr, *mlp_ops)))
    return cases


def phase_train_kernels(model: SwinIR, dev: torch.device) -> dict:
    """B5-B8 against their plain versions, f32 then bf16, every output (dx
    and each gradient) held to the serving kernels' rule: at batch 4 (256
    windows, one to each block of B8's per-window pass) and at the path's
    batch 32 (2048 windows, eight to each block, which sums their
    bias-gradient partials). Returns the bf16 max abs error of each
    kernel's first output at batch 32."""
    errors: dict = {}
    failed = []
    for batch in (CHECK_BATCH, TRAIN_BATCH):
        for dtype in (torch.float32, torch.bfloat16):
            for name, label, kernel, plain, ops in train_kernel_cases(model, dev, dtype, batch):
                got = _flat(kernel(*ops))
                torch.cuda.synchronize()
                want = _flat(plain(*[t.float() for t in ops]))
                torch.cuda.synchronize()
                for i, (k, p) in enumerate(zip(got, want)):
                    part = f"{name} [{label}] batch {batch} output {i}"
                    if not torch.isfinite(k.float()).all():
                        failed.append(f"{part}: non-finite")
                        continue
                    err = float((k.float() - p).abs().max())
                    if dtype == torch.float32:
                        limit = F32_RTOL * float(p.abs().max()) + F32_ATOL
                        ok = err <= limit
                        log(f"check {part} f32: max_abs_err {err:.3e} limit {limit:.3e}")
                    else:
                        rel = rel_l2(k, p)
                        ok = rel <= BF16_REL_L2
                        if i == 0 and batch == TRAIN_BATCH:
                            errors[name] = max(errors.get(name, 0.0), err)
                        log(f"check {part} bf16: rel_l2 {rel:.3e} limit {BF16_REL_L2:.0e} max_abs_err {err:.3e}")
                    if not ok:
                        failed.append(f"{part} {dtype}")
                if name in ("fused_window_attention_block", "attention_bwd") and not torch.equal(
                    got[0][0], (ops[0] if name == "fused_window_attention_block" else ops[1])[0]
                ):
                    failed.append(f"{name} [{label}] batch {batch} {dtype}: a dropped sample is not passed through")
                del got, want
    if failed:
        raise AssertionError("training kernels disagree with their plain versions: " + "; ".join(failed))
    return errors


def _unit_batch(dev: torch.device, batch: int, seed: int):
    rng = np.random.default_rng(seed)
    lq = rng.integers(0, 256, (batch, TRAIN_CROP, TRAIN_CROP, 3), dtype=np.uint8)
    gt = rng.integers(0, 256, (batch, 4 * TRAIN_CROP, 4 * TRAIN_CROP, 3), dtype=np.uint8)
    return torch.from_numpy(lq).to(dev), torch.from_numpy(gt).to(dev)


def train_grads(dev: torch.device, seed: int) -> dict:
    """Loss and every parameter's gradient of the port's SwinIR at batch 4,
    one run for each (path, dtype) of ``GRAD_RUNS``, with the same f32
    weights (from ``seed``), uint8 batch and drop-path draws. The weights
    and input are copied into the run's dtype (the bf16 policy of the train
    step) and the loss is taken in f32 (f64 for the witness).

    Every run takes the witness's side of the model's two kinks. The
    gradient of a piecewise-linear function jumps where a value crosses a
    kink, and a value within rounding noise of one crosses it in one run
    and not in another (about one in 10^6 values at f32), which moves a
    gradient as no kernel error does. So every run back-propagates the
    witness's L1 cotangent, sign(out - target) / n, and where a
    pre-activation of the LeakyReLU before the upsampler lies on the other
    side of 0 from the witness's, takes the witness's value there (with
    the run's own gradient through it). Both counts are returned.

    Returns {(path, dtype): (loss, {name: grad}, launches, (L1 signs,
    LeakyReLU sides) unlike the witness's)}."""
    model = SwinIR.build(**TRAIN_MODEL, seed=seed, device=dev)
    module = model.module.train()
    lq, gt = _unit_batch(dev, CHECK_BATCH, seed + 3)
    x, target = lq.float() / 255.0, gt.float() / 255.0
    named = list(module.named_parameters())
    runs, sign, kink = {}, None, {}

    def pin(_, __, y):  # forward hook on the conv before the LeakyReLU
        if "witness" not in kink:
            kink["witness"] = y.detach()
            return None
        w = kink["witness"]
        other = (y.detach() > 0) != (w > 0)
        kink["flipped"] = int(other.sum())
        return y + (torch.where(other, w.to(y.dtype), y) - y).detach()

    handle = module.conv_before_upsample[0].register_forward_hook(pin)
    try:
        for path, dtype in GRAD_RUNS:
            module.fused_train = path == "fused"
            acc = torch.float64 if dtype == torch.float64 else torch.float32
            leaves = {k: p.detach().to(dtype).requires_grad_() for k, p in named}
            engagement.reset()
            kink["flipped"] = 0
            out = functional_call(module, leaves, (x.to(dtype),),
                                  {"generator": torch.Generator().manual_seed(seed + 11)})
            diff = out.to(acc) - target.to(acc)
            if sign is None:
                sign = torch.sign(diff.detach())  # the witness runs first
            flipped = (int((torch.sign(diff.detach()) != sign).sum()), kink["flipped"])
            grads = torch.autograd.grad((diff * sign.to(acc)).mean(), list(leaves.values()))
            torch.cuda.synchronize()
            runs[(path, dtype)] = (float(diff.detach().abs().mean()), dict(zip(leaves, grads)),
                                   engagement.counters(), flipped)
            del out, diff, grads, leaves
    finally:
        handle.remove()
        module.fused_train = False
    return runs


def grad_report(runs: dict, seed: int) -> dict:
    """Every run's loss and gradients against the f64 witness, logged.
    Returns {(path, dtype): {"loss": rel, "all": rel_l2, "params": {name: rel_l2}}}
    plus the fused f32 run against the plain f32 run under ("fused-vs-plain", f32)."""
    ref_loss, ref, _, _ = runs[("plain", torch.float64)]
    names = list(ref)
    ref_all = torch.cat([ref[k].flatten() for k in names])

    def compare(loss, grads, ref_loss, ref, ref_all):
        return {
            "loss": abs(loss - ref_loss) / abs(ref_loss),
            "all": rel_l2(torch.cat([grads[k].flatten() for k in names]), ref_all),
            "params": {k: rel_l2(grads[k], ref[k]) for k in names},
        }

    report = {}
    for key, (loss, grads, _, flipped) in runs.items():
        if key[1] != torch.float64:
            report[key] = dict(compare(loss, grads, ref_loss, ref, ref_all), flipped=flipped)
    plain32 = runs[("plain", torch.float32)]
    report[("fused-vs-plain", torch.float32)] = dict(compare(
        runs[("fused", torch.float32)][0], runs[("fused", torch.float32)][1], plain32[0], plain32[1],
        torch.cat([plain32[1][k].flatten() for k in names])), flipped=None)
    for (path, dtype), r in report.items():
        params = sorted(((v, k) for k, v in r["params"].items()), reverse=True)
        tables = [v for v, k in params if k.endswith("bias_table")]
        others = [(v, k) for v, k in params if not k.endswith("bias_table")]
        against = "plain f32" if path == "fused-vs-plain" else "f64 plain"
        flips = "" if r["flipped"] is None else (
            f"; kinks on the other side from the witness: L1 {r['flipped'][0]}, LeakyReLU {r['flipped'][1]}")
        log(f"grads seed {seed} {path} {str(dtype)[6:]} vs {against}, batch {CHECK_BATCH}: loss rel {r['loss']:.3e}"
            f"{flips}; all gradients rel_l2 {r['all']:.3e}; per parameter median {params[len(params) // 2][0]:.3e}, "
            f"worst {params[0][0]:.3e} ({params[0][1]}); bias tables median {float(np.median(tables)):.3e} "
            f"worst {max(tables):.3e}; others worst {others[0][0]:.3e} ({others[0][1]})")
    return report


def phase_train_grads(dev: torch.device) -> None:
    """The fused-train module's loss and gradients, f32 and bf16, and the
    plain f32 and bf16 controls, against an f64 witness: plain autograd of
    the port's SwinIR in f64 on the same weights, batch and drop-path draws."""
    runs = train_grads(dev, SEED)
    report = grad_report(runs, SEED)
    failed = []
    for (path, dtype), (_, grads, launches, _) in runs.items():
        expected = PER_STEP if path == "fused" else {}
        if any(launches.get(k, 0) != expected.get(k, 0) for k in set(launches) | set(expected)):
            failed.append(f"{path} {dtype}: launches {launches}, expected {expected}")
        if not all(torch.isfinite(g).all() for g in grads.values()):
            failed.append(f"{path} {dtype}: non-finite gradients")
    f32, bf16 = report[("fused", torch.float32)], report[("fused", torch.bfloat16)]
    worst32 = max(f32["params"].values())
    worst16 = max(bf16["params"].values())
    log(f"grads held: fused f32 loss rel {f32['loss']:.3e} and each parameter (worst {worst32:.3e}) <= "
        f"{GRAD_F32_REL_L2:.0e}; fused bf16 loss rel {bf16['loss']:.3e}, all gradients {bf16['all']:.3e} and "
        f"each parameter (worst {worst16:.3e}) <= {GRAD_BF16_REL_L2:.0e}")
    if f32["loss"] > GRAD_F32_REL_L2 or worst32 > GRAD_F32_REL_L2:
        failed.append("f32 fused gradients disagree with the f64 witness")
    if max(bf16["loss"], bf16["all"], worst16) > GRAD_BF16_REL_L2:
        failed.append("bf16 fused gradients disagree with the f64 witness")
    if failed:
        raise AssertionError("; ".join(failed))


class MemoryPairs(PairedImageDataset):
    """Seeded in-memory uint8 pairs (DATA_LR^2 LR, 4x HR) through the
    standard crop / flip / rot90 pipeline; the card's machine has no cv2."""

    def __init__(self, seed: int) -> None:
        rng = np.random.default_rng(seed)
        lr, scale = DATA_LR, MAIN["scale"]
        self.pairs = [
            (rng.integers(0, 256, (lr, lr, 3), dtype=np.uint8),
             rng.integers(0, 256, (lr * scale, lr * scale, 3), dtype=np.uint8))
            for _ in range(DATA_IMAGES)
        ]
        self.files = [str(i) for i in range(DATA_IMAGES)]
        self._init_pipeline(TRAIN_CROP, scale, True, False)

    def get_image_pair(self, idx: int):
        return self.pairs[idx]


def _trainer(dev: torch.device, seed: int, losses: list) -> Trainer:
    def criterion(pred, target):
        loss = l1_loss(pred, target)
        losses.append(loss.detach())
        return loss

    model = SwinIR.build(**TRAIN_MODEL, seed=seed, device=dev)
    return Trainer(model, MemoryPairs(SEED), batch_size=TRAIN_BATCH, num_workers=4, max_iters=TRAIN_STEPS + 1,
                   eval_interval=TRAIN_STEPS, ckpt_path=str(TRAIN_DIR), seed=SEED, log_interval=100,
                   loss_function=criterion)


def phase_train(dev: torch.device):
    """Trainer.run for 9 steps (``latest`` saved at step 8), then a new
    Trainer over other weights resumes from ``latest`` and takes step 9."""
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    # cuDNN may pick convolution backward algorithms that sum in another
    # order from run to run; the resume check compares two runs bit for bit
    torch.backends.cudnn.deterministic = True
    losses: list = []
    trainer = _trainer(dev, SEED, losses)
    before = {k: p.detach().clone() for k, p in trainer.model.module.named_parameters()}
    engagement.reset()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = engagement.counters()
    steps = TRAIN_STEPS + 1
    values = [float(v) for v in losses]
    log(f"\ntrained {steps} steps in {seconds:.3f} s (host clock, first steps included); bf16 {trainer.bfloat16}, "
        f"fused_train {trainer.fused_train}; launches {launches}")
    log(f"losses {[round(v, 6) for v in values]}")
    failed = []
    if not (trainer.bfloat16 and trainer.fused_train):
        failed.append("the trainer did not default to bf16 and fused_train on the card")
    for name, per in PER_STEP.items():
        if launches.get(name, 0) != per * steps:
            failed.append(f"{name}: {launches.get(name, 0)} launches in {steps} steps, expected {per} per step")
    if len(values) != steps or not all(np.isfinite(values)):
        failed.append(f"losses {values}")
    moved = sum(not torch.equal(p.detach(), before[k]) for k, p in trainer.model.module.named_parameters())
    if moved != len(before):
        failed.append(f"only {moved} of {len(before)} parameters changed")

    resumed_losses: list = []
    resumed = _trainer(dev, SEED + 1, resumed_losses)
    resumed.run()
    torch.cuda.synchronize()
    a = torch.cat([p.detach().flatten() for p in trainer.model.module.parameters()])
    b = torch.cat([p.detach().flatten() for p in resumed.model.module.parameters()])
    exact = torch.equal(a, b)
    rel = float(torch.linalg.vector_norm(b - a) / torch.linalg.vector_norm(a))
    resumed_value = float(resumed_losses[0]) if resumed_losses else float("nan")
    log(f"resume: step {steps} loss {resumed_value:.6f} vs {values[-1]:.6f} without the restart; weights "
        f"{'bitwise equal' if exact else f'rel_l2 {rel:.3e}'} (limit 1e-6); iteration {resumed.data_handler.iterations}")
    if len(resumed_losses) != 1 or abs(resumed_value - values[-1]) > 1e-6 * abs(values[-1]) or rel > 1e-6:
        failed.append("the resumed step does not match the step taken without the restart")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    torch.backends.cudnn.deterministic = False
    if failed:
        raise AssertionError("; ".join(failed))
    return trainer.model, launches, steps


def train_bounds(name: str, ops) -> tuple:
    """(flops, bytes) of one launch from its operands: each input read once,
    each output written once."""
    x = ops[0]
    c = x.shape[-1]
    tokens = x.numel() // c
    if name == "fused_window_attention_block":
        flops = 2 * tokens * c * 4 * c + 4 * tokens * 64 * c
        moved = 2 * nbytes(x) + nbytes(*ops[1:])
    elif name == "attention_bwd":
        flops = 3 * 2 * tokens * c * 3 * c + 2 * 2 * tokens * c * c + 12 * tokens * 64 * c
        moved = 3 * nbytes(x) + nbytes(*ops[2:]) + 4 * sum(t.numel() for t in ops[2:])  # + f32 gradients
    elif name == "fused_mlp_block":
        flops = 4 * tokens * c * ops[3].shape[-1]
        moved = 2 * nbytes(x) + nbytes(*ops[1:])
    else:
        flops = 10 * tokens * c * ops[4].shape[-1]
        moved = 3 * nbytes(x) + nbytes(*ops[2:]) + 4 * sum(t.numel() for t in ops[2:])  # + f32 gradients
    return flops, moved


def phase_train_timing(model: SwinIR, dev: torch.device, errors: dict, launches: dict, steps: int) -> list:
    module = model.module
    module.fused_train = True
    tx = build_optimizer()
    state = prepare_state(module, tx)
    step = make_train_step(module, tx, l1_loss, bfloat16=True)
    lq, gt = _unit_batch(dev, TRAIN_BATCH, SEED + 4)
    gen = torch.Generator().manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(state, lq, gt, gen), iters=5)
    module.fused_train = False
    log(f"train step bf16 batch {TRAIN_BATCH} {TRAIN_CROP}x{TRAIN_CROP}: {step_ms:.3f} ms, "
        f"{TRAIN_BATCH / (step_ms / 1e3):.1f} images/s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    rows, kernel_total = [], 0.0
    for name, label, kernel, plain, ops in train_kernel_cases(model, dev, torch.bfloat16, TRAIN_BATCH):
        if label == "shift 0" and name != "fused_mlp_block" and name != "mlp_bwd":
            continue  # the attention kernels are timed at shift 4; the shift costs nothing extra
        ms = time_ms(lambda: kernel(*ops), iters=10)
        plain_ms = time_ms(lambda: plain(*ops), iters=3, warmup=1)
        flops, moved = train_bounds(name, ops)
        bms, by = bound_ms(flops, moved)
        kernel_total += PER_STEP[name] * ms
        source, replaces = KERNELS[name]
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches.get(name, 0),
                         max_abs_err=errors[name], ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=None))
        log(f"time {name} [{label}] bf16 batch {TRAIN_BATCH}: {ms:.3f} ms ({100 * PER_STEP[name] * ms / step_ms:.1f} % "
            f"of a step at {PER_STEP[name]} a step), plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), "
            f"{flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB; launches {launches.get(name, 0)} in {steps} steps")
    log(f"train step: kernels {kernel_total:.1f} ms, the rest (convs, LayerNorms, tail, optimizer, gaps) "
        f"{step_ms - kernel_total:.1f} ms")
    return rows


def main() -> int:
    dev = phase_device()
    phase_build()
    model = SwinIR.build(**MAIN, seed=SEED, device=dev)
    log(f"model: SwinIR x4 embed {MAIN['embed_dim']} depths {MAIN['depths']}, {model.count_parameters()} parameters")
    errors = phase_kernels(model, dev)
    launches = phase_end_to_end(model, dev)
    rows = phase_timing(model, dev, errors, launches)
    del model
    train_errors = phase_train_kernels(SwinIR.build(**TRAIN_MODEL, seed=SEED, device=dev), dev)
    phase_train_grads(dev)
    trained, train_launches, steps = phase_train(dev)
    rows += phase_train_timing(trained, dev, train_errors, train_launches, steps)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
