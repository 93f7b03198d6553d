#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at full width and holds every kernel of them
against its plain PyTorch version:

* SwinIR classical x4 serving (embed 180, depths [6]x6, 6 heads, window 8):
  bf16, batch 1, 256x256 LR input, through ``swinir_fast_forward`` (kernels
  B1-B3);
* SwinIR training: ``Trainer.run`` at the JAX package's recipe, batch 32 of
  64x64 LR / 256x256 HR crops, bf16 compute over f32 master weights, Adam,
  drop_path_rate 0.1, ``fused_train`` on (kernels B5-B8, 36 launches each
  per step);
* HAT x4 serving at XPixelGroup/HAT ``options/test/HAT_SRx4.yml`` (embed
  180, depths [6]x6, 6 heads, window 16, overlap 0.5): bf16, batch 1,
  256x256 LR input, through ``hat_fast_forward`` (kernels B11, B5 at window
  16, B6 with the CAB join, B10, and B2, B3);
* HAT x4 training: ``Trainer.run`` at the same widths and the JAX package's
  recipe (``models/hat.py`` ``_TRAINING_CONFIG``), batch 32 of 64x64 LR
  crops, bf16 over f32 master weights, drop_path_rate 0.1, ``fused_train``
  on (B5 at window 16, B9, B6, B7: 36 launches each a step; B12, B13: 6);
* x2 / x3 serving of both, the x2 / x3 tail through B4: SwinIR at
  JingyunLiang/SwinIR ``001_classicalSR_DF2K_s64w8_SwinIR-M_x2`` / ``_x3``
  and HAT at ``options/test/HAT_SRx2.yml`` / ``HAT_SRx3.yml``, bf16, batch 1,
  256x256 LR input;
* SwinFIR x4 at the JAX package's ``build`` defaults (the reference
  ``swinfir.py:83-98`` geometry, SwinIR classical's widths): serving bf16,
  batch 1, 256x256 LR input (B1, B14 for the SFBs' spatial branches, B3),
  and training at its own recipe (batch 32 of 64x64 crops, f32, Adam 2e-4,
  L1; B5-B8 for the Swin blocks, the SFBs in plain autograd);
* MaxSR x4 at the JAX package's ``build`` defaults (adaptive, dim 128, 4
  heads of 32, depth [4]x4) and in its static mode at the same widths:
  serving bf16, batch 1, 256x256 LR input, the 32 attention cores of a
  forward through B15;
* the user's entry points: the nine trained checkpoints of
  ``tests/fixtures/quality`` read by ``load_model`` (no JAX, no flax) with
  the fixture PNGs read by the port's codec, the ``Evaluator2`` on the host
  and on the card, and the CLI (``python3 -m studiosr_tpu_torch``).

Phases, in order; any failure exits non-zero before the final line:

1. device: requires CUDA; prints nvidia-smi's name and power limit;
2. build: compiles ``studiosr_tpu_torch/csrc/*.cu`` (one nvcc per source,
   in parallel) and prints the seconds and ptxas register/spill lines;
3. serving kernels vs plain at the main path's shapes, f32 and bf16: B1
   (shift 0 and 4), B2 (plain, extra, lrelu0.01, residual), B3; then B1 in
   bf16 at the card tests' odd geometries (C 32 / d 16, C 180 at H != W and
   an odd window count, d 8, 10, 12), and bit for bit: B1 on the blob packed
   at load time against B1 on dense weights, B14 on packed weights against
   B14 on HWIO; B3 at HAT's 256 x 256 x 64 and a ragged (2, 37, 53, 64),
   f32 and bf16, each launch through its entry; bit for bit, B3 and B4 x2 /
   x3 on the weights packed at load time against HWIO;
4. serving end to end: three seeded 256x256 uint8 requests through
   ``inference`` (bf16, fused) with launch counts checked per forward (and
   every B1, B2 and B3 launch through the bf16 kernel written for the H100,
   here and in every served path that runs B1, B2, B3, B4, B14 or B15), and
   the fused forward against the plain port forward in f32 and bf16;
5. serving timing with CUDA events: the forward, each kernel, its plain
   version, B2's library call, and each kernel's bound from its shapes; for
   B1 the same block as a sequence of bf16 PyTorch calls (no one call
   computes it), and for B3 the same tail as a sequence of bf16 PyTorch
   calls (three channels-last ``F.conv2d``, two ``F.pixel_shuffle``); for
   B1, B2, B3 (B14 in phase 20, B15 in phase 22) kernel / library, the
   share of the bound and ``-Xptxas -v``'s registers, static shared memory
   and spills;
6. training kernels vs plain, batch 4 and the path's batch 32 of 64x64
   maps, f32 and bf16: B5 and B8 (shift 0 and 4), B6 (also on a ragged row
   count), B7, with drop-path scales that include a 0, each launch through
   its dtype's C entry, B6 launched twice for the same bits;
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
   steps, and each training kernel's ms, plain ms and bound at batch 32;
10. HAT serving kernels vs plain at the path's shapes (256x256 map, C
    180), f32 and bf16: B11, B5 at window 16 (shift 0 and 8), B6 with
    ``extra`` / ``extra_scale`` (twice, for the same bits), B10 (its border
    windows' keys reach outside the image);
11. HAT serving end to end: the fused forward against the plain port
    forward in f32 and bf16, then three seeded 256x256 uint8 requests
    through ``inference`` (bf16, fused) with launch counts checked per
    forward;
12. HAT serving timing: the forward (ms, LR MP/s), each HAT kernel's ms,
    plain ms and bound, and B2 and B3 at HAT's shapes;
13. HAT training kernels vs plain at batch 4 and the path's batch 32 of
    64x64 maps, f32 and bf16: B5 at window 16 with drop-path and B9 (shift
    0 and 8, drop-path scales that include a 0), B12 and B13 on the OCAB's
    transposed views at its geometry (256 queries, 576 keys, d 30), on 37
    windows and at the trained fixtures' (64, 144, d 16), with logits large
    enough that the row max matters, B13 launched twice for the same bits;
14. HAT gradients end to end, batch 4, as phase 7: the fused-train HAT's
    loss and every gradient in f32 and bf16 against an f64 witness (plain
    autograd of the port's HAT in f64), every ReLU (the squeeze-excite
    gates) and LeakyReLU kink on the witness's side; a bf16 parameter
    within 5e-2 or twice the plain bf16 control's error (GRAD_BF16_CONTROL);
15. HAT training: ``Trainer.run`` for 3 steps on the seeded in-memory
    dataset, launch counts per step (B5 at window 16, B9, B6, B7 36; B12,
    B13 6; nothing else), finite losses, moved weights;
16. HAT training timing: step ms, images/s and peak memory over 5 steps
    after 2 warm-up steps; B5 at window 16, B9, B12 and B13 at batch 32:
    ms, plain ms, bound, and for B12 / B13 the library call's ms
    (``F.scaled_dot_product_attention`` with the bias as its mask);
17. B4 vs plain at s = 2 and 3, f32 and bf16, at SwinIR's (1, 264, 264,
    64), HAT's (1, 256, 256, 64) and a ragged (2, 37, 53, 64), each launch
    through its entry;
18. x2 / x3 at full width, SwinIR then HAT at each scale: fused vs plain
    forward (f32, bf16), three requests with launch counts per forward,
    the forward's time (ms, LR MP/s) and B4's ms, plain ms, bound and the
    same tail as a sequence of bf16 PyTorch calls;
19. B14 vs plain, f32 and bf16, at SwinFIR's (1, 264, 264, 180) with
    LeakyReLU 0.2 and res_scale 1 (the path) and ReLU and 0.1, and at a
    ragged odd height (1, 37, 53, 48) with both activations and both scales;
20. SwinFIR x4 serving at full width: fused vs plain forward (f32, bf16),
    uint8 fused vs plain in f32 within 1 LSB, three requests with launch
    counts (B1 36, B14 7, B3 1 a forward, B2 none; every B1 and B14 launch
    through its bf16 entry), the forward's time and B14's ms, plain ms,
    bound and library (cuDNN) ms;
21. SwinFIR training: the fused-train module's loss and gradients in f32
    against an f64 witness and against plain autograd in f32 (batch 4, the
    SFBs' LeakyReLU kinks pinned too); ``Trainer.run`` for 3 steps at the
    recipe (batch 32, f32) with launch counts (B5-B8 36 a step) and a
    falling loss; step ms, images/s and peak memory over 7 steps of one
    batch (the last 5 timed);
22. B15 vs plain, f32 and bf16: MaxSR adaptive (256 windows of 256 tokens,
    4 heads, d 32, no bias), static (1024 windows of 64 tokens, a table
    bias), a mask over the windows of 2 images, N = M = 1024, N 36 at d 16,
    d 12; N 1089 raises; ms, plain ms, bound and SDPA ms at the two MaxSR
    shapes;
23. MaxSR x4 serving at full width, adaptive and static: fused vs plain
    forward (f32, bf16), three requests with 32 B15 launches a forward and
    nothing else, the forward's time;
24. the nine trained checkpoints (SwinIR x2 / x3 / x4 / x8, HAT x2 / x3 /
    x4 at window 8, SwinFIR x4, MaxSR x4 adaptive) on the card: plain f32
    beats bicubic by 0.3 dB, fused f32 is within 0.05 dB of plain, fused
    bf16 beats bicubic by 0.2 dB and is within 0.5 dB of plain, on each of
    the three fixture images, every bf16 B1 / B14 launch through its bf16
    entry; MaxSR's BatchNorm running statistics came back (not the initial
    0 / 1);
25. the Evaluator (HR / LR_bicubic layout built under
    ``build/chip_smoke_eval/`` from the fixture PNGs) on the host and on the
    card for SwinIR x2 and HAT x3, fused bf16: within 1e-4 dB and 1e-5 SSIM;
    the CLI as a subprocess on the x4 checkpoint with ``--half``, whole and
    ``--tile 32 --tile-overlap 8``, against the in-process route, and
    tiled in process at tile 16, overlap 4.

Prints the card line, the script's seconds, a ``{"kernels": [...]}`` JSON
line, and last
``{"ok": true, "device": {...}}``. Random weights come from a seeded
``torch.Generator``; nothing is downloaded.
"""

from __future__ import annotations

import json
import re
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
from studiosr_tpu_torch import HAT, Evaluator2, MaxSR, SwinFIR, SwinIR, Trainer, load_model, resolve_device
from studiosr_tpu_torch.data import PairedImageDataset
from studiosr_tpu_torch.ops.cuda import _build, engagement
from studiosr_tpu_torch.ops.cuda.attn_bwd import attention_bwd, attention_bwd_plain
from studiosr_tpu_torch.ops.attention import attention_plain
from studiosr_tpu_torch.ops.cuda.conv3x3 import (
    cab_body_plain, conv3x3_plain, fused_cab_body, fused_conv3x3, fused_resblock, resblock_plain,
    unpack_conv3x3_weights,
)
from studiosr_tpu_torch.ops.cuda.mlp_block import fused_mlp_block, mlp_block_plain, unpack_mlp_block
from studiosr_tpu_torch.ops.cuda.mlp_bwd import mlp_bwd, mlp_bwd_plain
from studiosr_tpu_torch.ops.cuda.oca_core import oca_core_bwd, oca_core_bwd_plain, oca_core_fwd, oca_core_plain
from studiosr_tpu_torch.ops.cuda.ocab import fused_ocab_block, ocab_plain, overlap_window
from studiosr_tpu_torch.ops.cuda.swin_block import fused_swin_block, swin_block_plain
from studiosr_tpu_torch.ops.cuda.upsampler import (
    fused_upsample_s, fused_upsample_x4, pack_tail, unpack_conv_last_weights, unpack_shuffle_conv_weights,
    upsample_s_plain, upsample_x4_plain,
)
from studiosr_tpu_torch.ops.cuda.window_attention import (
    fused_window_attention_block, unpack_window_attention, window_attention_plain,
)
from studiosr_tpu_torch.ops.cuda.window_attn import window_attention
from studiosr_tpu_torch.ops.windows import calculate_mask, gather_rel_bias, relative_position_index
from studiosr_tpu_torch.parallel import build_optimizer, make_train_step, prepare_state
from studiosr_tpu_torch.serving.hat_fast import prepare_hat_serving
from studiosr_tpu_torch.serving.swinir_fast import prepare_serving
from studiosr_tpu_torch.utils import compute_psnr, imread, imwrite, l1_loss

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
    "fused_swin_block": ("studiosr_tpu_torch/csrc/swin_block_mma.cu", "studiosr_tpu/ops/pallas/swin_block.py:691"),
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
        "studiosr_tpu_torch/csrc/window_attention_mma.cu", "studiosr_tpu/ops/pallas/swin_block.py:549"),
    "fused_mlp_block": ("studiosr_tpu_torch/csrc/mlp_block_mma.cu", "studiosr_tpu/ops/pallas/swin_block.py:904"),
    "mlp_bwd": ("studiosr_tpu_torch/csrc/mlp_bwd_mma.cu", "studiosr_tpu/ops/pallas/mlp_vjp.py:148"),
    "attention_bwd": ("studiosr_tpu_torch/csrc/attn_bwd_mma.cu", "studiosr_tpu/ops/pallas/attn_bwd.py:209"),
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
# all; a missing or wrong gradient reads near 1. HAT at the same limits
# (scripts/torch_grad_witness.py --model hat, seeds 0-3): f32 at most 2.2e-6;
# bf16 at most 2.0e-2 on a bias table and 8.6e-3 over all, but its CABs'
# squeeze-excite convs (attention.1: a 6-channel gradient summed over 4
# samples of 4096-pixel bf16 products) read up to 8.0e-2 in the plain bf16
# control itself (5.7e-2 fused). So a bf16 parameter is held to 5e-2 or to twice the plain
# bf16 control's error on it, whichever is larger: the kernels must not
# add more error than the bf16 policy has; SwinIR's controls stay below
# 2.5e-2, where the rule is 5e-2 alone.
GRAD_RUNS = (("plain", torch.float64), ("plain", torch.float32), ("fused", torch.float32),
             ("plain", torch.bfloat16), ("fused", torch.bfloat16))
GRAD_F32_REL_L2, GRAD_BF16_REL_L2, GRAD_BF16_CONTROL = 1e-5, 5e-2, 2.0
GRAD_ENTRIES: dict = {}  # {(path, dtype): engagement.entries()} of train_grads' last runs

# HAT x4 serving: XPixelGroup/HAT options/test/HAT_SRx4.yml (the JAX
# package's defaults, models/hat.py:388-403), depth not cut.
HAT_MAIN = dict(scale=4, embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=16, mlp_ratio=2.0,
                compress_ratio=3, squeeze_factor=30, conv_scale=0.01, overlap_ratio=0.5)
KERNELS.update({
    "fused_cab_body": ("studiosr_tpu_torch/csrc/cab_body.cu", "studiosr_tpu/ops/pallas/conv3x3.py:393"),
    "fused_window_attention_block_ws16": (
        "studiosr_tpu_torch/csrc/window_attention_mma.cu", "studiosr_tpu/ops/pallas/swin_block.py:549"),
    "fused_mlp_block_extra": ("studiosr_tpu_torch/csrc/mlp_block_mma.cu", "studiosr_tpu/ops/pallas/swin_block.py:904"),
    "fused_ocab_block": ("studiosr_tpu_torch/csrc/ocab.cu", "studiosr_tpu/ops/pallas/ocab.py:173"),
})
HAT_PER_FORWARD = {"fused_cab_body": 36, "fused_window_attention_block_ws16": 36, "fused_mlp_block_extra": 36,
                   "fused_ocab_block": 6, "fused_conv3x3": 7, "fused_upsample_x4": 1}

# HAT x4 training: HAT_SRx4's widths, depth not cut, at the JAX package's
# recipe (models/hat.py _TRAINING_CONFIG, XPixelGroup/HAT train_HAT_SRx4
# options): batch 32 of 64x64 LR crops, bf16 over f32 masters, Adam 2e-4
# (0.9, 0.99), L1, drop_path_rate 0.1, fused_train on; the OCAB is not
# checkpointed.
HAT_TRAIN_MODEL = dict(HAT_MAIN, drop_path_rate=0.1)
HAT_TRAIN_STEPS = 3
HAT_TRAIN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_hat_train"
KERNELS.update({
    "attention_bwd_ws16": ("studiosr_tpu_torch/csrc/attn_bwd_mma.cu", "studiosr_tpu/ops/pallas/attn_bwd.py:508"),
    "oca_core_fwd": ("studiosr_tpu_torch/csrc/oca_core.cu", "studiosr_tpu/ops/pallas/oca_core.py:117"),
    "oca_core_bwd": ("studiosr_tpu_torch/csrc/oca_bwd_mma.cu", "studiosr_tpu/ops/pallas/oca_core.py:157"),
})
HAT_PER_STEP = {"fused_window_attention_block_ws16": 36, "attention_bwd_ws16": 36, "fused_mlp_block": 36,
                "mlp_bwd": 36, "oca_core_fwd": 6, "oca_core_bwd": 6}

# x2 / x3: SwinIR classical x2 / x3 (the x4 widths) and HAT_SRx2 / HAT_SRx3
# (the HAT_SRx4 widths), depth not cut; the tail through B4.
SCALES_S = (2, 3)
B4_SHAPES = ((1, LR + MAIN["window_size"], LR + MAIN["window_size"], 64), (1, LR, LR, 64), (2, 37, 53, 64))
KERNELS["fused_upsample_s"] = ("studiosr_tpu_torch/csrc/upsampler.cu", "studiosr_tpu/ops/pallas/upsampler.py:487")
S_PER_FORWARD = {
    "swinir": {"fused_swin_block": 36, "fused_conv3x3": 7, "fused_upsample_s": 1},
    "hat": {"fused_cab_body": 36, "fused_window_attention_block_ws16": 36, "fused_mlp_block_extra": 36,
            "fused_ocab_block": 6, "fused_conv3x3": 7, "fused_upsample_s": 1},
}
# The trained checkpoints (tests/fixtures/quality) and their floors
# (tests/models/test_quality_fixture.py): (directory, model, scale).
ROOT = Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures" / "quality"
TRAINED = (("swinir_ckpt", "swinir", 4), ("swinir_x2_ckpt", "swinir", 2), ("swinir_x3_ckpt", "swinir", 3),
           ("swinir_x8_ckpt", "swinir", 8), ("hat_ckpt", "hat", 4), ("hat_x2_ckpt", "hat", 2),
           ("hat_x3_ckpt", "hat", 3), ("swinfir_ckpt", "swinfir", 4), ("maxsr_ckpt", "maxsr", 4))
FLOOR_PLAIN, FLOOR_FUSED, FLOOR_BF16, FLOOR_BF16_VS_PLAIN = 0.3, 0.05, 0.2, 0.5
EVAL_DIR, CLI_DIR = ROOT / "build" / "chip_smoke_eval", ROOT / "build" / "chip_smoke_cli"
EVAL_PSNR, EVAL_SSIM, CLI_PSNR, TILED_PSNR = 1e-4, 1e-5, 0.01, 0.5

# SwinFIR x4: the JAX package's build defaults (reference swinfir.py:83-98,
# SwinIR classical's widths), depth not cut; serving in bf16 (B1, B14, B3),
# training at its own recipe (models/swinfir.py _TRAINING_CONFIG: batch 32,
# f32, Adam 2e-4 (0.9, 0.99), L1; B5-B8, the SFBs in plain autograd).
KERNELS["fused_resblock"] = ("studiosr_tpu_torch/csrc/resblock.cu", "studiosr_tpu/ops/pallas/conv3x3.py:266")
SWINFIR_PER_FORWARD = {"fused_swin_block": 36, "fused_resblock": 7, "fused_upsample_x4": 1}
RESBLOCK_SHAPES = ((1, LR + MAIN["window_size"], LR + MAIN["window_size"], MAIN["embed_dim"]), (1, 37, 53, 48))
RESBLOCK_VARIANTS = (("lrelu0.2", 1.0), ("relu", 0.1), ("relu", 1.0), ("lrelu0.2", 0.1))
SWINFIR_TRAIN_STEPS = 3
SWINFIR_TRAIN_DIR = ROOT / "build" / "chip_smoke_swinfir_train"
SWINFIR_GRAD_RUNS = (("plain", torch.float64), ("plain", torch.float32), ("fused", torch.float32))
# the pre-activations of the SFBs' LeakyReLU(0.2)s: kinks pinned to the witness's side
SFB_KINKS = ("S.body.0", "conv_before_fft.0", "fu.conv_layer")

# MaxSR x4: the JAX package's build defaults (adaptive, dim 128, dim_head 32,
# depth [4]x4), depth not cut, and the static mode (window 8, trained bias
# table) at the same widths; bf16, batch 1, 256x256 LR input, B15 for the 32
# attention cores of a forward (2 a block, 16 blocks).
MAXSR_MAIN = dict(scale=4, adaptive=True, dim=128, dim_head=32, depth=[4] * 4, window_size=8, dropout=0.1)
KERNELS["window_attention_pallas"] = ("studiosr_tpu_torch/csrc/window_attn.cu",
                                      "studiosr_tpu/ops/pallas/window_attn.py:115")
MAXSR_PER_FORWARD = {"window_attention_pallas": 32}
# (label, windows, heads, tokens, head dim, bias, mask windows): the first two
# are the two MaxSR modes' shapes at a 256x256 LR input.
# The C entry of the kernels written for the H100 that every bf16 launch of
# B1, B2, B3, B4, B5, B6, B14 and B15 on the served paths must go through, and
# each kernel's stem in its build log (ptxas's registers, shared memory and
# spills).
H100_ENTRIES = {"fused_swin_block": "swin_block_mma_bf16", "fused_conv3x3": "conv3x3_mma_bf16",
                "fused_resblock": "resblock_mma_bf16", "window_attention_pallas": "window_attn_flash_bf16",
                "fused_upsample_x4": "upsample_x4_mma_bf16", "fused_upsample_s": "upsample_s_mma_bf16",
                "fused_window_attention_block": "window_attention_mma_bf16",
                "fused_window_attention_block_ws16": "window_attention16_mma_bf16",
                "fused_mlp_block": "mlp_block_mma_bf16", "fused_mlp_block_extra": "mlp_block_extra_mma_bf16"}
H100_KERNELS = {"fused_swin_block": ("swin_block_mma", "swin_block_mma_kernel"),
                "fused_conv3x3": ("conv3x3", "conv3x3_mma_kernel"),
                "fused_resblock": ("resblock", "conv3x3_mma_kernel"),
                "window_attention_pallas": ("window_attn", "wf_kernel"),
                "fused_upsample_x4": ("upsampler", "upsample_"), "fused_upsample_s": ("upsampler", "upsample_"),
                "attention_bwd": ("attn_bwd_mma", "am_"), "attention_bwd_ws16": ("attn_bwd_mma", "am_"),
                "fused_window_attention_block": ("window_attention_mma", "_kernel"),
                "fused_window_attention_block_ws16": ("window_attention_mma", "_kernel"),
                "mlp_bwd": ("mlp_bwd_mma", "_kernel"), "fused_mlp_block": ("mlp_block_mma", "mf_kernel"),
                "fused_mlp_block_extra": ("mlp_block_mma", "mf_kernel"), "oca_core_bwd": ("oca_bwd_mma", "ob_")}
# The C entry every launch of B5-B9 and B13 must take in a run of each
# dtype: bf16 the kernels written for the H100 (their geometry rules hold at
# every width the paths train), f32 the older kernels.
TRAIN_ENTRIES = {
    torch.bfloat16: {"attention_bwd": "attn_bwd_mma_bf16", "attention_bwd_ws16": "attn_bwd16_mma_bf16",
                     "fused_window_attention_block": "window_attention_mma_bf16",
                     "fused_window_attention_block_ws16": "window_attention16_mma_bf16", "mlp_bwd": "mlp_bwd_mma_bf16",
                     "fused_mlp_block": "mlp_block_mma_bf16", "oca_core_bwd": "oca_core_bwd_mma_bf16"},
    torch.float32: {"attention_bwd": "attn_bwd_f32", "attention_bwd_ws16": "attn_bwd16_f32",
                    "fused_window_attention_block": "window_attention_f32",
                    "fused_window_attention_block_ws16": "window_attention16_f32", "mlp_bwd": "mlp_bwd_f32",
                    "fused_mlp_block": "mlp_block_f32", "oca_core_bwd": "oca_core_bwd_f32"},
}
# The kernels redesigned in bf16 last, held to the same bits from launch to
# launch (no atomic sums) at the path's batch (phases 6, 10 and 13).
BITWISE = ("fused_mlp_block", "fused_mlp_block_extra", "oca_core_bwd")
# B1 in bf16 beyond the main path's shape, as the card tests take it: (C,
# heads, map, shift): C 32 with 2 heads of 16 (the trained fixtures), C 180
# at H != W and an odd window count (a half-empty last window pair), d 8,
# d 12 with an odd count of 8-column output tiles, d 10.
B1_ODD_CASES = ((32, 2, (2, 16, 24), 0), (32, 2, (2, 16, 24), 4), (180, 6, (1, 24, 16), 4),
                (180, 6, (1, 24, 24), 4), (16, 2, (1, 8, 24), 4), (24, 2, (2, 24, 8), 4), (60, 6, (1, 16, 16), 4))
WINDOW_ATTN_CASES = (
    ("adaptive", 256, 4, 256, 32, False, 0), ("static", 1024, 4, 64, 32, True, 0),
    ("mask over 2 images", 128, 4, 64, 32, True, 64), ("N 1024", 4, 4, 1024, 32, True, 0),
    ("N 36 d 16", 64, 2, 36, 16, True, 0), ("d 12", 64, 4, 64, 12, False, 0),
)


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


def kernel_check(part: str, got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype, failed: list) -> float:
    """Hold a kernel's output to the serving kernels' rule (f32: max abs
    error within 1e-4 max|p| + 1e-5; bf16: relative L2 within 1e-2), log
    it, and return the max abs error."""
    if not torch.isfinite(got.float()).all() or got.shape != want.shape:
        failed.append(f"{part}: non-finite or {tuple(got.shape)}")
        return float("inf")
    err = float((got.float() - want).abs().max())
    if dtype == torch.float32:
        limit = F32_RTOL * float(want.abs().max()) + F32_ATOL
        ok = err <= limit
        log(f"check {part} f32: max_abs_err {err:.3e} limit {limit:.3e}")
    else:
        rel = rel_l2(got, want)
        ok = rel <= BF16_REL_L2
        log(f"check {part} bf16: rel_l2 {rel:.3e} limit {BF16_REL_L2:.0e} max_abs_err {err:.3e}")
    if not ok:
        failed.append(f"{part} {dtype}")
    return err


def entry_failures(label: str, launches: dict) -> list:
    """[] when every B1, B2, B3, B4, B14 and B15 launch of ``launches`` went through the bf16
    entry of its kernel written for the H100 (``engagement.entries()`` since
    the same reset), else the failures."""
    entries, failed = engagement.entries(), []
    for name, entry in H100_ENTRIES.items():
        n = launches.get(name, 0)
        if n:
            log(f"{label}: {name} entries {entries.get(name)}")
            if entries.get(name) != {entry: n}:
                failed.append(f"{label}: {name} took {entries.get(name)}, expected all {n} launches through {entry}")
    return failed


def train_entry_failures(label: str, launches: dict, dtype: torch.dtype, entries=None) -> list:
    """[] when every B8 / B9 launch of ``launches`` went through the entry
    ``TRAIN_ENTRIES`` names for ``dtype`` (``entries``: an
    ``engagement.entries()`` taken since the same reset), else the failures."""
    entries, failed = engagement.entries() if entries is None else entries, []
    for name, entry in TRAIN_ENTRIES[dtype].items():
        n = launches.get(name, 0)
        if n:
            log(f"{label}: {name} entries {entries.get(name)}")
            if entries.get(name) != {entry: n}:
                failed.append(f"{label}: {name} took {entries.get(name)}, expected all {n} launches through {entry}")
    return failed


def ptxas_report(name: str) -> str:
    """Registers, static shared memory and spills (``-Xptxas -v``) of each
    instantiation of the H100 kernel behind ``name``, from its build log."""
    source, stem = H100_KERNELS[name]
    parts, fn, spill = [], None, (0, 0)
    for line in _build.build_log(source).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and stem in fn:
            smem = re.search(r"(\d+) bytes smem", line)
            args = ",".join(re.findall(r"Li(\d+)E", fn))
            length = re.match(r"_Z(\d+)", fn)
            kernel = fn[length.end():length.end() + int(length.group(1))] if length else stem
            parts.append(f"{kernel}<{args}> {m.group(1)} registers, {smem.group(1) if smem else 0} B static smem, "
                         f"spills {spill[0]} / {spill[1]} B")
            fn = None
    return "; ".join(parts)


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
            if "Used" in line or "spill" in line:
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
    errors, failed = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        for name, label, kernel, plain, ops in kernel_cases(model, dev, dtype):
            got = kernel(*ops)
            torch.cuda.synchronize()
            want = plain(ops[0].float(), *ops[1:])  # f32 inside; weights as the kernel got them
            torch.cuda.synchronize()
            err = kernel_check(f"{name} [{label}]", got, want, dtype, failed)
            if dtype == torch.bfloat16:
                errors[name] = max(errors.get(name, 0.0), err)
    if failed:
        raise AssertionError("serving kernels disagree with their plain versions: " + "; ".join(failed))
    return errors


def b1_operands(gen, c: int, heads: int, dev: torch.device):
    """Seeded dense B1 operands at C ``c`` (hidden 2 C): weights bf16, the
    rest f32, in ``fused_swin_block``'s order after x."""
    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    bf, hidden = torch.bfloat16, 2 * c
    return [randn(c, scale=0.1) + 1, randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5, dtype=bf),
            randn(3 * c, scale=0.1), randn(c, c, scale=c**-0.5, dtype=bf), randn(c, scale=0.1),
            randn(heads, 64, 64, scale=0.5), randn(c, scale=0.1) + 1, randn(c, scale=0.1),
            randn(c, hidden, scale=c**-0.5, dtype=bf), randn(hidden, scale=0.1),
            randn(hidden, c, scale=hidden**-0.5, dtype=bf), randn(c, scale=0.1)]


def phase_b1_b14_checks(model: SwinIR, dev: torch.device) -> None:
    """The bf16 kernels written for the H100 beyond the main path's variant:
    B1 at the card tests' odd geometries against its plain version, every
    launch through ``swin_block_mma_bf16``; B1 on the blob serving packed at
    load time equals B1 on the dense weights (packed per call) bit for bit
    at the main path's shape; B14 on packed weights equals B14 on HWIO bit
    for bit."""
    from studiosr_tpu_torch.ops.cuda.conv3x3 import pack_conv3x3_weights, prepare_conv3x3_weights

    failed = []
    gen = torch.Generator(device="cpu").manual_seed(SEED + 30)
    for c, heads, shape, shift in B1_ODD_CASES:
        ops = b1_operands(gen, c, heads, dev)
        x = torch.randn(*shape, c, generator=gen).to(dev, torch.bfloat16)
        kw = dict(heads=heads, window_size=8, shift=shift)
        engagement.reset()
        got = fused_swin_block(x, *ops, **kw)
        failed += entry_failures(f"B1 C {c}", engagement.counters())
        want = swin_block_plain(x.float(), *ops, **kw)
        kernel_check(f"fused_swin_block [C {c}, {heads} heads, {'x'.join(map(str, shape))}, shift {shift}]", got,
                     want, torch.bfloat16, failed)
    blk = model.module.layers[0].residual_group.blocks[1]
    prep = prepare_serving(model.module, model.config, torch.bfloat16)["blocks"][0][1]
    dense = list(prepare_serving(model.module, model.config, torch.float32)["blocks"][0][1].values())
    dense = [t.to(torch.bfloat16) if i in (2, 4, 9, 11) else t for i, t in enumerate(dense)]
    hp = LR + MAIN["window_size"]
    x = torch.randn(1, hp, hp, MAIN["embed_dim"], generator=gen).to(dev, torch.bfloat16)
    kw = dict(heads=blk.attn.num_heads, window_size=8, shift=4)
    same_b1 = torch.equal(fused_swin_block(x, **prep, **kw), fused_swin_block(x, *dense, **kw))
    conv = model.module.layers[0].conv
    hwio = prepare_conv3x3_weights(conv.weight, torch.bfloat16)
    b = conv.bias.detach().float().contiguous()
    same_b14 = torch.equal(fused_resblock(x, hwio, b, hwio, b, activation="lrelu0.2"),
                           fused_resblock(x, pack_conv3x3_weights(hwio), b, pack_conv3x3_weights(hwio), b,
                                          activation="lrelu0.2"))
    log(f"B1 packed (load time) vs dense (packed per call) at {hp}x{hp}x{MAIN['embed_dim']}: bitwise "
        f"{'equal' if same_b1 else 'DIFFERENT'}; B14 packed vs HWIO: bitwise {'equal' if same_b14 else 'DIFFERENT'}")
    if not same_b1:
        failed.append("B1 on the packed blob differs from B1 on the dense weights")
    if not same_b14:
        failed.append("B14 on packed weights differs from B14 on HWIO weights")
    if failed:
        raise AssertionError("; ".join(failed))


def tail_ops(gen, dev: torch.device, dtype: torch.dtype, cin: int, s: int, convs: int):
    """Seeded HWIO tail operands (w0, b0, [w1, b1,] w2, b2) in ``dtype``."""
    ops = []
    for _ in range(convs):
        ops += [(torch.randn(3, 3, cin, s * s * cin, generator=gen) * (9 * cin) ** -0.5).to(dev, dtype),
                (torch.randn(s * s * cin, generator=gen) * 0.1).to(dev)]
    return ops + [(torch.randn(3, 3, cin, 3, generator=gen) * (9 * cin) ** -0.5).to(dev, dtype),
                  (torch.randn(3, generator=gen) * 0.1).to(dev)]


def phase_tail_checks(dev: torch.device) -> None:
    """B3 beyond the main path's shape: HAT's 256 x 256 x 64 and a ragged
    (2, 37, 53, 64) map (no tile divides it, batch 2), f32 and bf16, against
    its plain version, each launch through its entry (bf16: the kernels
    written for the H100); and in bf16 at the main path's 264 x 264 x 64,
    B3 and B4 x2 / x3 on the weights packed at load time equal the same
    tails on HWIO weights (packed per call) bit for bit."""
    failed = []
    gen = torch.Generator(device="cpu").manual_seed(SEED + 31)
    for dtype in (torch.float32, torch.bfloat16):
        entry = "upsample_x4_mma_bf16" if dtype == torch.bfloat16 else "upsample_x4_f32"
        for shape in ((1, LR, LR, 64), (2, 37, 53, 64)):
            x = torch.randn(*shape, generator=gen).to(dev, dtype)
            ops = tail_ops(gen, dev, dtype, 64, 2, 2)
            engagement.reset()
            got = fused_upsample_x4(x, *ops)
            if engagement.entries() != {"fused_upsample_x4": {entry: 1}}:
                failed.append(f"B3 {shape} took {engagement.entries()}")
            want = upsample_x4_plain(x.float(), *ops)
            kernel_check(f"fused_upsample_x4 [{'x'.join(map(str, shape))}]", got, want, dtype, failed)
            del got, want
    hp = LR + MAIN["window_size"]
    x = torch.randn(1, hp, hp, 64, generator=gen).to(dev, torch.bfloat16)
    same = {}
    for scale in (4, *SCALES_S):
        ops = tail_ops(gen, dev, torch.bfloat16, 64, 2 if scale == 4 else scale, 2 if scale == 4 else 1)
        if scale == 4:
            same[scale] = torch.equal(fused_upsample_x4(x, *pack_tail(ops, 4)), fused_upsample_x4(x, *ops))
        else:
            same[scale] = torch.equal(fused_upsample_s(x, *pack_tail(ops, scale), scale),
                                      fused_upsample_s(x, *ops, scale))
    log(f"B3 / B4 x2 / x3 packed (load time) vs HWIO (packed per call) at {hp}x{hp}x64: bitwise "
        + ", ".join(f"x{k} {'equal' if v else 'DIFFERENT'}" for k, v in same.items()))
    failed += [f"x{k}: the tail on packed weights differs from the tail on HWIO weights" for k, v in same.items()
               if not v]
    if failed:
        raise AssertionError("; ".join(failed))


def hwio_tail(tail, cin: int, scale: int) -> list:
    """The tail's weights back in HWIO, whichever layout they came in."""
    s, n_colors = 2 if scale == 4 else scale, tail[-1].shape[0]
    out = [unpack_shuffle_conv_weights(t, cin, s) if t.dim() == 6 else t for t in tail[:-2]]
    return out + [unpack_conv_last_weights(tail[-2], n_colors) if tail[-2].dim() == 5 else tail[-2], tail[-1]]


def tail_sequence(x, tail, scale: int):
    """The pixelshuffle tail as a sequence of bf16 PyTorch calls (the
    yardstick beside B3 and B4, which no single call computes):
    channels-last ``F.conv2d`` (cuDNN) and ``F.pixel_shuffle``. ``tail``:
    OIHW channels-last weights and biases in x's dtype, from
    :func:`sequence_weights`."""
    s = 2 if scale == 4 else scale
    y = x.permute(0, 3, 1, 2)
    for w, b in zip(tail[:-2:2], tail[1:-2:2]):
        y = F.pixel_shuffle(F.conv2d(y, w, b, padding=1), s).contiguous(memory_format=torch.channels_last)
    return F.conv2d(y, tail[-2], tail[-1], padding=1).permute(0, 2, 3, 1)


def sequence_weights(tail, cin: int, scale: int, dtype: torch.dtype) -> list:
    return [t.to(dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last) if t.dim() == 4
            else t.to(dtype) for t in hwio_tail(tail, cin, scale)]


def b1_torch_sequence(x, ops, heads: int, shift: int, window_mask=None):
    """The Swin block as a sequence of bf16 PyTorch calls (layer_norm,
    matmul, SDPA with the rel-pos bias and mask as its additive mask,
    matmul, layer_norm, matmul + GELU, matmul, the rolls and window
    partitions): the yardstick beside B1, which no single call computes.
    ``ops``: dense operands, weights bf16; ``window_mask``: the (nW, 64, 64)
    shifted-window mask in x's dtype when ``shift``."""
    ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2 = ops
    bsz, h, w, c = x.shape
    d, dt = c // heads, x.dtype
    xs = torch.roll(x, (-shift, -shift), dims=(1, 2)) if shift else x
    ln = F.layer_norm(xs, (c,), ln1_w.to(dt), ln1_b.to(dt), 1e-5)
    win = ln.reshape(bsz, h // 8, 8, w // 8, 8, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, 64, c)
    qkv = (win @ wqkv + bqkv.to(dt)).reshape(-1, 64, 3, heads, d).permute(2, 0, 3, 1, 4)
    mask = bias.to(dt)[None]
    if shift:
        mask = (mask.reshape(1, 1, heads, 64, 64) + window_mask[None, :, None]).reshape(
            -1, heads, 64, 64)
        mask = mask.repeat(bsz, 1, 1, 1)
    attn = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], attn_mask=mask)
    attn = attn.transpose(1, 2).reshape(-1, 64, c) @ wproj + bproj.to(dt)
    attn = attn.reshape(bsz, h // 8, w // 8, 8, 8, c).permute(0, 1, 3, 2, 4, 5).reshape(bsz, h, w, c)
    z = xs + attn
    y = z + F.gelu(F.layer_norm(z, (c,), ln2_w.to(dt), ln2_b.to(dt), 1e-5) @ w1 + b1.to(dt)) @ w2 + b2.to(dt)
    return torch.roll(y, (shift, shift), dims=(1, 2)) if shift else y



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
    failed = entry_failures("swinir serving", launches)
    if failed:
        raise AssertionError("; ".join(failed))
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
        plain_ops, library_ms = ops, None
        x_ = ops[0]
        if name == "fused_swin_block":
            c = x_.shape[-1]
            hidden = ops[11].shape[-1]
            tokens = x_.numel() // c
            flops = 2 * tokens * c * (3 * c + c + 2 * hidden) + 4 * tokens * 64 * c
            moved = 2 * nbytes(x_) + nbytes(*ops[1:])  # the packed blob (weights and bias) read once
            heads = MAIN["num_heads"][0]
            plain_ops = (x_, *[t.to(x_.dtype) if i in (2, 4, 9, 11) else t for i, t in enumerate(
                prepare_serving(model.module, model.config, torch.float32)["blocks"][0][1].values())])  # dense
            wmask = torch.from_numpy(calculate_mask(tuple(x_.shape[1:3]), 8, 4)).to(dev, x_.dtype)
            seq_err = rel_l2(b1_torch_sequence(x_, plain_ops[1:], heads, 4, wmask), plain(x_.float(), *ops[1:]))
            seq_ms = time_ms(lambda: b1_torch_sequence(x_, plain_ops[1:], heads, 4, wmask), iters=10)
            log(f"time fused_swin_block yardstick (a sequence of bf16 PyTorch calls: layer_norm, matmul, SDPA with "
                f"the bias and mask, matmul, layer_norm, matmul + GELU, matmul; rel_l2 {seq_err:.2e} against the "
                f"plain version): {seq_ms:.3f} ms")
        elif name == "fused_conv3x3":
            w, b, extra = unpack_conv3x3_weights(ops[1], x_.shape[-1], ops[2].shape[0]), ops[2], ops[3]  # HWIO
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
            n_colors = ops[6].shape[0]
            flops = 2 * 9 * cin * (pix * 4 * cin + 4 * pix * 4 * cin + 16 * pix * n_colors)
            moved = nbytes(x_, *hwio_tail(ops[1:], cin, 4)) + 16 * pix * n_colors * x_.element_size()
            seq = sequence_weights(ops[1:], cin, 4, x_.dtype)
            seq_err = rel_l2(tail_sequence(x_, seq, 4), plain(x_.float(), *ops[1:]))
            seq_ms = time_ms(lambda: tail_sequence(x_, seq, 4), iters=10)
            log(f"time fused_upsample_x4 yardstick (a sequence of bf16 PyTorch calls: channels-last F.conv2d x3 + "
                f"F.pixel_shuffle x2; rel_l2 {seq_err:.2e} against the plain version): {seq_ms:.3f} ms")
        plain_ms = time_ms(lambda: plain(*plain_ops), iters=10)
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
        if name in H100_KERNELS:
            ratio = "none (no one call)" if library_ms is None else f"{ms / library_ms:.2f}"
            log(f"  {name}: kernel / library {ratio}, {100 * bms / ms:.1f} % of the bound; {ptxas_report(name)}")
    return rows


# -- training phases --------------------------------------------------------------


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def train_kernel_cases(model: SwinIR, dev: torch.device, dtype: torch.dtype, batch: int):
    """(name, label, kernel fn, plain fn, operands) for B5-B8 at the training
    shapes (64x64 maps, C 180), with block 0's (shift 0) and block 1's (shift
    4) weights, drop-path scales (0, 1/0.9, ...) and a seeded cotangent; B6
    also on the rows less 37 (a ragged last tile), without drop-path."""
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
        # the gathered bias in the path's dtype, as the bf16 step gathers it from its bf16 table
        bias = gather_rel_bias(f(a.relative_position_bias_table), relative_position_index(ws), heads).to(dtype)
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
        # a row count that is not a whole number of 64-row tiles, no drop-path
        cases.append(("fused_mlp_block", "ragged rows", fused_mlp_block, mlp_block_plain,
                      (xr[: rows - 37], *mlp_ops, f(m.fc2.bias))))
        cases.append(("mlp_bwd", "rows", lambda *o, kw=kw: mlp_bwd(*o, **kw),
                      lambda *o, kw=kw: mlp_bwd_plain(*o, **kw), (xr, gr, *mlp_ops)))
    return cases


# The operand whose sample 0 a kernel's first output equals when that
# sample's drop-path scale is 0.
PASS_THROUGH = {"fused_window_attention_block": 0, "fused_window_attention_block_ws16": 0, "attention_bwd": 1,
                "attention_bwd_ws16": 1, "fused_mlp_block": 0}


def phase_train_kernels(model, dev: torch.device, cases=None) -> dict:
    """B5-B8 (or, with ``cases=hat_train_kernel_cases``, B9, B12 and B13)
    against their plain versions, f32 then bf16, every output (dx and each
    gradient) held to the serving kernels' rule: at batch 4 (256 windows,
    one to each block of B8's per-window pass) and at the path's batch 32
    (2048 windows, eight to each block, which sums their bias-gradient
    partials), each launch through its dtype's entry (``TRAIN_ENTRIES``)
    and, in bf16 at batch 32, the kernels of ``BITWISE`` launched twice for
    the same bits. Returns the bf16 max abs error of each kernel's first
    output at batch 32."""
    errors: dict = {}
    failed = []
    for batch in (CHECK_BATCH, TRAIN_BATCH):
        for dtype in (torch.float32, torch.bfloat16):
            for name, label, kernel, plain, ops in (cases or train_kernel_cases)(model, dev, dtype, batch):
                engagement.reset()
                got = _flat(kernel(*ops))
                torch.cuda.synchronize()
                failed += train_entry_failures(f"{name} [{label}] batch {batch}", engagement.counters(), dtype)
                if dtype == torch.bfloat16 and batch == TRAIN_BATCH and name in BITWISE:
                    again = _flat(kernel(*ops))
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    log(f"check {name} [{label}] batch {batch} bf16: two launches give the same bits: {same}")
                    if not same:
                        failed.append(f"{name} [{label}] batch {batch}: two launches differ")
                    del again
                want = _flat(plain(*[t.float() for t in ops]))
                torch.cuda.synchronize()
                for i, (k, p) in enumerate(zip(got, want)):
                    err = kernel_check(f"{name} [{label}] batch {batch} output {i}", k, p, dtype, failed)
                    if dtype == torch.bfloat16 and i == 0 and batch == TRAIN_BATCH:
                        errors[name] = max(errors.get(name, 0.0), err)
                if name in PASS_THROUGH and label != "ragged rows" and not torch.equal(got[0][0],
                                                                                     ops[PASS_THROUGH[name]][0]):
                    failed.append(f"{name} [{label}] batch {batch} {dtype}: a dropped sample is not passed through")
                del got, want
                torch.cuda.empty_cache()
    if failed:
        raise AssertionError("training kernels disagree with their plain versions: " + "; ".join(failed))
    return errors


def _unit_batch(dev: torch.device, batch: int, seed: int):
    rng = np.random.default_rng(seed)
    lq = rng.integers(0, 256, (batch, TRAIN_CROP, TRAIN_CROP, 3), dtype=np.uint8)
    gt = rng.integers(0, 256, (batch, 4 * TRAIN_CROP, 4 * TRAIN_CROP, 3), dtype=np.uint8)
    return torch.from_numpy(lq).to(dev), torch.from_numpy(gt).to(dev)


def train_grads(model, dev: torch.device, seed: int, grad_runs=GRAD_RUNS) -> dict:
    """Loss and every parameter's gradient of the port's ``model`` (SwinIR or
    HAT, f32 weights from ``seed``) at batch 4, one run for each (path,
    dtype) of ``GRAD_RUNS``, with the same weights, uint8 batch and
    drop-path draws. The weights and input are copied into the run's dtype
    (the bf16 policy of the train step) and the loss is taken in f32 (f64
    for the witness).

    Every run takes the witness's side of the model's kinks. The gradient of
    a piecewise-linear function jumps where a value crosses a kink, and a
    value within rounding noise of one crosses it in one run and not in
    another (about one in 10^6 values at f32), which moves a gradient as no
    kernel error does. So every run back-propagates the witness's L1
    cotangent, sign(out - target) / n, and where a pre-activation of a ReLU
    or LeakyReLU (the one before the upsampler; HAT's squeeze-excite gates,
    ``attention.1``) lies on the other side of 0 from the witness's, takes
    the witness's value there (with the run's own gradient through it).
    Both counts are returned.

    ``grad_runs`` lists the (path, dtype) runs, the f64 witness first.

    Returns {(path, dtype): (loss, {name: grad}, launches, (L1 signs,
    ReLU sides) unlike the witness's)}."""
    module = model.module.train()
    lq, gt = _unit_batch(dev, CHECK_BATCH, seed + 3)
    x, target = lq.float() / 255.0, gt.float() / 255.0
    named = list(module.named_parameters())
    runs, sign, witness, flips = {}, None, {}, [0]

    def pin(mod, _, y):  # forward hook on a conv before a (Leaky)ReLU
        if mod not in witness:
            witness[mod] = y.detach()
            return None
        w = witness[mod]
        other = (y.detach() > 0) != (w > 0)
        flips[0] += int(other.sum())
        return y + (torch.where(other, w.to(y.dtype), y) - y).detach()

    kinks = [m for n, m in module.named_modules()
             if n == "conv_before_upsample.0" or n.endswith("attention.1") or n.endswith(SFB_KINKS)]
    handles = [m.register_forward_hook(pin) for m in kinks]
    try:
        for path, dtype in grad_runs:
            module.fused_train = path == "fused"
            acc = torch.float64 if dtype == torch.float64 else torch.float32
            leaves = {k: p.detach().to(dtype).requires_grad_() for k, p in named}
            engagement.reset()
            flips[0] = 0
            out = functional_call(module, leaves, (x.to(dtype),),
                                  {"generator": torch.Generator().manual_seed(seed + 11)})
            diff = out.to(acc) - target.to(acc)
            if sign is None:
                sign = torch.sign(diff.detach())  # the witness runs first
            flipped = (int((torch.sign(diff.detach()) != sign).sum()), flips[0])
            grads = torch.autograd.grad((diff * sign.to(acc)).mean(), list(leaves.values()))
            torch.cuda.synchronize()
            runs[(path, dtype)] = (float(diff.detach().abs().mean()), dict(zip(leaves, grads)),
                                   engagement.counters(), flipped)
            GRAD_ENTRIES[(path, dtype)] = engagement.entries()
            del out, diff, grads, leaves
            torch.cuda.empty_cache()
    finally:
        for handle in handles:
            handle.remove()
        module.fused_train = False
    return runs


def grad_report(runs: dict, seed: int, label: str = "") -> dict:
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
            f"; kinks on the other side from the witness: L1 {r['flipped'][0]}, ReLU {r['flipped'][1]}")
        log(f"{label}grads seed {seed} {path} {str(dtype)[6:]} vs {against}, batch {CHECK_BATCH}: "
            f"loss rel {r['loss']:.3e}"
            f"{flips}; all gradients rel_l2 {r['all']:.3e}; per parameter median {params[len(params) // 2][0]:.3e}, "
            f"worst {params[0][0]:.3e} ({params[0][1]}); bias tables median {float(np.median(tables)):.3e} "
            f"worst {max(tables):.3e}; others worst {others[0][0]:.3e} ({others[0][1]})")
    return report


def phase_train_grads(dev: torch.device, name: str = "swinir") -> None:
    """The fused-train module's loss and gradients, f32 and bf16, and the
    plain f32 and bf16 controls, against an f64 witness: plain autograd of
    the port's SwinIR (or HAT) in f64 on the same weights, batch and
    drop-path draws."""
    if name == "swinir":
        model, per_step, label = SwinIR.build(**TRAIN_MODEL, seed=SEED, device=dev), PER_STEP, ""
    else:
        model, per_step, label = HAT.build(**HAT_TRAIN_MODEL, seed=SEED, device=dev), HAT_PER_STEP, "hat "
    runs = train_grads(model, dev, SEED)
    del model
    report = grad_report(runs, SEED, label)
    failed = []
    for (path, dtype), (_, grads, launches, _) in runs.items():
        expected = per_step if path == "fused" else {}
        if any(launches.get(k, 0) != expected.get(k, 0) for k in set(launches) | set(expected)):
            failed.append(f"{path} {dtype}: launches {launches}, expected {expected}")
        if not all(torch.isfinite(g).all() for g in grads.values()):
            failed.append(f"{path} {dtype}: non-finite gradients")
        if path == "fused":
            failed += train_entry_failures(f"{label}grads fused {dtype}", launches, dtype, GRAD_ENTRIES[(path, dtype)])
    f32, bf16 = report[("fused", torch.float32)], report[("fused", torch.bfloat16)]
    control = report[("plain", torch.bfloat16)]["params"]
    worst32 = max(f32["params"].values())
    worst16 = max(bf16["params"].values())
    limits16 = {k: max(GRAD_BF16_REL_L2, GRAD_BF16_CONTROL * control[k]) for k in bf16["params"]}
    raised = {k: round(v, 4) for k, v in limits16.items() if v > GRAD_BF16_REL_L2}
    log(f"{label}grads held: fused f32 loss rel {f32['loss']:.3e} and each parameter (worst {worst32:.3e}) <= "
        f"{GRAD_F32_REL_L2:.0e}; fused bf16 loss rel {bf16['loss']:.3e} and all gradients {bf16['all']:.3e} <= "
        f"{GRAD_BF16_REL_L2:.0e}, each parameter (worst {worst16:.3e}) <= {GRAD_BF16_REL_L2:.0e} or "
        f"{GRAD_BF16_CONTROL:g}x the plain bf16 control's error (limits above {GRAD_BF16_REL_L2:.0e}: {raised})")
    if f32["loss"] > GRAD_F32_REL_L2 or worst32 > GRAD_F32_REL_L2:
        failed.append("f32 fused gradients disagree with the f64 witness")
    if max(bf16["loss"], bf16["all"]) > GRAD_BF16_REL_L2 or any(
        v > limits16[k] for k, v in bf16["params"].items()
    ):
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


def _trainer(dev: torch.device, seed: int, losses: list, model=None, steps: int = TRAIN_STEPS + 1,
             eval_interval: int = TRAIN_STEPS, ckpt_path: Path = TRAIN_DIR) -> Trainer:
    def criterion(pred, target):
        loss = l1_loss(pred, target)
        losses.append(loss.detach())
        return loss

    if model is None:
        model = SwinIR.build(**TRAIN_MODEL, seed=seed, device=dev)
    return Trainer(model, MemoryPairs(SEED), batch_size=TRAIN_BATCH, num_workers=4, max_iters=steps,
                   eval_interval=eval_interval, ckpt_path=str(ckpt_path), seed=SEED, log_interval=100,
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
    failed += train_entry_failures("swinir trainer", launches, torch.bfloat16)
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
    elif name in ("attention_bwd", "attention_bwd_ws16"):
        n = ops[-1].shape[-1]  # tokens a window
        flops = 3 * 2 * tokens * c * 3 * c + 2 * 2 * tokens * c * c + 12 * tokens * n * c
        moved = 3 * nbytes(x) + nbytes(*ops[2:]) + 4 * sum(t.numel() for t in ops[2:])  # + f32 gradients
    elif name == "fused_mlp_block":
        flops = 4 * tokens * c * ops[3].shape[-1]
        moved = 2 * nbytes(x) + nbytes(*ops[1:])
    else:
        flops = 10 * tokens * c * ops[4].shape[-1]
        moved = 3 * nbytes(x) + nbytes(*ops[2:]) + 4 * sum(t.numel() for t in ops[2:])  # + f32 gradients
    return flops, moved


def kw_of(label: str, ws: int, batch: int, dev: torch.device) -> dict:
    """The attention backward's keywords of the timed case ``label`` ("shift s")."""
    dp = torch.full((batch,), 1 / 0.9, device=dev)
    dp[0] = 0.0
    return dict(heads=MAIN["num_heads"][0], window_size=ws, shift=int(label.split()[-1]), drop_path=dp)


def yardstick_report(name: str, ops, ms: float, bms: float, kw: dict) -> None:
    """A kernel's share of its bound, its ptxas line and its yardstick, the
    same function as a sequence of bf16 PyTorch calls
    (scripts/torch_time_attn_kernels.py), timed here and never on the path:
    B8 / B9 the attention half and its backward (cuBLAS, SDPA with the bias
    and shift mask as a mask that takes a gradient, LayerNorm); B5 the half
    (LayerNorm, cuBLAS, SDPA with the bias and mask, the projection and the
    add); B7 ``torch.autograd.grad`` through LayerNorm, two linears and the
    exact GELU; B6 LayerNorm, two linears, the exact GELU, the drop-path
    scale and the add (for ``extra`` the join first); B13 the explicit
    formulas of the backward (cuBLAS products, the softmax and its backward
    in f32)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_time_attn_kernels import (
        attention_half_forward_sequence, attention_half_sequence, mlp_half_backward_sequence,
        mlp_half_forward_sequence, oca_backward_sequence,
    )

    if name.startswith("attention_bwd"):
        x, g, *attn_ops = ops
        sequence = attention_half_sequence(x, g, attn_ops, kw["heads"], kw["window_size"], kw["shift"],
                                           kw["drop_path"])
    elif name.startswith("fused_window_attention_block"):
        sequence = attention_half_forward_sequence(ops[0], ops[1:], kw["heads"], kw["window_size"], kw["shift"],
                                                   kw.get("drop_path"))
    elif name.startswith("fused_mlp_block"):
        sequence = mlp_half_forward_sequence(ops[0], ops[1:7], kw.get("drop_path"), kw.get("rows_per_sample", 0),
                                             kw.get("extra"), kw.get("extra_scale"))
    elif name == "oca_core_bwd":
        sequence = oca_backward_sequence(*ops)
    else:
        sequence = mlp_half_backward_sequence(*ops[:2], ops[2:], kw["drop_path"], kw["rows_per_sample"])
    yard = time_ms(sequence, iters=3, warmup=1)
    del sequence
    torch.cuda.empty_cache()
    log(f"  {name}: {100 * bms / ms:.1f} % of the bound; yardstick (bf16 PyTorch sequence) {yard:.3f} ms, "
        f"kernel / yardstick {ms / yard:.3f}; {ptxas_report(name)}")


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
        if (label == "shift 0" and name != "fused_mlp_block" and name != "mlp_bwd") or label == "ragged rows":
            continue  # the attention kernels are timed at shift 4 (the shift costs nothing extra); B6 on whole rows
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
        if name in ("attention_bwd", "fused_window_attention_block"):
            yardstick_report(name, ops, ms, bms, kw_of(label, MAIN["window_size"], TRAIN_BATCH, dev))
        elif name in ("mlp_bwd", "fused_mlp_block"):
            dp = kw_of("shift 0", MAIN["window_size"], TRAIN_BATCH, dev)["drop_path"]
            yardstick_report(name, ops, ms, bms, dict(drop_path=dp, rows_per_sample=TRAIN_CROP * TRAIN_CROP))
    log(f"train step: kernels {kernel_total:.1f} ms, the rest (convs, LayerNorms, tail, optimizer, gaps) "
        f"{step_ms - kernel_total:.1f} ms")
    return rows


# -- HAT serving phases -----------------------------------------------------------


def hat_kernel_cases(model: HAT, dev: torch.device, dtype: torch.dtype):
    """(name, label, kernel fn, plain fn, operands) of B11, B5 at window 16,
    B6 with the CAB join and B10 at HAT serving's shapes (a 256x256 map, C
    180), with group 0's weights laid out for ``dtype``."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 5)
    c, heads, ws = HAT_MAIN["embed_dim"], HAT_MAIN["num_heads"][0], HAT_MAIN["window_size"]

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    prep = prepare_hat_serving(model.module, model.config, dtype)
    x = randn(1, LR, LR, c)
    extra = randn(LR * LR, c)
    escale = torch.rand(c, generator=gen).to(dev)  # the gate times conv_scale is smaller; 1 makes the join count
    blocks = prep["blocks"][0]
    cases = [("fused_cab_body", "cab", fused_cab_body, cab_body_plain, (x, *blocks[0]["cab"].values()))]
    for shift in (0, ws // 2):
        kw = dict(heads=heads, window_size=ws, shift=shift)
        attn = blocks[1 if shift else 0]["attn"]
        # bf16 serving hands the kernel one blob (weights and bias packed at load
        # time); the plain version gets them back dense
        dense = unpack_window_attention(attn["wqkv"], c, heads, ws) if attn["wproj"] is None else None
        cases.append(("fused_window_attention_block_ws16", f"shift {shift}",
                      lambda *o, kw=kw: fused_window_attention_block(*o, **kw),
                      lambda *o, kw=kw, dense=dense: window_attention_plain(
                          *(o if dense is None else (*o[:3], dense[0], o[4], dense[1], o[6], dense[2])), **kw),
                      (x, *attn.values())))
    cases.append(("fused_mlp_block_extra", "extra",
                  lambda *o: fused_mlp_block(*o[:7], extra=o[7], extra_scale=o[8]),
                  lambda *o: mlp_block_plain(*o[:7], extra=o[7], extra_scale=o[8]),
                  (x.reshape(-1, c), *blocks[0]["mlp"].values(), extra, escale)))
    kw = dict(heads=heads, window_size=ws, overlap_ratio=HAT_MAIN["overlap_ratio"])
    cases.append(("fused_ocab_block", "border windows", lambda *o: fused_ocab_block(*o, **kw),
                  lambda *o: ocab_plain(*o, **kw), (x, *prep["ocab"][0].values())))
    return cases


def phase_hat_kernels(model: HAT, dev: torch.device) -> dict:
    """The HAT kernels against their plain versions, f32 then bf16, every
    output held to the serving kernels' rule. Returns the bf16 max abs
    error of each kernel's first output."""
    errors: dict = {}
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, label, kernel, plain, ops in hat_kernel_cases(model, dev, dtype):
            got = _flat(kernel(*ops))
            torch.cuda.synchronize()
            if dtype == torch.bfloat16 and name in BITWISE:
                same = all(torch.equal(a, b) for a, b in zip(got, _flat(kernel(*ops))))
                log(f"check {name} [{label}] bf16: two launches give the same bits: {same}")
                if not same:
                    failed.append(f"{name} [{label}]: two launches differ")
            want = _flat(plain(*[None if t is None else t.float() for t in ops]))
            torch.cuda.synchronize()
            for i, (k, p) in enumerate(zip(got, want)):
                err = kernel_check(f"{name} [{label}] output {i}", k, p, dtype, failed)
                if dtype == torch.bfloat16 and i == 0:
                    errors[name] = max(errors.get(name, 0.0), err)
            del got, want
    if failed:
        raise AssertionError("HAT kernels disagree with their plain versions: " + "; ".join(failed))
    return errors


def phase_hat_end_to_end(model: HAT, dev: torch.device) -> dict:
    """Fused vs plain HAT forward (f32, then bf16 against f32 plain), then
    the served requests with their launch counts."""
    images = requests()
    x = torch.from_numpy(images[0]).to(dev).float()[None] / 255.0
    plain = model.enable_fused(False)(x)
    fused = model.enable_fused(True)(x)
    torch.cuda.synchronize()
    rel32 = rel_l2(fused, plain)
    log(f"hat e2e f32 fused vs plain: rel_l2 {rel32:.3e} limit {E2E_F32_REL_L2:.0e}")
    model.half()
    fused16 = model(x)
    torch.cuda.synchronize()
    rel16 = rel_l2(fused16, plain)
    log(f"hat e2e bf16 fused vs f32 plain: rel_l2 {rel16:.3e} limit {E2E_BF16_REL_L2:.0e}")
    failed = []
    if not rel32 <= E2E_F32_REL_L2:
        failed.append("f32 fused HAT forward disagrees with the plain forward")
    if not rel16 <= E2E_BF16_REL_L2:
        failed.append("bf16 fused HAT forward disagrees with the plain forward")
    if not bool(torch.isfinite(fused16).all()) or fused16.shape != (1, 4 * LR, 4 * LR, 3):
        failed.append(f"bad bf16 HAT forward {tuple(fused16.shape)}")

    model.serving_prep()  # load-time weight layout, outside the counted run
    engagement.reset()
    t0 = time.perf_counter()
    outs = [model.inference(im) for im in images]
    seconds = time.perf_counter() - t0
    launches = engagement.counters()
    log(f"hat served {len(outs)} requests in {seconds:.3f} s (host clock); launches {launches}")
    for out in outs:
        if out.shape != (4 * LR, 4 * LR, 3) or out.dtype != np.uint8:
            failed.append(f"bad HAT output {out.shape} {out.dtype}")
    for name in set(launches) | set(HAT_PER_FORWARD):
        if launches.get(name, 0) != HAT_PER_FORWARD.get(name, 0) * REQUESTS:
            failed.append(f"{name}: {launches.get(name, 0)} launches, expected {HAT_PER_FORWARD.get(name, 0)} "
                          f"per forward")
    failed += entry_failures("hat serving", launches)
    if failed:
        raise AssertionError("; ".join(failed))
    return launches


def hat_bounds(name: str, ops) -> tuple:
    """(flops, bytes) of one launch from its operands: each input read once,
    each output written once."""
    x = ops[0]
    c = x.shape[-1]
    tokens = x.numel() // c
    if name == "fused_cab_body":
        w1 = ops[3]
        flops = 2 * 2 * tokens * 9 * c * w1.shape[-1]
        moved = 2 * nbytes(x) + nbytes(*ops[1:]) + 4 * x.shape[0] * c  # + the f32 sums
    elif name == "fused_window_attention_block_ws16":
        n = HAT_MAIN["window_size"] ** 2
        flops = 2 * tokens * c * 4 * c + 4 * tokens * n * c
        moved = 2 * nbytes(x) + nbytes(*ops[1:])
    elif name == "fused_mlp_block_extra":  # ops[3] may be the packed blob: hidden from b1
        flops = 4 * tokens * c * ops[4].numel()
        moved = 2 * nbytes(x) + nbytes(*ops[1:])
    else:
        nk, hidden = ops[7].shape[-1], ops[10].shape[-1]
        flops = 2 * tokens * c * 4 * c + 4 * tokens * nk * c + 4 * tokens * c * hidden
        moved = 2 * nbytes(x) + nbytes(*ops[1:])
    return flops, moved


def phase_hat_timing(model: HAT, dev: torch.device, errors: dict, launches: dict) -> list:
    x = torch.from_numpy(requests()[0]).to(dev).float()[None] / 255.0
    fwd = time_ms(lambda: model(x), iters=5)
    log(f"hat forward bf16 batch 1 {LR}x{LR}: {fwd:.3f} ms, {LR * LR / 1e6 / (fwd / 1e3):.3f} LR MP/s")
    rows, kernel_total = [], 0.0
    for name, label, kernel, plain, ops in hat_kernel_cases(model, dev, torch.bfloat16):
        if label == "shift 0":
            continue  # timed at shift 8; the shift costs nothing extra
        ms = time_ms(lambda: kernel(*ops), iters=10)
        plain_ms = time_ms(lambda: plain(*ops), iters=3, warmup=1)
        flops, moved = hat_bounds(name, ops)
        bms, by = bound_ms(flops, moved)
        per = HAT_PER_FORWARD[name]
        kernel_total += per * ms
        source, replaces = KERNELS[name]
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches.get(name, 0),
                         max_abs_err=errors[name], ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=None))
        log(f"time {name} [{label}] bf16: {ms:.3f} ms ({100 * per * ms / fwd:.1f} % of a forward at {per} a "
            f"forward), plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), {flops / 1e9:.2f} GFLOP, "
            f"{moved / 1e6:.1f} MB")
        if name == "fused_window_attention_block_ws16":  # the yardstick on the weights the blob holds
            c, heads, ws = HAT_MAIN["embed_dim"], HAT_MAIN["num_heads"][0], HAT_MAIN["window_size"]
            wqkv, wproj, bias = unpack_window_attention(ops[3], c, heads, ws)
            dense = (ops[0], ops[1], ops[2], wqkv, ops[4], wproj, ops[6], bias)
            yardstick_report(name, dense, ms, bms, dict(heads=heads, window_size=ws, shift=int(label.split()[-1])))
        elif name == "fused_mlp_block_extra":
            w1, w2 = ((ops[3], ops[5]) if ops[5] is not None
                      else unpack_mlp_block(ops[3], ops[0].shape[-1], ops[4].numel()))  # the blob's weights
            yardstick_report(name, (*ops[:3], w1, ops[4], w2, ops[6]), ms, bms, dict(extra=ops[7], extra_scale=ops[8]))
    # B2 and B3 at HAT's shapes (their rows in the JSON line are SwinIR's)
    prep = model.serving_prep()
    gen = torch.Generator(device="cpu").manual_seed(SEED + 6)
    feats = torch.randn(1, LR, LR, HAT_MAIN["embed_dim"], generator=gen).to(dev, torch.bfloat16)
    x64 = torch.randn(1, LR, LR, 64, generator=gen).to(dev, torch.bfloat16)
    for name, fn, per in (("fused_conv3x3", lambda: fused_conv3x3(feats, *prep["convs"][0], extra=feats), 7),
                          ("fused_upsample_x4", lambda: fused_upsample_x4(x64, *prep["tail"]), 1)):
        ms = time_ms(fn, iters=10)
        kernel_total += per * ms
        log(f"time {name} at HAT's shapes bf16: {ms:.3f} ms ({100 * per * ms / fwd:.1f} % of a forward at {per} "
            f"a forward)")
    log(f"hat forward: kernels {kernel_total:.1f} ms, the rest (conv_first, gate, LayerNorms, "
        f"conv_before_upsample, gaps) {fwd - kernel_total:.1f} ms")
    return rows

# -- HAT training phases ------------------------------------------------------------


def hat_train_kernel_cases(model: HAT, dev: torch.device, dtype: torch.dtype, batch: int):
    """(name, label, kernel fn, plain fn, operands) of HAT training's kernels
    that SwinIR's path does not run, at its shapes: B5 at window 16 with
    drop-path and B9 on (batch, 64, 64, 180) maps with group 0's block 0
    (shift 0) and block 1 (shift 8) weights, drop-path scales (0, 1/0.9,
    ...) and a seeded cotangent; B12 and B13 on the OCAB's (16 batch
    windows, 6 heads, 256 | 576 tokens, d 30) transposed views, on 37
    windows (not a whole number of B13's window groups) and at the trained
    fixtures' geometry (64 | 144 tokens, 2 heads, d 16), with logits of a
    few units, so that the row max matters."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 9)
    c, heads, ws = HAT_MAIN["embed_dim"], HAT_MAIN["num_heads"][0], HAT_MAIN["window_size"]

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    x = randn(batch, TRAIN_CROP, TRAIN_CROP, c)
    g = randn(batch, TRAIN_CROP, TRAIN_CROP, c, scale=1e-3)
    dp = torch.full((batch,), 1 / 0.9, device=dev)
    dp[0] = 0.0
    w = lambda t: t.detach().t().to(dtype).contiguous()  # noqa: E731
    f = lambda t: t.detach().float().contiguous()  # noqa: E731
    cases = []
    for shift in (0, ws // 2):
        blk = model.module.layers[0].residual_group.blocks[1 if shift else 0]
        a = blk.attn
        # the gathered bias in the path's dtype, as the bf16 step gathers it from its bf16 table
        bias = gather_rel_bias(f(a.relative_position_bias_table), relative_position_index(ws), heads).to(dtype)
        attn_ops = (f(blk.norm1.weight), f(blk.norm1.bias), w(a.qkv.weight), f(a.qkv.bias), w(a.proj.weight),
                    f(a.proj.bias), bias)
        kw = dict(heads=heads, window_size=ws, shift=shift, drop_path=dp)
        label = f"shift {shift}"
        cases.append(("fused_window_attention_block_ws16", label,
                      lambda *o, kw=kw: fused_window_attention_block(*o, **kw),
                      lambda *o, kw=kw: window_attention_plain(*o, **kw), (x, *attn_ops)))
        cases.append(("attention_bwd_ws16", label, lambda *o, kw=kw: attention_bwd(*o, **kw),
                      lambda *o, kw=kw: attention_bwd_plain(*o, **kw), (x, g, *attn_ops)))
    owin, _ = overlap_window(ws, HAT_MAIN["overlap_ratio"])
    bw = batch * (TRAIN_CROP // ws) ** 2
    for label, bw, nq, nk, hh, d in (("path", bw, ws * ws, owin * owin, heads, c // heads),
                                     ("odd bw", 37, ws * ws, owin * owin, heads, c // heads),
                                     ("fixture", bw, 64, 144, 2, 16)):
        def view(n, scale, bw=bw, hh=hh, d=d):  # (bw, hh, n, d) over (bw, n, hh, d) storage, as the OCAB's views
            return randn(bw, n, hh, d, scale=scale).transpose(1, 2)

        q, k, v, go = view(nq, 2 * d**-0.5), view(nk, 1.0), view(nk, 1.0), view(nq, 1.0)
        bias = (torch.randn(hh, nq, nk, generator=gen) * 2.0).to(dev)
        cases.append(("oca_core_fwd", label, oca_core_fwd, oca_core_plain, (q, k, v, bias)))
        cases.append(("oca_core_bwd", label, oca_core_bwd, oca_core_bwd_plain, (q, k, v, bias, go)))
    return cases


def phase_hat_train(dev: torch.device):
    """Trainer.run on HAT for HAT_TRAIN_STEPS steps at the recipe: the
    trainer's defaults on the card (bf16, fused_train), launch counts per
    step (every launch of the run, nothing else), finite losses, moved
    weights."""
    shutil.rmtree(HAT_TRAIN_DIR, ignore_errors=True)
    losses: list = []
    model = HAT.build(**HAT_TRAIN_MODEL, seed=SEED, device=dev)
    trainer = _trainer(dev, SEED, losses, model=model, steps=HAT_TRAIN_STEPS, eval_interval=HAT_TRAIN_STEPS + 1,
                       ckpt_path=HAT_TRAIN_DIR)
    before = {k: p.detach().clone() for k, p in model.module.named_parameters()}
    engagement.reset()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = engagement.counters()
    steps = HAT_TRAIN_STEPS
    values = [float(v) for v in losses]
    log(f"\nhat trained {steps} steps in {seconds:.3f} s (host clock, first steps included); bf16 "
        f"{trainer.bfloat16}, fused_train {trainer.fused_train}; launches {launches}")
    log(f"hat losses {[round(v, 6) for v in values]}")
    failed = []
    if not (trainer.bfloat16 and trainer.fused_train):
        failed.append("the trainer did not default to bf16 and fused_train for HAT on the card")
    for name in set(launches) | set(HAT_PER_STEP):
        if launches.get(name, 0) != HAT_PER_STEP.get(name, 0) * steps:
            failed.append(f"{name}: {launches.get(name, 0)} launches in {steps} steps, expected "
                          f"{HAT_PER_STEP.get(name, 0)} a step")
    if len(values) != steps or not all(np.isfinite(values)):
        failed.append(f"hat losses {values}")
    failed += train_entry_failures("hat trainer", launches, torch.bfloat16)
    moved = sum(not torch.equal(p.detach(), before[k]) for k, p in model.module.named_parameters())
    if moved != len(before):
        failed.append(f"only {moved} of {len(before)} HAT parameters changed")
    shutil.rmtree(HAT_TRAIN_DIR, ignore_errors=True)
    if failed:
        raise AssertionError("; ".join(failed))
    return model, launches, steps


def oca_bounds(name: str, ops) -> tuple:
    """(flops, bytes) of one B12 / B13 launch: each input read once, each
    output written once (B13's d bias in f32)."""
    q, k, v, bias = ops[:4]
    bw, heads, nq, d = q.shape
    units = bw * heads * nq * k.shape[2] * d
    if name == "oca_core_fwd":
        return 4 * units, nbytes(q, k, v, bias) + nbytes(q)
    return 10 * units, nbytes(*ops) + nbytes(q, k, v) + 4 * bias.numel()


def sdpa_ms(name: str, ops):
    """The library yardstick of B12 and B13 (timed here, never called by the
    port): ``F.scaled_dot_product_attention`` with the bias as its additive
    mask; for B13 its backward, as (forward + backward) - forward, with the
    mask's gradient. None, with the reason logged, where no backend returns
    that gradient."""
    q, k, v, bias = ops[:4]
    mask = bias.to(q.dtype)
    fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0), iters=10)
    if name == "oca_core_fwd":
        return fwd
    leaves = [t.detach().requires_grad_() for t in (q, k, v, mask)]

    def both():
        out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=1.0)
        torch.autograd.grad(out, leaves, ops[4])

    try:
        return time_ms(both, iters=5) - fwd
    except RuntimeError as e:
        log(f"library for oca_core_bwd: none ({str(e).splitlines()[0]})")
        return None


def phase_hat_train_timing(model: HAT, dev: torch.device, errors: dict, launches: dict, steps: int,
                           swinir_rows: list) -> list:
    """HAT step ms, images/s and peak memory over 5 steps after 2 warm-up
    steps; B5 at window 16, B9, B12 and B13 at batch 32 (B6 and B7 run at
    the shapes SwinIR's step times them at)."""
    module = model.module
    module.fused_train = True
    tx = build_optimizer()
    state = prepare_state(module, tx)
    step = make_train_step(module, tx, l1_loss, bfloat16=True)
    lq, gt = _unit_batch(dev, TRAIN_BATCH, SEED + 4)
    gen = torch.Generator().manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(state, lq, gt, gen), iters=5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    module.fused_train = False
    del state, tx
    torch.cuda.empty_cache()
    log(f"hat train step bf16 batch {TRAIN_BATCH} {TRAIN_CROP}x{TRAIN_CROP}: {step_ms:.3f} ms, "
        f"{TRAIN_BATCH / (step_ms / 1e3):.1f} images/s, peak memory {peak:.2f} GiB")

    known = {r["name"]: r["ms"] for r in swinir_rows}
    kernel_total = sum(HAT_PER_STEP[n] * known[n] for n in ("fused_mlp_block", "mlp_bwd"))
    rows = []
    for name, label, kernel, plain, ops in hat_train_kernel_cases(model, dev, torch.bfloat16, TRAIN_BATCH):
        if label in ("shift 0", "fixture", "odd bw"):
            continue  # timed at shift 8 and at the path's geometry
        ms = time_ms(lambda: kernel(*ops), iters=10)
        plain_ms = time_ms(lambda: plain(*ops), iters=3, warmup=1)
        library_ms = None
        if name == "fused_window_attention_block_ws16":
            flops, moved = hat_bounds(name, ops)
        elif name == "attention_bwd_ws16":
            flops, moved = train_bounds(name, ops)
        else:
            flops, moved = oca_bounds(name, ops)
            library_ms = sdpa_ms(name, ops)
        bms, by = bound_ms(flops, moved)
        per = HAT_PER_STEP[name]
        kernel_total += per * ms
        log(f"time {name} [{label}] bf16 batch {TRAIN_BATCH}: {ms:.3f} ms ({100 * per * ms / step_ms:.1f} % of a "
            f"HAT step at {per} a step), plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), library "
            f"{library_ms if library_ms is None else round(library_ms, 4)} ms, {flops / 1e9:.2f} GFLOP, "
            f"{moved / 1e6:.1f} MB; launches {launches.get(name, 0)} in {steps} steps")
        if name == "fused_window_attention_block_ws16":
            continue  # its row is HAT serving's
        if name == "attention_bwd_ws16":
            yardstick_report(name, ops, ms, bms, kw_of(label, HAT_MAIN["window_size"], TRAIN_BATCH, dev))
        elif name == "oca_core_bwd":
            yardstick_report(name, ops, ms, bms, {})
        source, replaces = KERNELS[name]
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches.get(name, 0),
                         max_abs_err=errors[name], ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=library_ms))
    log(f"hat train step: kernels {kernel_total:.1f} ms (B6, B7 at SwinIR's step times), the rest (CAB convs, "
        f"OCAB projections and MLP, LayerNorms, tail, loss, optimizer, gaps) {step_ms - kernel_total:.1f} ms")
    return rows


# -- x2 / x3 serving phases (B4) ------------------------------------------------


def b4_cases(dev: torch.device, dtype: torch.dtype, s: int):
    """(label, operands) of B4 at SwinIR's, HAT's and a ragged shape, with
    seeded weights laid out for ``dtype``."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 7 + s)
    cases = []
    for shape in B4_SHAPES:
        cin = shape[-1]
        ops = (torch.randn(*shape, generator=gen).to(dev, dtype),
               (torch.randn(3, 3, cin, s * s * cin, generator=gen) * (9 * cin) ** -0.5).to(dev, dtype),
               (torch.randn(s * s * cin, generator=gen) * 0.1).to(dev),
               (torch.randn(3, 3, cin, 3, generator=gen) * (9 * cin) ** -0.5).to(dev, dtype),
               (torch.randn(3, generator=gen) * 0.1).to(dev))
        cases.append(("x".join(map(str, shape)), ops))
    return cases


def phase_b4_kernels(dev: torch.device) -> dict:
    """B4 against its plain version at s = 2, 3, f32 then bf16. Returns the
    bf16 max abs error at SwinIR's shape for each s."""
    errors, failed = {}, []
    for s in SCALES_S:
        for dtype in (torch.float32, torch.bfloat16):
            entry = "upsample_s_mma_bf16" if dtype == torch.bfloat16 else "upsample_s_f32"
            for label, ops in b4_cases(dev, dtype, s):
                engagement.reset()
                got = fused_upsample_s(*ops, s)
                torch.cuda.synchronize()
                if engagement.entries() != {"fused_upsample_s": {entry: 1}}:
                    failed.append(f"B4 x{s} {label} took {engagement.entries()}")
                want = upsample_s_plain(*[t.float() for t in ops], s)
                torch.cuda.synchronize()
                err = kernel_check(f"fused_upsample_s x{s} [{label}]", got, want, dtype, failed)
                if dtype == torch.bfloat16 and label == B4_LABEL:
                    errors[s] = err
                del got, want
    if failed:
        raise AssertionError("B4 disagrees with its plain version: " + "; ".join(failed))
    return errors


B4_LABEL = "x".join(map(str, B4_SHAPES[0]))


def b4_bounds(ops, s: int) -> tuple:
    """(flops, bytes) of one B4 launch: each input read once, the output
    written once."""
    x, _, b0, _, b2 = ops
    pix, cin, n_colors = x.numel() // x.shape[-1], x.shape[-1], b2.shape[0]
    flops = 2 * pix * 9 * cin * b0.shape[0] + 2 * s * s * pix * 9 * cin * n_colors
    return flops, nbytes(x, *hwio_tail(ops[1:], cin, s)) + s * s * pix * n_colors * x.element_size()


def s_model(name: str, s: int, dev: torch.device):
    if name == "swinir":
        return SwinIR.build(**{**MAIN, "scale": s}, seed=SEED, device=dev)
    return HAT.build(**{**HAT_MAIN, "scale": s}, seed=SEED, device=dev)


def phase_scale_serving(name: str, s: int, dev: torch.device) -> tuple:
    """Full-width ``name`` at x``s``: fused vs plain (f32, then bf16 against
    f32 plain), three requests with launch counts, the forward's time, and
    B4's time at this model's tail shape. Returns (launches, forward ms,
    {B4 ms, plain ms, bound ms, bound by, flops, bytes})."""
    model = s_model(name, s, dev)
    images = requests()
    x = torch.from_numpy(images[0]).to(dev).float()[None] / 255.0
    plain = model.enable_fused(False)(x)
    fused = model.enable_fused(True)(x)
    torch.cuda.synchronize()
    rel32 = rel_l2(fused, plain)
    model.half()
    fused16 = model(x)
    torch.cuda.synchronize()
    rel16 = rel_l2(fused16, plain)
    log(f"{name} x{s} e2e fused vs plain: f32 rel_l2 {rel32:.3e} limit {E2E_F32_REL_L2:.0e}; bf16 vs f32 plain "
        f"rel_l2 {rel16:.3e} limit {E2E_BF16_REL_L2:.0e}")
    failed = []
    if not rel32 <= E2E_F32_REL_L2:
        failed.append(f"{name} x{s}: f32 fused forward disagrees with the plain forward")
    if not rel16 <= E2E_BF16_REL_L2:
        failed.append(f"{name} x{s}: bf16 fused forward disagrees with the plain forward")
    if not bool(torch.isfinite(fused16).all()) or fused16.shape != (1, s * LR, s * LR, 3):
        failed.append(f"{name} x{s}: bad bf16 forward {tuple(fused16.shape)}")
    del plain, fused, fused16

    prep = model.serving_prep()  # load-time weight layout, outside the counted run
    engagement.reset()
    outs = [model.inference(im) for im in images]
    launches = engagement.counters()
    log(f"{name} x{s} served {len(outs)} requests; launches {launches}")
    for out in outs:
        if out.shape != (s * LR, s * LR, 3) or out.dtype != np.uint8:
            failed.append(f"{name} x{s}: bad output {out.shape} {out.dtype}")
    expected = S_PER_FORWARD[name]
    for k in set(launches) | set(expected):
        if launches.get(k, 0) != expected.get(k, 0) * REQUESTS:
            failed.append(f"{name} x{s} {k}: {launches.get(k, 0)} launches, expected {expected.get(k, 0)} a forward")
    failed += entry_failures(f"{name} x{s} serving", launches)
    if failed:
        raise AssertionError("; ".join(failed))

    fwd = time_ms(lambda: model(x), iters=5)
    log(f"{name} x{s} forward bf16 batch 1 {LR}x{LR}: {fwd:.3f} ms, {LR * LR / 1e6 / (fwd / 1e3):.3f} LR MP/s")
    hp = LR + (MAIN["window_size"] if name == "swinir" else 0)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 8)
    ops = (torch.randn(1, hp, hp, 64, generator=gen).to(dev, torch.bfloat16), *prep["tail"])
    ms = time_ms(lambda: fused_upsample_s(*ops, s), iters=10)
    plain_ms = time_ms(lambda: upsample_s_plain(*ops, s), iters=10)
    flops, moved = b4_bounds(ops, s)
    bms, by = bound_ms(flops, moved)
    seq = sequence_weights(ops[1:], 64, s, torch.bfloat16)
    seq_ms = time_ms(lambda: tail_sequence(ops[0], seq, s), iters=10)
    log(f"time fused_upsample_s x{s} at {name}'s {hp}x{hp}x64 bf16: {ms:.3f} ms ({100 * ms / fwd:.1f} % of the "
        f"forward), plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), {flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB; "
        f"yardstick (a sequence of bf16 PyTorch calls: channels-last F.conv2d x2 + F.pixel_shuffle) {seq_ms:.3f} ms; "
        f"{ptxas_report('fused_upsample_s')}")
    del model
    return launches, fwd, dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def phase_x2_x3(dev: torch.device, b4_errors: dict) -> list:
    """Phase 18 over SwinIR and HAT at x2 and x3; B4's JSON rows (SwinIR's
    tail shape, the main path's) with the launches of all four runs."""
    rows = []
    for s in SCALES_S:
        launches, timed = 0, {}
        for name in ("swinir", "hat"):
            counts, _, timed[name] = phase_scale_serving(name, s, dev)
            launches += counts.get("fused_upsample_s", 0)
            torch.cuda.empty_cache()
        t = timed["swinir"]
        source, replaces = KERNELS["fused_upsample_s"]
        rows.append(dict(name=f"fused_upsample_s_x{s}", route="cuda", source=source, replaces=replaces,
                         launches=launches, max_abs_err=b4_errors[s], ms=t["ms"], plain_ms=t["plain_ms"],
                         bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None))
    return rows


# -- SwinFIR (B14) ------------------------------------------------------------------


def resblock_ops(dev: torch.device, dtype: torch.dtype, shape, seed: int):
    """(x, w1, b1, w2, b2) of B14: HWIO weights in ``dtype``, f32 biases
    (b1 large enough that act(b1) in the padding matters)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    c = shape[-1]
    return (torch.randn(*shape, generator=gen).to(dev, dtype),
            (torch.randn(3, 3, c, c, generator=gen) * (9 * c) ** -0.5).to(dev, dtype),
            (torch.randn(c, generator=gen) * 0.5).to(dev),
            (torch.randn(3, 3, c, c, generator=gen) * (9 * c) ** -0.5).to(dev, dtype),
            (torch.randn(c, generator=gen) * 0.1).to(dev))


def phase_resblock_kernels(dev: torch.device) -> float:
    """B14 against its plain version, f32 then bf16, at SwinFIR's map (the
    path's LeakyReLU 0.2 / res_scale 1, and ReLU / 0.1) and at a ragged odd
    height (every activation and scale). Returns the bf16 max abs error at
    the path's variant."""
    failed, error = [], None
    for dtype in (torch.float32, torch.bfloat16):
        for si, shape in enumerate(RESBLOCK_SHAPES):
            for activation, res_scale in RESBLOCK_VARIANTS[: 2 if si == 0 else 4]:
                ops = resblock_ops(dev, dtype, shape, SEED + 20 + si)
                got = fused_resblock(*ops, res_scale=res_scale, activation=activation)
                torch.cuda.synchronize()
                want = resblock_plain(*[t.float() for t in ops], res_scale=res_scale, activation=activation)
                part = f"fused_resblock [{'x'.join(map(str, shape))} {activation} res_scale {res_scale}]"
                err = kernel_check(part, got, want, dtype, failed)
                if dtype == torch.bfloat16 and si == 0 and res_scale == 1.0:
                    error = err
                del got, want
    if failed:
        raise AssertionError("B14 disagrees with its plain version: " + "; ".join(failed))
    return error


def phase_swinfir_serving(dev: torch.device, error: float) -> tuple:
    """SwinFIR x4 at full width: fused vs plain (f32, bf16 against f32
    plain), uint8 fused vs plain in f32, three bf16 requests with their
    launch counts, the forward's time and B14's time at the path's shapes.
    Returns (B14's JSON row, forward ms)."""
    model = SwinFIR.build(**MAIN, seed=SEED, device=dev)
    log(f"\nmodel: SwinFIR x4 embed {MAIN['embed_dim']} depths {MAIN['depths']}, {model.count_parameters()} parameters")
    images = requests()
    x = torch.from_numpy(images[0]).to(dev).float()[None] / 255.0
    plain = model.enable_fused(False)(x)
    plain8 = model.inference(images[0])
    fused = model.enable_fused(True)(x)
    fused8 = model.inference(images[0])
    torch.cuda.synchronize()
    rel32 = rel_l2(fused, plain)
    diff = np.abs(fused8.astype(int) - plain8.astype(int))
    model.half()
    fused16 = model(x)
    torch.cuda.synchronize()
    rel16 = rel_l2(fused16, plain)
    log(f"swinfir e2e fused vs plain: f32 rel_l2 {rel32:.3e} limit {E2E_F32_REL_L2:.0e}; uint8 f32 max diff "
        f"{diff.max()} LSB on {100 * (diff > 0).mean():.4f} % of values; bf16 vs f32 plain rel_l2 {rel16:.3e} limit "
        f"{E2E_BF16_REL_L2:.0e}")
    failed = []
    if not rel32 <= E2E_F32_REL_L2:
        failed.append("f32 fused SwinFIR forward disagrees with the plain forward")
    if not (diff.max() <= 1 and (diff > 0).mean() < 0.01):
        failed.append("uint8 fused SwinFIR output differs from the plain one by more than 1 LSB")
    if not rel16 <= E2E_BF16_REL_L2:
        failed.append("bf16 fused SwinFIR forward disagrees with the plain forward")
    if not bool(torch.isfinite(fused16).all()) or fused16.shape != (1, 4 * LR, 4 * LR, 3):
        failed.append(f"bad bf16 SwinFIR forward {tuple(fused16.shape)}")
    del plain, fused, fused16

    prep = model.serving_prep()  # load-time weight layout, outside the counted run
    engagement.reset()
    outs = [model.inference(im) for im in images]
    launches = engagement.counters()
    log(f"swinfir served {len(outs)} requests; launches {launches}")
    for out in outs:
        if out.shape != (4 * LR, 4 * LR, 3) or out.dtype != np.uint8:
            failed.append(f"bad SwinFIR output {out.shape} {out.dtype}")
    for name in set(launches) | set(SWINFIR_PER_FORWARD):
        if launches.get(name, 0) != SWINFIR_PER_FORWARD.get(name, 0) * REQUESTS:
            failed.append(f"swinfir {name}: {launches.get(name, 0)} launches, expected "
                          f"{SWINFIR_PER_FORWARD.get(name, 0)} a forward")
    failed += entry_failures("swinfir serving", launches)
    if failed:
        raise AssertionError("; ".join(failed))

    fwd = time_ms(lambda: model(x), iters=5)
    log(f"swinfir forward bf16 batch 1 {LR}x{LR}: {fwd:.3f} ms, {LR * LR / 1e6 / (fwd / 1e3):.3f} LR MP/s")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 21)
    p = prep["convs"][0]
    ops = (torch.randn(*RESBLOCK_SHAPES[0], generator=gen).to(dev, torch.bfloat16), p["s0"], p["b0"], p["s2"], p["b2"])
    xb, w1, b1, w2, b2 = ops
    ms = time_ms(lambda: fused_resblock(*ops, activation="lrelu0.2"), iters=10)
    plain_ms = time_ms(lambda: resblock_plain(*ops, activation="lrelu0.2"), iters=10)
    c = xb.shape[-1]
    w1o, w2o = (unpack_conv3x3_weights(w, c, c).permute(3, 2, 0, 1).contiguous() for w in (w1, w2))  # HWIO -> OIHW
    b1l, b2l = b1.to(xb.dtype), b2.to(xb.dtype)

    def library():
        xc = xb.permute(0, 3, 1, 2)
        h1 = F.leaky_relu(F.conv2d(xc, w1o, b1l, padding=1), 0.2)
        return xb + F.conv2d(h1, w2o, b2l, padding=1).permute(0, 2, 3, 1)

    library_ms = time_ms(library, iters=10)
    tokens = xb.numel() // c
    flops = 2 * 2 * tokens * 9 * c * c
    moved = 2 * nbytes(xb) + nbytes(w1o, b1, w2o, b2)
    bms, by = bound_ms(flops, moved)
    per = SWINFIR_PER_FORWARD["fused_resblock"]
    shape = "x".join(map(str, xb.shape))
    log(f"time fused_resblock [lrelu0.2] bf16 at {shape}: {ms:.3f} ms ({100 * per * ms / fwd:.1f} "
        f"% of a forward at {per} a forward), plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), library (cuDNN "
        f"F.conv2d x2 + leaky_relu + add) {library_ms:.4f} ms, {flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB")
    log(f"  fused_resblock: kernel / library {ms / library_ms:.2f}, {100 * bms / ms:.1f} % of the bound; "
        f"{ptxas_report('fused_resblock')}")
    source, replaces = KERNELS["fused_resblock"]
    row = dict(name="fused_resblock", route="cuda", source=source, replaces=replaces,
               launches=launches.get("fused_resblock", 0), max_abs_err=error, ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, library_ms=library_ms)
    del model
    torch.cuda.empty_cache()
    return row, fwd


def phase_swinfir_grads(dev: torch.device) -> None:
    """The fused-train SwinFIR's loss and every gradient in f32 at batch 4
    against an f64 witness and against plain autograd in f32, the SFBs'
    LeakyReLU kinks pinned to the witness's side, with B5-B8's launch
    counts on the fused run."""
    model = SwinFIR.build(**TRAIN_MODEL, seed=SEED, device=dev)
    runs = train_grads(model, dev, SEED, SWINFIR_GRAD_RUNS)
    del model
    report = grad_report(runs, SEED, "swinfir ")
    failed = []
    for (path, dtype), (_, grads, launches, _) in runs.items():
        expected = PER_STEP if path == "fused" else {}
        if any(launches.get(k, 0) != expected.get(k, 0) for k in set(launches) | set(expected)):
            failed.append(f"swinfir {path} {dtype}: launches {launches}, expected {expected}")
        if not all(torch.isfinite(g).all() for g in grads.values()):
            failed.append(f"swinfir {path} {dtype}: non-finite gradients")
    for key, label in ((("fused", torch.float32), "the f64 witness"), (("fused-vs-plain", torch.float32),
                                                                        "plain autograd in f32")):
        r = report[key]
        worst = max(r["params"].values())
        log(f"swinfir grads held: fused f32 vs {label}: loss rel {r['loss']:.3e}, all gradients {r['all']:.3e}, "
            f"worst parameter {worst:.3e} <= {GRAD_F32_REL_L2:.0e}")
        if max(r["loss"], r["all"], worst) > GRAD_F32_REL_L2:
            failed.append(f"swinfir f32 fused gradients disagree with {label}")
    if failed:
        raise AssertionError("; ".join(failed))


def phase_swinfir_train(dev: torch.device) -> None:
    """``Trainer.run`` on SwinFIR for 3 steps at its recipe (batch 32, f32,
    fused_train by default on the card), then 7 steps of one batch timed
    (the last 5): launch counts, finite losses that fall over the trainer's
    steps, moved weights, step ms, images/s, peak memory."""
    shutil.rmtree(SWINFIR_TRAIN_DIR, ignore_errors=True)
    model = SwinFIR.build(**TRAIN_MODEL, seed=SEED, device=dev)
    recipe = model.get_training_config()
    losses: list = []

    def criterion(pred, target):
        loss = l1_loss(pred, target)
        losses.append(loss.detach())
        return loss

    trainer = Trainer(model, MemoryPairs(SEED), **{**recipe, "max_iters": SWINFIR_TRAIN_STEPS}, num_workers=4,
                      eval_interval=SWINFIR_TRAIN_STEPS + 1, ckpt_path=str(SWINFIR_TRAIN_DIR), seed=SEED,
                      log_interval=100, loss_function=criterion)
    before = {k: p.detach().clone() for k, p in model.module.named_parameters()}
    engagement.reset()
    trainer.run()
    torch.cuda.synchronize()
    launches = engagement.counters()
    steps = SWINFIR_TRAIN_STEPS
    values = [float(v) for v in losses]
    log(f"\nswinfir trained {steps} steps at its recipe (batch {recipe['batch_size']}, bf16 {trainer.bfloat16}, "
        f"fused_train {trainer.fused_train}); launches {launches}; losses {[round(v, 6) for v in values]}")
    failed = []
    if trainer.bfloat16 or not trainer.fused_train or recipe["batch_size"] != TRAIN_BATCH:
        failed.append("the trainer did not take SwinFIR's f32 recipe with fused_train on the card")
    failed += train_entry_failures("swinfir trainer", launches, torch.float32)
    for name in set(launches) | set(PER_STEP):
        if launches.get(name, 0) != PER_STEP.get(name, 0) * steps:
            failed.append(f"swinfir {name}: {launches.get(name, 0)} launches in {steps} steps, expected "
                          f"{PER_STEP.get(name, 0)} a step")
    if len(values) != steps or not all(np.isfinite(values)) or not values[-1] < values[0]:
        failed.append(f"swinfir losses {values}: not finite and falling")
    moved = sum(not torch.equal(p.detach(), before[k]) for k, p in model.module.named_parameters())
    if moved != len(before):
        failed.append(f"only {moved} of {len(before)} SwinFIR parameters changed")
    shutil.rmtree(SWINFIR_TRAIN_DIR, ignore_errors=True)

    module = model.module
    module.fused_train = True
    tx = build_optimizer(**{k: recipe[k] for k in ("learning_rate", "beta1", "beta2", "weight_decay", "milestones",
                                                   "gamma")})
    state = prepare_state(module, tx)
    timed: list = []

    def timed_loss(pred, target):
        loss = l1_loss(pred, target)
        timed.append(loss.detach())
        return loss

    step = make_train_step(module, tx, timed_loss, bfloat16=False)
    lq, gt = _unit_batch(dev, TRAIN_BATCH, SEED + 4)
    gen = torch.Generator().manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(state, lq, gt, gen), iters=5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    module.fused_train = False
    timed = [float(v) for v in timed]
    log(f"swinfir train step f32 batch {TRAIN_BATCH} {TRAIN_CROP}x{TRAIN_CROP}: {step_ms:.3f} ms, "
        f"{TRAIN_BATCH / (step_ms / 1e3):.1f} images/s, peak memory {peak:.2f} GiB; one batch's loss over "
        f"{len(timed)} steps {[round(v, 6) for v in timed]}")
    if not all(np.isfinite(timed)):
        failed.append(f"swinfir timed losses {timed}")
    del state, tx, model, trainer
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))


# -- MaxSR (B15) ---------------------------------------------------------------------


def window_attn_ops(dev: torch.device, dtype: torch.dtype, case, seed: int):
    """(q, k, v, bias, mask) of one B15 case: q, k, v the strided slices of
    one (windows, N, 3, heads, d) projection, as MaxSR's attention hands
    them (q scaled, so a fresh tensor); a bias gathered from a (2 ws - 1)^2
    table (or None), a 0 / -100 mask (or None)."""
    _, bw, heads, n, d, with_bias, nw = case
    gen = torch.Generator(device="cpu").manual_seed(seed)
    qkv = torch.randn(bw, n, 3, heads, d, generator=gen).to(dev, dtype).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * (2 * d**-0.5), qkv[1], qkv[2]
    bias = mask = None
    if with_bias:
        ws = int(round(n**0.5))
        if ws * ws == n:
            table = torch.randn((2 * ws - 1) ** 2, heads, generator=gen)
            bias = gather_rel_bias(table, relative_position_index(ws), heads).contiguous().to(dev)
        else:
            bias = torch.randn(heads, n, n, generator=gen).to(dev)
    if nw:
        mask = torch.where(torch.rand(nw, n, n, generator=gen) > 0.7, -100.0, 0.0).to(dev)
    return q, k, v, bias, mask


def window_attn_bounds(q, k, v, bias, mask) -> tuple:
    """(flops, bytes) of one B15 launch: q, k, v, bias and mask read once,
    the output written once."""
    bw, heads, n, d = q.shape
    return 4 * bw * heads * n * k.shape[2] * d, nbytes(q, k, v, bias, mask) + nbytes(q)


def phase_window_attn_kernels(dev: torch.device) -> tuple:
    """B15 against its plain version, f32 then bf16, over WINDOW_ATTN_CASES;
    N 1089 must raise. Then ms, plain ms, bound and SDPA ms at the two MaxSR
    shapes. Returns ({label: timing}, bf16 max abs error at the adaptive
    shape)."""
    failed, error = [], None
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(WINDOW_ATTN_CASES):
            q, k, v, bias, mask = window_attn_ops(dev, dtype, case, SEED + 30 + i)
            got = window_attention(q, k, v, bias=bias, mask=mask)
            torch.cuda.synchronize()
            want = attention_plain(q.float(), k.float(), v.float(), bias, mask)
            _, bw, heads, n, d, _, nw = case
            part = f"window_attention [{case[0]}: {bw} windows, {heads} heads, N {n}, d {d}" + (
                f", mask of {nw} windows]" if nw else "]")
            err = kernel_check(part, got, want, dtype, failed)
            if dtype == torch.bfloat16 and case[0] == "adaptive":
                error = err
            del got, want, q, k, v
    try:
        z = torch.zeros(1, 1, 1089, 16, device=dev, dtype=torch.bfloat16)
        window_attention(z, z, z)
        failed.append("window_attention took N 1089")
    except NotImplementedError as e:
        log(f"check window_attention N 1089: raises ({e})")
    if failed:
        raise AssertionError("B15 disagrees with its plain version: " + "; ".join(failed))

    timing = {}
    for i, case in enumerate(WINDOW_ATTN_CASES[:2]):
        q, k, v, bias, mask = ops = window_attn_ops(dev, torch.bfloat16, case, SEED + 30 + i)
        ms = time_ms(lambda: window_attention(q, k, v, bias=bias), iters=10)
        plain_ms = time_ms(lambda: attention_plain(q, k, v, bias), iters=5)
        attn_mask = None if bias is None else bias.to(q.dtype)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, scale=1.0), iters=10)
        flops, moved = window_attn_bounds(*ops)
        bms, by = bound_ms(flops, moved)
        timing[case[0]] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)
        log(f"time window_attention [{case[0]}] bf16 ({case[1]} windows, N {case[3]}): {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), library (F.scaled_dot_product_attention"
            f"{'' if bias is None else ', bias as mask'}) {library_ms:.4f} ms, {flops / 1e9:.2f} GFLOP, "
            f"{moved / 1e6:.1f} MB; kernel / library {ms / library_ms:.2f}, {100 * bms / ms:.1f} % of the bound")
        del q, k, v, ops
    log(f"  window_attention_pallas: {ptxas_report('window_attention_pallas')}")
    return timing, error


def phase_maxsr_serving(dev: torch.device, adaptive: bool) -> tuple:
    """MaxSR x4 at full width in one mode: fused vs plain (f32, bf16 against
    f32 plain), three bf16 requests with 32 B15 launches a forward and
    nothing else, the forward's time. Returns (launches, forward ms)."""
    mode = "adaptive" if adaptive else "static"
    model = MaxSR.build(**{**MAXSR_MAIN, "adaptive": adaptive}, seed=SEED, device=dev)
    log(f"\nmodel: MaxSR x4 {mode} dim {MAXSR_MAIN['dim']} depth {MAXSR_MAIN['depth']}, "
        f"{model.count_parameters()} parameters")
    images = requests()
    x = torch.from_numpy(images[0]).to(dev).float()[None] / 255.0
    plain = model.enable_fused(False)(x)
    fused = model.enable_fused(True)(x)
    torch.cuda.synchronize()
    rel32 = rel_l2(fused, plain)
    model.half()
    fused16 = model(x)
    torch.cuda.synchronize()
    rel16 = rel_l2(fused16, plain)
    log(f"maxsr {mode} e2e fused vs plain: f32 rel_l2 {rel32:.3e} limit {E2E_F32_REL_L2:.0e}; bf16 vs f32 plain "
        f"rel_l2 {rel16:.3e} limit {E2E_BF16_REL_L2:.0e}")
    failed = []
    if not rel32 <= E2E_F32_REL_L2:
        failed.append(f"maxsr {mode}: f32 fused forward disagrees with the plain forward")
    if not rel16 <= E2E_BF16_REL_L2:
        failed.append(f"maxsr {mode}: bf16 fused forward disagrees with the plain forward")
    if not bool(torch.isfinite(fused16).all()) or fused16.shape != (1, 4 * LR, 4 * LR, 3):
        failed.append(f"maxsr {mode}: bad bf16 forward {tuple(fused16.shape)}")
    del plain, fused, fused16
    engagement.reset()
    outs = [model.inference(im) for im in images]
    launches = engagement.counters()
    log(f"maxsr {mode} served {len(outs)} requests; launches {launches}")
    for out in outs:
        if out.shape != (4 * LR, 4 * LR, 3) or out.dtype != np.uint8:
            failed.append(f"maxsr {mode}: bad output {out.shape} {out.dtype}")
    for name in set(launches) | set(MAXSR_PER_FORWARD):
        if launches.get(name, 0) != MAXSR_PER_FORWARD.get(name, 0) * REQUESTS:
            failed.append(f"maxsr {mode} {name}: {launches.get(name, 0)} launches, expected "
                          f"{MAXSR_PER_FORWARD.get(name, 0)} a forward")
    failed += entry_failures(f"maxsr {mode} serving", launches)
    if failed:
        raise AssertionError("; ".join(failed))
    fwd = time_ms(lambda: model(x), iters=5)
    log(f"maxsr {mode} forward bf16 batch 1 {LR}x{LR}: {fwd:.3f} ms, {LR * LR / 1e6 / (fwd / 1e3):.3f} LR MP/s")
    del model
    torch.cuda.empty_cache()
    return launches, fwd


def phase_maxsr(dev: torch.device) -> dict:
    """Phases 22-23; B15's JSON row (timed at the adaptive shape, the
    default mode), its launches those of both modes' requests."""
    timing, error = phase_window_attn_kernels(dev)
    launches, fwds = 0, {}
    for adaptive in (True, False):
        counts, fwds[adaptive] = phase_maxsr_serving(dev, adaptive)
        launches += counts.get("window_attention_pallas", 0)
    per = MAXSR_PER_FORWARD["window_attention_pallas"]
    for label, adaptive in (("adaptive", True), ("static", False)):
        log(f"maxsr {label}: B15 {per} x {timing[label]['ms']:.3f} ms = "
            f"{100 * per * timing[label]['ms'] / fwds[adaptive]:.1f} % of the forward")
    source, replaces = KERNELS["window_attention_pallas"]
    return dict(name="window_attention_pallas", route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=error, **timing["adaptive"])



# -- the user's entry points: trained checkpoints, Evaluator, CLI -----------------


def fixture_pairs(scale: int):
    """The three fixture images: (LR at ``scale``, HR mod-cropped to it),
    read with the port's PNG codec."""
    pairs = []
    for i in range(3):
        hr = imread(str(FIXTURES / f"img{i}_hr.png"))
        hr = hr[: hr.shape[0] // scale * scale, : hr.shape[1] // scale * scale]
        pairs.append((imread(str(FIXTURES / f"img{i}_lrx{scale}.png")), hr))
    return pairs


def bicubic(lr: np.ndarray, h: int, w: int, dev: torch.device) -> np.ndarray:
    x = torch.from_numpy(lr).to(dev).float().permute(2, 0, 1)[None] / 255.0
    up = F.interpolate(x, size=(h, w), mode="bicubic", align_corners=False)
    return torch.clamp(torch.round(up * 255.0), 0, 255).to(torch.uint8)[0].permute(1, 2, 0).cpu().numpy()


def maxsr_stats_restored(model) -> list:
    """[] when the MBConvs' BatchNorm running statistics came back from the
    checkpoint (not the initial mean 0 / variance 1), else the failure."""
    stats = {k: v for k, v in model.module.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    moved = [k for k, v in stats.items() if not torch.equal(v, torch.zeros_like(v) if k.endswith("mean") else
                                                         torch.ones_like(v))]
    log(f"trained maxsr_ckpt: {len(moved)} of {len(stats)} running statistics differ from their initial values")
    return [] if stats and len(moved) == len(stats) else ["maxsr_ckpt: BatchNorm running statistics not restored"]


def phase_trained(dev: torch.device) -> list:
    """The nine trained checkpoints on the card, each image against the
    floors. Returns (checkpoint, image, bicubic, plain, fused f32, fused
    bf16) PSNRs."""
    table, failed = [], []
    for subdir, name, scale in TRAINED:
        ckpt = str(FIXTURES / subdir)
        for i, (lr, hr) in enumerate(fixture_pairs(scale)):
            model = load_model(ckpt, name, device=dev)
            if name == "maxsr" and i == 0:
                failed += maxsr_stats_restored(model)
            bi = compute_psnr(bicubic(lr, *hr.shape[:2], dev), hr)
            plain = compute_psnr(model.inference(lr), hr)
            fused = compute_psnr(model.enable_fused(True).inference(lr), hr)
            engagement.reset()
            bf16 = compute_psnr(model.half().inference(lr), hr)
            failed += entry_failures(f"trained {subdir} bf16", engagement.counters())
            table.append((subdir, i, bi, plain, fused, bf16))
            log(f"trained {subdir} img{i}: bicubic {bi:.4f} plain f32 {plain:.4f} fused f32 {fused:.4f} "
                f"fused bf16 {bf16:.4f} dB")
            if not plain > bi + FLOOR_PLAIN:
                failed.append(f"{subdir} img{i}: plain {plain:.3f} vs bicubic {bi:.3f}")
            if not abs(fused - plain) < FLOOR_FUSED:
                failed.append(f"{subdir} img{i}: fused {fused:.3f} vs plain {plain:.3f}")
            if not (bf16 > bi + FLOOR_BF16 and abs(bf16 - plain) < FLOOR_BF16_VS_PLAIN):
                failed.append(f"{subdir} img{i}: bf16 {bf16:.3f} vs bicubic {bi:.3f}, plain {plain:.3f}")
    if failed:
        raise AssertionError("trained checkpoints below their floors: " + "; ".join(failed))
    return table


def phase_evaluator(dev: torch.device) -> None:
    """Evaluator2 on the host and on the card, SwinIR x2 and HAT x3, fused bf16."""
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    failed = []
    for subdir, name, scale in (("swinir_x2_ckpt", "swinir", 2), ("hat_x3_ckpt", "hat", 3)):
        root = EVAL_DIR / f"fixture_x{scale}"
        (root / "HR").mkdir(parents=True)
        (root / "LR_bicubic" / f"X{scale}").mkdir(parents=True)
        for i in range(3):  # HR not mod-cropped: at x3 the SR is 126 x 126 against a 128 x 128 GT
            imwrite(str(root / "HR" / f"img{i}.png"), imread(str(FIXTURES / f"img{i}_hr.png")))
            imwrite(str(root / "LR_bicubic" / f"X{scale}" / f"img{i}.png"),
                    imread(str(FIXTURES / f"img{i}_lrx{scale}.png")))
        model = load_model(str(FIXTURES / subdir), name, device=dev).half().enable_fused(True)
        ev = Evaluator2(root.name, scale, root=str(EVAL_DIR))
        host = ev.run(model)
        engagement.reset()
        card = ev.run(model, on_device=True)
        launches = engagement.counters()
        log(f"evaluator {subdir} fused bf16: host PSNR {host[0]:.6f} SSIM {host[1]:.6f}; on the card PSNR "
            f"{card[0]:.6f} SSIM {card[1]:.6f} (differences {card[0] - host[0]:.2e} dB, {card[1] - host[1]:.2e}); "
            f"launches {launches}")
        if not (abs(card[0] - host[0]) < EVAL_PSNR and abs(card[1] - host[1]) < EVAL_SSIM):
            failed.append(f"{subdir}: on-card scores differ from the host protocol's")
        if launches.get("fused_upsample_s", 0) != 3:
            failed.append(f"{subdir}: the on-card route did not serve through B4 ({launches})")
        failed += entry_failures(f"evaluator {subdir}", launches)
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    if failed:
        raise AssertionError("; ".join(failed))


def phase_cli(dev: torch.device) -> None:
    """``python3 -m studiosr_tpu_torch`` on the x4 checkpoint with ``--half``,
    whole and tiled, against the in-process fused bf16 route."""
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    image, ckpt = FIXTURES / "img0_lrx4.png", FIXTURES / "swinir_ckpt"
    hr = imread(str(FIXTURES / "img0_hr.png"))
    model = load_model(str(ckpt), "swinir", device=dev).half().enable_fused(True)
    lr = imread(str(image))
    want = compute_psnr(model.inference(lr), hr)
    psnrs = {}
    for label, extra in (("whole", []), ("tiled", ["--tile", "32", "--tile-overlap", "8"])):
        out = CLI_DIR / label
        cmd = [sys.executable, "-m", "studiosr_tpu_torch", "--image", str(image.relative_to(ROOT)), "--scale", "4",
               "--model", "swinir", "--ckpt", str(ckpt.relative_to(ROOT)), "--output", str(out), "--half", *extra]
        t0 = time.perf_counter()
        subprocess.run(cmd, cwd=ROOT, check=True, timeout=600, capture_output=True, text=True)
        psnrs[label] = compute_psnr(imread(str(out / "img0_lrx4.swinir_x4.png")), hr)
        log(f"cli {label} ({time.perf_counter() - t0:.1f} s, host clock): PSNR {psnrs[label]:.4f} dB")
    tiled16 = compute_psnr(model.inference_tiled(lr, tile=16, tile_overlap=4, tile_batch=4), hr)
    log(f"cli: in-process fused bf16 {want:.4f} dB; tiled in process at tile 16, overlap 4: {tiled16:.4f} dB")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    failed = []
    if not abs(psnrs["whole"] - want) < CLI_PSNR:
        failed.append(f"the CLI's {psnrs['whole']:.4f} dB differs from the in-process {want:.4f} dB")
    if not (psnrs["tiled"] > psnrs["whole"] - TILED_PSNR and tiled16 > want - TILED_PSNR):
        failed.append(f"tiled {psnrs['tiled']:.4f} / {tiled16:.4f} dB vs whole {psnrs['whole']:.4f} dB")
    if failed:
        raise AssertionError("; ".join(failed))


def main() -> int:
    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    model = SwinIR.build(**MAIN, seed=SEED, device=dev)
    log(f"model: SwinIR x4 embed {MAIN['embed_dim']} depths {MAIN['depths']}, {model.count_parameters()} parameters")
    errors = phase_kernels(model, dev)
    phase_b1_b14_checks(model, dev)
    phase_tail_checks(dev)
    launches = phase_end_to_end(model, dev)
    rows = phase_timing(model, dev, errors, launches)
    del model
    train_errors = phase_train_kernels(SwinIR.build(**TRAIN_MODEL, seed=SEED, device=dev), dev)
    phase_train_grads(dev)
    trained, train_launches, steps = phase_train(dev)
    swinir_train_rows = phase_train_timing(trained, dev, train_errors, train_launches, steps)
    rows += swinir_train_rows
    del trained
    hat = HAT.build(**HAT_MAIN, seed=SEED, device=dev)
    log(f"model: HAT x4 embed {HAT_MAIN['embed_dim']} depths {HAT_MAIN['depths']} window {HAT_MAIN['window_size']}, "
        f"{hat.count_parameters()} parameters")
    hat_errors = phase_hat_kernels(hat, dev)
    hat_launches = phase_hat_end_to_end(hat, dev)
    rows += phase_hat_timing(hat, dev, hat_errors, hat_launches)
    del hat
    torch.cuda.empty_cache()
    hat_train_errors = phase_train_kernels(HAT.build(**HAT_TRAIN_MODEL, seed=SEED, device=dev), dev,
                                           hat_train_kernel_cases)
    phase_train_grads(dev, "hat")
    hat_trained, hat_train_launches, hat_steps = phase_hat_train(dev)
    rows += phase_hat_train_timing(hat_trained, dev, hat_train_errors, hat_train_launches, hat_steps,
                                   swinir_train_rows)
    del hat_trained
    torch.cuda.empty_cache()
    b4_errors = phase_b4_kernels(dev)
    rows += phase_x2_x3(dev, b4_errors)
    resblock_error = phase_resblock_kernels(dev)
    swinfir_row, _ = phase_swinfir_serving(dev, resblock_error)
    rows.append(swinfir_row)
    phase_swinfir_grads(dev)
    phase_swinfir_train(dev)
    rows.append(phase_maxsr(dev))
    phase_trained(dev)
    phase_evaluator(dev)
    phase_cli(dev)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
