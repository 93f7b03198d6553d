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
  and the same in f32, the JAX Trainer's ``bfloat16=False`` (B5, B9 and
  B13 through their 3xTF32 kernels);
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
  serving bf16 and f32, batch 1, 256x256 LR input, the 32 attention cores
  of a forward through B15;
* MaxSR x4 training at the same widths: ``Trainer.run`` at the JAX
  package's recipe, batch 32 of 64x64 LR crops, bf16 over f32 masters,
  ``fused_train`` by default (B5-B8 at C 128, 4 heads of 32, window 8, B6 /
  B7 at hidden 512: 32 launches each a step);
* the eight conv families at their build defaults (x4, bf16, batch 1,
  256x256 LR, cuDNN convs, no kernel of the port), EDSR and SRResNet
  training 3 steps at their recipes;
* the user's entry points: the eighteen trained checkpoints of
  ``tests/fixtures/quality`` read by ``load_model`` (no JAX, no flax) with
  the fixture PNGs read by the port's codec, the ``Evaluator2`` on the host
  and on the card, the CLI (``python3 -m studiosr_tpu_torch``), and the
  training entry point ``scripts/torch_train.py`` (SwinIR classical x4 at
  its recipe, batch 32 of 64x64, bf16, ``fused_train``: B5-B8 36 launches
  each a step) on a DIV2K-layout corpus made from the seed;
* SwinFIR x4 at window 12 with SwinIR classical's widths (embed 180, depths
  [6]x6, 6 heads, mlp ratio 2, the SFBs): bf16, batch 1, 256x256 LR, each
  Swin block as B5 then B6 (the route of every window but 8), and SwinIR x4
  at windows 4, 16, 24 and 8 at a reduced depth;
* above window 16 (B5's and B9's streaming family): SwinIR classical x4 at
  window 24 (the classical widths, depth not cut; bf16, batch 1, 256x256
  LR: B5 36 and B6 36 a forward, no B1) and MaxSR x4 adaptive fused
  training at a 289x289 LR crop (window 17, batch 1, ``MAXSR_MAIN``), then
  the tiled device loop (SwinIR x4, 512 x 384, tile 128);
* HAT at every window (B10's H100 kernel at any window, B12 / B13's large
  family above 256 queries or 576 keys): HAT x4 at ``HAT_SRx4.yml``'s widths
  at window 24 (depth not cut; bf16, batch 1, 256x256 LR: B11 36, B5 36,
  B6 ``extra`` 36, B10 6, B2 7, B3 1 a forward) and at window 12 the same
  way, and trained fused at window 24 at the JAX recipe (batch 32 of 64x64
  crops: B5 / B9 36 in their large family, B6 / B7 36, B12 / B13 6 a
  step), B12, B13, B5 and B9 timed at the step's shapes (B9 and B13 on
  the two-formation core ``csrc/lb_core.cuh``);
* the published-weight zoo offline: release-layout files written under a
  temporary ``./pretrained`` from seeded port models (SwinIR x4, HAT, EDSR,
  RCAN at their published widths) and read by ``from_pretrained``, the CLI
  without ``--ckpt``.
* serving over a mesh in one process: SwinIR x4 at a 1024x1024 LR image and
  HAT x4 at 512x512 (the widths above, bf16 fused), tiled over two slots of
  the card (and over every card where there are two or more), each slot a
  replica with its own host thread and CUDA stream.

Phases, in order; any failure exits non-zero before the final line:

1. device: requires CUDA; prints nvidia-smi's name and power limit;
2. build: compiles ``studiosr_tpu_torch/csrc/*.cu`` (one nvcc per source,
   in parallel) and prints the seconds and ptxas register/spill lines,
   then the host library ``studiosr_tpu_torch/native/`` (g++; a failed
   build fails the run);
3. serving kernels vs plain at the main path's shapes, f32 and bf16: B1
   (shift 0 and 4), B2 (plain, extra, lrelu0.01, residual), B3, every f32
   launch through its 3xTF32 entry written for the H100 (``F32_ENTRIES``,
   here and in every f32 check of B1, B2, B3, B4 and B14); the plain side
   on the modules' own weights; then B1 in bf16 and f32 at the card tests'
   odd geometries (C 32 / d 16, C 180 at H != W and an odd window count, d
   8, 10, 12), f32 B1 where it keeps the first design by rule (C 184, d 48,
   C 90: ``swin_block_f32``), and bit for bit: B1 on the blob packed
   at load time against B1 on dense weights, B14 on packed weights against
   B14 on HWIO; B3 at HAT's 256 x 256 x 64 and a ragged (2, 37, 53, 64),
   f32 and bf16, each launch through its entry, and a narrow f32 tail (Cin
   4) through ``upsample_x4_f32``; bit for bit, B3 and B4 x2 / x3 on the
   weights packed at load time against HWIO;
4. serving end to end: three seeded 256x256 uint8 requests through
   ``inference`` (bf16, fused) with launch counts checked per forward (and
   every B1, B2 and B3 launch through the bf16 kernel written for the H100,
   here and in every served path that runs B1, B2, B3, B4, B14 or B15), and
   the fused forward against the plain port forward in f32 (its 36 B1, 7
   B2 and 1 B3 launches through the 3xTF32 entries; its time fused and
   plain) and bf16;
5. serving timing with CUDA events: the forward, each kernel, its plain
   version, B2's library call, and each kernel's bound from its shapes; for
   B1 the same block as a sequence of bf16 PyTorch calls (no one call
   computes it), and for B3 the same tail as a sequence of bf16 PyTorch
   calls (three channels-last ``F.conv2d``, two ``F.pixel_shuffle``); for
   B1, B2, B3 (B14 in phase 20, B15 in phase 22) kernel / library, the
   share of the bound and ``-Xptxas -v``'s registers, static shared memory
   and spills; then the same three in f32 on the 3xTF32 kernels (bound at
   164.9 TFLOP/s), B2 beside cuDNN's f32 ``F.conv2d`` + add and B1 beside
   B5 f32 + B6 f32 on the same map and weights and the f32 sequence (the
   ``*_f32`` rows);
6. training kernels vs plain, batch 4 and the path's batch 32 of 64x64
   maps, f32 and bf16: B5 and B8 (shift 0 and 4), B6 (also on a ragged row
   count), B7, with drop-path scales that include a 0, each launch through
   its dtype's C entry, B6 (and in f32 B5) launched twice for the same
   bits;
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
    180), f32 and bf16: B11 (on the convs serving packs at load time), B5
    at window 16 (shift 0 and 8), B6 with ``extra`` / ``extra_scale``, B11
    and B6 twice for the same bits (in f32 B6 and B5 too, through
    ``mlp_block_extra_mma_f32`` and ``window_attention16_mma_f32``), B10
    (its border windows' keys reach outside the image);
11. HAT serving end to end: the fused forward against the plain port
    forward in f32 (its 36 B5 launches through ``window_attention16_mma_f32``
    and its B6 launches through ``mlp_block_extra_mma_f32``; both forwards
    timed) and bf16, then three seeded 256x256 uint8 requests through
    ``inference`` (bf16, fused) with launch counts checked per forward;
12. HAT serving timing: the forward (ms, LR MP/s), each HAT kernel's ms,
    plain ms and bound, B11 beside the same function as a sequence of bf16
    PyTorch calls, B6's join in f32 (the ``fused_mlp_block_extra_f32`` row,
    bound at 3xTF32), and B2 and B3 at HAT's shapes;
13. HAT training kernels vs plain at batch 4 and the path's batch 32 of
    64x64 maps, f32 and bf16: B5 at window 16 with drop-path and B9 (shift
    0 and 8, drop-path scales that include a 0), B12 and B13 on the OCAB's
    transposed views at its geometry (256 queries, 576 keys, d 30), on 37
    windows and at the trained fixtures' (64, 144, d 16), with logits large
    enough that the row max matters (the path's bias in the run's dtype, as
    the bf16 step gathers it), B12 and B13 launched twice for the same bits
    (in f32 B13, B5 and B9 too, through ``oca_core_bwd_mma_f32``,
    ``window_attention16_mma_f32`` and ``attn_bwd16_mma_f32``);
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
16b. HAT x4 f32 training (``phase_hat_train_f32``, the JAX Trainer's
    ``bfloat16=False``): ``Trainer.run`` for 3 steps at batch 32, the
    launches a step (B5 and B9 36 through ``window_attention16_mma_f32`` and
    ``attn_bwd16_mma_f32``, B13 6 through ``oca_core_bwd_mma_f32``, every f32
    launch through its entry), finite losses, moved weights; step ms and
    peak memory; B13, B5 and B9 at the step's shapes in f32 against their
    plain versions, each twice for the same bits, timed beside their plain
    versions, B13 beside SDPA's f32 backward, B5 and B9 beside the same
    functions as sequences of f32 PyTorch calls (the ``oca_core_bwd_f32``,
    ``fused_window_attention_block_ws16_f32`` and ``attention_bwd_ws16_f32``
    rows, bound at 3xTF32);
16c. f32 B5 and its backward at windows 9, 12 and 16 where the 3xTF32
    kernels decline the geometry (``phase_ws16_f32_first_design``): C 128 /
    2 heads and C 192 / 3 (head dim 64) and C 90 / 6 (not a multiple of 4),
    shift 0 and ws / 2, with and without drop-path, against their plain
    versions at the f32 limit, every launch through
    ``window_attention16_f32`` / ``attn_bwd16_f32``, the backward its bits
    again; C 264 / 12 heads, which no kernel takes in f32, raises
    NotImplementedError in both wrappers with no launch;
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
20. SwinFIR x4 serving at full width: fused vs plain forward (f32, bf16;
    the f32 forward's B1 36, B14 7 and B3 1 launches through their 3xTF32
    entries), uint8 fused vs plain in f32 within 1 LSB, three requests with
    launch counts (B1 36, B14 7, B3 1 a forward, B2 none; every B1 and B14
    launch through its bf16 entry), the forward's time (bf16; f32 fused
    and plain) and B14's ms, plain ms, bound and library (cuDNN) ms in bf16
    and in f32 (the ``fused_resblock_f32`` row);
21. SwinFIR training: the fused-train module's loss and gradients in f32
    against an f64 witness and against plain autograd in f32 (batch 4, the
    SFBs' LeakyReLU kinks pinned too); ``Trainer.run`` for 3 steps at the
    recipe (batch 32, f32) with launch counts (B5-B8 36 a step; every B5,
    B6, B7 and B8 launch through its f32 kernel written for the H100,
    ``window_attention_mma_f32`` / ``mlp_block_mma_f32`` /
    ``mlp_bwd_mma_f32`` / ``attn_bwd_mma_f32``) and a falling loss; B5 and
    B8 (shift 4), B6 and B7 in f32 at the step's shapes on the trained
    weights against their plain versions, timed beside the plain versions,
    the bound at 3xTF32 and an f32 PyTorch sequence (the ``*_f32`` rows of
    the kernels line); step ms, images/s and peak memory over 7 steps of one
    batch (the last 5 timed);
22. B15 vs plain, f32 and bf16: MaxSR adaptive (256 windows of 256 tokens,
    4 heads, d 32, no bias), static (1024 windows of 64 tokens, a table
    bias), a mask over the windows of 2 images, N = M = 1024, N 36 at d 16,
    d 12, each launch through its dtype's entry (f32 ``window_attn_flash_f32``);
    N 1089 raises; ms, plain ms, bound and SDPA ms at the two MaxSR shapes in
    bf16 and in f32 (the ``window_attention_pallas_f32`` row, bound at 3xTF32);
23. MaxSR x4 serving at full width, adaptive and static: fused vs plain
    forward (f32, its 32 B15 launches through ``window_attn_flash_f32``;
    bf16), three requests with 32 B15 launches a forward and nothing else,
    the forward's time in bf16 and in f32;
24. MaxSR training kernels vs plain at its geometry, batch 4 and 32 of
    64x64 maps (C 128, 4 heads of 32, window 8, zero qkv / proj biases, no
    drop-path), f32 and bf16: B5 and B8 with the static mode's table bias
    and the adaptive mode's zero bias, B6 (whole and ragged rows) and B7 at
    hidden 512, each launch through its dtype's entry, B6 twice for the
    same bits;
25. MaxSR gradients end to end, batch 4, as phase 7, adaptive then static:
    the fused-train module's loss and every gradient in f32 and bf16
    against an f64 witness, the f32 run held against plain autograd in f32
    (plain f32 itself reads 1.8e-5 from the witness), the bf16 run against
    the witness (the MBConvs' conv biases before a BatchNorm, whose
    gradient is 0, against the norm of all the reference's gradients);
26. MaxSR training: ``Trainer.run`` for 3 steps at the JAX Trainer's
    defaults with nothing passed (bf16, fused_train by default), 32
    launches each of B5-B8 a step through their bf16 H100 entries and
    nothing else, finite losses, moved weights and running statistics,
    then an evaluation on the card of square LR maps of 72 and 128 (windows
    9 and 12: plain in eval mode, no launch);
27. MaxSR training timing: step ms, images/s, peak memory; B5 and B8 (both
    modes), B6 and B7 at batch 32: ms, plain ms, bound, bf16 PyTorch
    yardstick; the kernels line's ``*_maxsr`` rows;
27b. MaxSR adaptive fused training at other square LR crops, full width,
    bf16 over f32 masters (``phase_maxsr_windows``): 48² at batch 32
    (windows of 7: B5 + B8, one 64-token tile a window), 96² at batch 8
    (10: B5 + B9, two tiles) and 144² at batch 4 (12: three tiles), 3 steps
    each with the launches per kernel, the step's ms and peak memory; B5
    and B8 / B9 against their plain versions on the first attention pair's
    operands of a step, timed beside their plain versions, bounds and
    bf16 PyTorch yardsticks (the kernels line's ``*_maxsr_ws{7,10,12}``
    rows); the f64 gradient witness at batch 4 of each crop (its plain runs
    recompute each attention pair in the backward, ``recomputed``, so the
    f64 one fits the card);
27c. B5 and its backward above window 16 (``phase_large_windows``): against
    their plain versions at windows 17, 20, 24, 32 and 33, shift 0 and ws /
    2, with and without drop-path, bf16 at C 128 / 4 heads and C 180 / 6
    (the streaming family's H100 entries), bf16 at C 128 / 2 heads (head
    dim 64) and f32 at C 128 / 4 (the older kernels' ``_large`` entries),
    the serving blob giving the dense weights' bits and the backward its
    bits again; window 32 timed (ms, plain ms, bound, bf16 PyTorch
    yardstick: the ``*_large_ws32`` rows); SwinIR classical x4 at window
    24, full width, bf16 fused: the forward within 2e-2 of the plain f32
    one, B5 36 (``_large``), B6 36, B2 7, B3 1, no B1, its ms and LR MP/s
    beside window 8's, B5 on the served operands timed (the
    ``*_large_swinir_ws24`` row); the tiled device loop against the host
    loop, bit for bit, with the host seconds of each; then MaxSR x4 adaptive
    fused training at a 289² crop (window 17, batch 1) as phase 27b, its f64
    witness at batch 1 (the ``*_large_maxsr_ws17`` rows);
28. the eight conv families (SRCNN, ESPCN, VDSR, SRResNet, EDSR, RCAN, HAN,
    IMDN) x4 at their build defaults (the reference's flax init): every
    conv of the bf16 forward vs f32 on its input, the bf16 forward vs the
    f32 one end to end (logged), three bf16 requests with no kernel of the
    port launched, the forward's time;
29. EDSR and SRResNet: ``Trainer.run`` for 3 steps at their recipes
    (finite losses, moved weights and running statistics, no launch);
30. the nine trained checkpoints (SwinIR x2 / x3 / x4 / x8, HAT x2 / x3 /
    x4 at window 8, SwinFIR x4, MaxSR x4 adaptive) on the card: plain f32
    beats bicubic by 0.3 dB, fused f32 is within 0.05 dB of plain, fused
    bf16 beats bicubic by 0.2 dB and is within 0.5 dB of plain, on each of
    the three fixture images, every bf16 B1 / B14 launch through its bf16
    entry; MaxSR's BatchNorm running statistics came back (not the initial
    0 / 1); then the nine conv-family checkpoints: plain f32 beats bicubic
    by 2.0 dB and bf16 by 1.5 dB (ESPCN x2: both by 1.0 dB, f32 above 30
    dB), the bf16 forward within 2e-2 of the f32 one, no launch, SRResNet's
    running statistics restored;
31. the Evaluator (HR / LR_bicubic layout built under
    ``build/chip_smoke_eval/`` from the fixture PNGs) on the host and on the
    card for SwinIR x2 and HAT x3, fused bf16: within 1e-4 dB and 1e-5 SSIM;
    the CLI as a subprocess on the x4 checkpoint with ``--half``, whole and
    ``--tile 32 --tile-overlap 8``, against the in-process route, and
    tiled in process at tile 16, overlap 4; the CLI on the EDSR x4
    checkpoint with ``--half`` against the in-process route;
32. C6: MaxSR adaptive (dim 32, one head, one trio) served fused, bf16, at
    a 1025x1025 LR input (windows of 33² = 1089 tokens, above B15's 1024):
    two structural declines a forward recorded, no launch, the output
    bit for bit the unfused route's;
33. the training entry point: a DIV2K-layout corpus in a temporary
    directory (four seeded HR images of 600-696 px with their X2 / X3 / X4
    by the port's bicubic, written with Paeth rows; a DIV2K_mini set from
    the fixture PNGs); ``scripts/torch_train.py --model swinir --scale 4
    --dataset DIV2K --size 64`` through ``main(argv)`` for 6 iterations
    with evaluations at 3 and 6 and ``--profile-dir``, then as a
    subprocess with ``--multihost`` (``phase_multihost``: a process group
    of one on NCCL from ``COORDINATOR_ADDRESS``, its parameters at
    iteration 6 bit for bit the in-process run's; then
    ``evaluate_uint8_batch`` and ``tiled_inference`` over the mesh
    ``[cuda:0]`` against their mesh-less outputs on SwinIR x4 serving),
    then resumed to 9 in process: 16 sub-images in each of the
    four packs, every PNG decode and crop-augment on the native host
    route, B5-B8 36 launches each a step through their bf16 H100 entries
    and nothing else, finite losses, ``latest`` and ``best`` written, the
    resume at iteration 6, the Chrome trace naming B5-B8's CUDA kernels;
    then the step call's host time, the ``get_batch`` wait per step, a
    loader batch of 32 on the native and the plain routes, and a 480²
    all-Paeth PNG decode by each unfilter;
34. C7 (``phase_windows_serving``, after phase 20): SwinFIR x4 at window 12,
    full width, bf16 fused: the forward within 2e-2 of the plain f32 one, B5
    36, B6 36, B14 7, B3 1 and no B1 a forward, each through its bf16 H100
    entry, the forward's ms over 5 forwards after 2 warm-ups; B5 and B6 alone
    on the first shifted block's served operands against their plain
    versions, their ms, plain ms, bounds and bf16 PyTorch yardsticks (the
    kernels line's ``*_swinfir_ws12`` rows); SwinIR x4 at depth [2]x2, f32
    and bf16, at windows 4, 16 and 24 (B5 + B6) and 8 (B1) against the plain
    f32 forward with the launches of a forward;
35. the zoo (``phase_zoo``, after phase 31): in a temporary directory,
    ``pretrained/001_classicalSR_DF2K_s64w8_SwinIR-M_x4.pth`` in the
    release's layout (``{"params": ...}`` from a seeded port SwinIR x4, the
    rel-pos indices and shift masks, three keys under ``module.``); the CLI
    without ``--ckpt`` (``--half``) as a subprocess from there; the
    parameters ``SwinIR.from_pretrained`` loads equal the written ones bit for
    bit, and the CLI's PNG the in-process fused bf16 output (B1 36, B2 7, B3
    1); HAT (``params_ema``), EDSR (DIV2K, range 255) and RCAN x4 at their
    published widths the same way, one 32² forward each;
36. HAT at every window (``phase_hat_windows``, after phase 27c): B12 / B13
    against their plain versions at HAT's OCA geometries of windows 4, 12,
    24 and 32 (9 windows, 6 heads of 30, f32 and bf16; above 256 queries or
    576 keys the ``_large`` counters, bf16 through their large H100
    entries), B13's bits again, and B10 on maps of 2 x 3 windows (bf16 on
    the H100 kernel, the blob and dense weights giving the same bits); HAT
    x4 at windows 24 and 12, full width, bf16 fused: the forward within
    2e-2 of the plain f32 one, the launches of a forward, its ms, B10 on
    group 0's served operands against its plain version, timed beside its
    bound and bf16 PyTorch sequence (the ``fused_ocab_block_ws24`` /
    ``_ws12`` rows); HAT x4 at window 24 trained 3 steps by ``Trainer.run``
    at the recipe (launches a step, finite losses, peak memory), the step's
    ms; B12 and B13 at the step's shapes (288 windows, 576 | 1296, the bias
    in bf16) against their plain versions, twice for the same bits, timed
    beside SDPA with the bias as its mask (the ``oca_core_*_large`` rows);
    B5 and B9 at the step's shapes (batch 32 of 72² maps, shift 12,
    drop-path, the bias in bf16) the same way, timed beside their plain
    versions and bf16 PyTorch sequences (the ``*_large_hat_ws24`` rows; B9
    and B13 on the two-formation core ``csrc/lb_core.cuh``);
    the window-24 model's gradients against the f64 witness at batch 4
    (its plain runs recompute each window attention and OCAB in the
    backward).
37. serving over a mesh (``phase_mesh_serving``, after phase 36, A20 and
    C10): SwinIR x4 at a 1024² LR image and HAT x4 at 512², bf16 fused,
    ``tiled_inference`` (tile 128, overlap 16, batch 8) over a mesh of two
    slots on the card in the host loop and the device loop, each output
    byte for byte the mesh-less call's and each slot launching B1-B3
    (SwinIR) or B11, B5 at window 16, B6 and B10 (HAT); then
    ``evaluate_uint8_batch`` of four 128² images over the mesh, the
    mesh-less scores exactly; the host seconds of each route beside the
    card's name and power limit. With two cards or more, the same over a
    mesh of every card, and a model built on ``cuda:1`` served while
    ``cuda:0`` is current (its bytes those of the model on this card);
    with one card, a line saying that half did not run.

Prints the card line, the script's seconds, a ``{"kernels": [...]}`` JSON
line, and last
``{"ok": true, "device": {...}}``. Random weights come from a seeded
``torch.Generator``; nothing is downloaded.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.func import functional_call

import studiosr_tpu_torch
from studiosr_tpu_torch import HAT, DIV2K, Evaluator2, MaxSR, SwinFIR, SwinIR, Trainer, load_model, native, resolve_device
from studiosr_tpu_torch.zoo.registry import get_model_class
from studiosr_tpu_torch.data import PairedImageDataset, PrefetchLoader
from studiosr_tpu_torch.models.blocks import Conv
from studiosr_tpu_torch.ops.cuda import _build, engagement
from studiosr_tpu_torch.ops.cuda.attn_bwd import attention_bwd, attention_bwd_plain, mma_takes
from studiosr_tpu_torch.ops.attention import attention_plain
from studiosr_tpu_torch.ops.cuda.conv3x3 import (
    cab_body_plain, conv3x3_plain, fused_cab_body, fused_conv3x3, fused_resblock, resblock_plain, unpack_cab_weights,
    unpack_conv3x3_f32_weights, unpack_conv3x3_weights,
)
from studiosr_tpu_torch.ops.cuda.mlp_block import fused_mlp_block, mlp_block_plain, unpack_mlp_block
from studiosr_tpu_torch.ops.cuda.mlp_bwd import mlp_bwd, mlp_bwd_plain
from studiosr_tpu_torch.ops.cuda.oca_core import counter, oca_core_bwd, oca_core_bwd_plain, oca_core_fwd, oca_core_plain
from studiosr_tpu_torch.ops.cuda.ocab import (
    fused_ocab_block, ocab_f32_mma_takes, ocab_plain, overlap_window, pack_ocab_block, unpack_ocab_block,
)
from studiosr_tpu_torch.ops.cuda.swin_block import f32_mma_takes as b1_f32_takes, fused_swin_block, swin_block_plain
from studiosr_tpu_torch.ops.cuda.upsampler import (
    fused_upsample_s, fused_upsample_x4, pack_tail, unpack_conv_last_weights, unpack_shuffle_conv_weights,
    upsample_s_plain, upsample_x4_plain,
)
from studiosr_tpu_torch.ops.cuda.window_attention import (
    FAMILY_STEM, f32_mma_takes, fused_window_attention_block, pack_window_attention, unpack_window_attention,
    window_attention_plain, window_family,
)
from studiosr_tpu_torch.ops.cuda.window_attn import window_attention
from studiosr_tpu_torch.ops.resize import bicubic_resize
from studiosr_tpu_torch.ops.windows import calculate_mask, gather_rel_bias, relative_position_index
from studiosr_tpu_torch.parallel import build_optimizer, make_train_step, prepare_state
from studiosr_tpu_torch.serving.hat_fast import prepare_hat_serving
from studiosr_tpu_torch.serving.swinir_fast import _b5_b6_operands, _conv_operands, prepare_serving
from studiosr_tpu_torch.utils import compute_psnr, get_loss, imread, imwrite, l1_loss
from studiosr_tpu_torch.utils.png import decode_png, encode_png, write_png

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
F32_SERVING: dict = {}  # phase 4's f32 forward launches, for phase 5's f32 rows

# HAT x4 serving: XPixelGroup/HAT options/test/HAT_SRx4.yml (the JAX
# package's defaults, models/hat.py:388-403), depth not cut.
HAT_MAIN = dict(scale=4, embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=16, mlp_ratio=2.0,
                compress_ratio=3, squeeze_factor=30, conv_scale=0.01, overlap_ratio=0.5)
KERNELS.update({
    "fused_cab_body": ("studiosr_tpu_torch/csrc/cab_mma.cu", "studiosr_tpu/ops/pallas/conv3x3.py:393"),
    "fused_window_attention_block_ws16": (
        "studiosr_tpu_torch/csrc/window_attention_mma.cu", "studiosr_tpu/ops/pallas/swin_block.py:549"),
    "fused_mlp_block_extra": ("studiosr_tpu_torch/csrc/mlp_block_mma.cu", "studiosr_tpu/ops/pallas/swin_block.py:904"),
    "fused_ocab_block": ("studiosr_tpu_torch/csrc/ocab_mma.cu", "studiosr_tpu/ops/pallas/ocab.py:173"),
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
    "oca_core_fwd": ("studiosr_tpu_torch/csrc/oca_fwd_mma.cu", "studiosr_tpu/ops/pallas/oca_core.py:117"),
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
# SwinFIR's f32 step runs B5-B8 through their f32 kernels written for the
# H100 (3xTF32 products): their rows in the kernels line, bound at three TF32
# products a product (494.7 TFLOP/s dense TF32, the FMA pipes' 66.9 logged);
# B6's f32 join (HAT's CAB, the f32 HAT forward) beside them
KERNELS.update({
    "attention_bwd_f32": ("studiosr_tpu_torch/csrc/attn_bwd_f32.cu", "studiosr_tpu/ops/pallas/attn_bwd.py:209"),
    "mlp_bwd_f32": ("studiosr_tpu_torch/csrc/mlp_bwd_f32.cu", "studiosr_tpu/ops/pallas/mlp_vjp.py:148"),
    "fused_window_attention_block_f32": ("studiosr_tpu_torch/csrc/window_attention_f32.cu",
                                         "studiosr_tpu/ops/pallas/swin_block.py:549"),
    "fused_mlp_block_f32": ("studiosr_tpu_torch/csrc/mlp_block_f32.cu", "studiosr_tpu/ops/pallas/swin_block.py:904"),
    "fused_mlp_block_extra_f32": ("studiosr_tpu_torch/csrc/mlp_block_f32.cu",
                                  "studiosr_tpu/ops/pallas/swin_block.py:904"),
    # B11 and B10 of the f32 HAT forward (3xTF32 on the tensor cores)
    "fused_cab_body_f32": ("studiosr_tpu_torch/csrc/cab_mma.cu", "studiosr_tpu/ops/pallas/conv3x3.py:393"),
    "fused_ocab_block_f32": ("studiosr_tpu_torch/csrc/ocab_f32.cu", "studiosr_tpu/ops/pallas/ocab.py:173"),
})
# the f32 HAT forward's rows in the kernels line: row -> the wrapper it times
HAT_F32_ROWS = {"fused_mlp_block_extra_f32": "fused_mlp_block_extra", "fused_cab_body_f32": "fused_cab_body",
                "fused_ocab_block_f32": "fused_ocab_block"}
PEAK_TF32X3_FLOPS, PEAK_FMA_FLOPS = 494.7e12 / 3, 66.9e12
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
# B1, B2, B3, B4, B5, B6, B10, B11, B14 and B15 on the served paths must go through, and
# each kernel's stem in its build log (ptxas's registers, shared memory and
# spills).
H100_ENTRIES = {"fused_swin_block": "swin_block_mma_bf16", "fused_conv3x3": "conv3x3_mma_bf16",
                "fused_resblock": "resblock_mma_bf16", "window_attention_pallas": "window_attn_flash_bf16",
                "fused_upsample_x4": "upsample_x4_mma_bf16", "fused_upsample_s": "upsample_s_mma_bf16",
                "fused_window_attention_block": "window_attention_mma_bf16",
                "fused_window_attention_block_ws16": "window_attention16_mma_bf16",
                "fused_window_attention_block_large": "window_attention_large_mma_bf16",
                "fused_mlp_block": "mlp_block_mma_bf16", "fused_mlp_block_extra": "mlp_block_extra_mma_bf16",
                "fused_cab_body": "cab_body_mma_bf16", "fused_ocab_block": "ocab_mma_bf16"}
# f32 serving (SwinFIR's dtype and every fused f32 check) and the f32 paths
# of B13 and B15 (HAT's f32 step, MaxSR's f32 forward): the C entry every
# f32 launch of B1, B2, B3, B4, B14, B15 and B13 in those phases must take,
# the 3xTF32 kernels written for the H100 (their geometry rules hold at
# every width those phases run; conv_last, Cout <= 16, runs inside the
# tails' entries on the FMA kernel; B13 above HAT's window 16 counts under
# ``oca_core_bwd_large``).
F32_ENTRIES = {"fused_swin_block": "swin_block_mma_f32", "fused_conv3x3": "conv3x3_mma_f32",
               "fused_upsample_x4": "upsample_x4_mma_f32", "fused_upsample_s": "upsample_s_mma_f32",
               "fused_resblock": "resblock_mma_f32", "window_attention_pallas": "window_attn_flash_f32",
               "oca_core_bwd": "oca_core_bwd_mma_f32"}
KERNELS.update({
    "fused_swin_block_f32": ("studiosr_tpu_torch/csrc/swin_block_f32.cu", "studiosr_tpu/ops/pallas/swin_block.py:691"),
    "fused_conv3x3_f32": ("studiosr_tpu_torch/csrc/conv3x3_f32.cuh", "studiosr_tpu/ops/pallas/conv3x3.py:212"),
    "fused_upsample_x4_f32": ("studiosr_tpu_torch/csrc/upsampler.cu", "studiosr_tpu/ops/pallas/upsampler.py:274"),
    "fused_resblock_f32": ("studiosr_tpu_torch/csrc/resblock.cu", "studiosr_tpu/ops/pallas/conv3x3.py:266"),
})
# 3xTF32: three TF32 tensor-core products (494.7 TFLOP/s dense) a product
PEAK_TF32X3_FLOPS = 494.7e12 / 3
H100_KERNELS = {"fused_swin_block": ("swin_block_mma", "swin_block_mma_kernel"),
                "fused_conv3x3": ("conv3x3", "conv3x3_mma_kernel"),
                "fused_resblock": ("resblock", "conv3x3_mma_kernel"),
                "window_attention_pallas": ("window_attn", "wf_kernel"),
                "fused_upsample_x4": ("upsampler", "upsample_"), "fused_upsample_s": ("upsampler", "upsample_"),
                "attention_bwd": ("attn_bwd_mma", "am_"), "attention_bwd_ws16": ("attn_bwd_mma", "am_"),
                "attention_bwd_large": ("attn_bwd_mma", "lb_"),
                "fused_window_attention_block": ("window_attention_mma", "_kernel"),
                "fused_window_attention_block_ws16": ("window_attention_mma", "_kernel"),
                "fused_window_attention_block_large": ("window_attention_mma", "lf_fwd"),
                "mlp_bwd": ("mlp_bwd_mma", "_kernel"), "fused_mlp_block": ("mlp_block_mma", "mf_kernel"),
                "fused_mlp_block_extra": ("mlp_block_mma", "mf_kernel"), "oca_core_bwd": ("oca_bwd_mma", "ob_"),
                "fused_cab_body": ("cab_mma", "_kernel"), "oca_core_fwd": ("oca_fwd_mma", "of_"),
                "fused_ocab_block": ("ocab_mma", "_kernel"), "oca_core_fwd_large": ("oca_fwd_mma", "of_|lf_fwd"),
                "oca_core_bwd_large": ("oca_bwd_mma", "lb_"),
                "attention_bwd_f32": ("attn_bwd_f32", "ab32_|tfw?_gemm"),
                "mlp_bwd_f32": ("mlp_bwd_f32", "mb32_|tfw?_gemm"),
                "fused_window_attention_block_f32": ("window_attention_f32", "wa32_|tfw_gemm"),
                "fused_mlp_block_f32": ("mlp_block_f32", "mf32_|tfw_gemm"),
                "fused_mlp_block_extra_f32": ("mlp_block_f32", "mf32_|tfw_gemm"),
                "fused_cab_body_f32": ("cab_mma", "ct_conv_kernel|cb32_"),
                "fused_ocab_block_f32": ("ocab_f32", "oc32_|mf32_|tfw_gemm"),
                "fused_swin_block_f32": ("swin_block_f32", "sb32_kernel"),
                "fused_conv3x3_f32": ("conv3x3", "ct_conv_kernel"),
                "fused_upsample_x4_f32": ("upsampler", "ct_conv_kernel"),
                "fused_resblock_f32": ("resblock", "ct_conv_kernel"),
                "oca_core_bwd_f32": ("oca_bwd_f32", "o32_"),
                "window_attention_pallas_f32": ("window_attn", "wf32_kernel"),
                "fused_window_attention_block_ws16_f32": ("window_attention_f32", "tw_rows"),
                "attention_bwd_ws16_f32": ("attn_bwd_f32", "tw_rows|ab16_")}
# B13 at HAT's f32 step and B15 at MaxSR's f32 forward (3xTF32 on the
# tensor cores): their rows in the kernels line, bound at 3xTF32
KERNELS.update({
    "oca_core_bwd_f32": ("studiosr_tpu_torch/csrc/oca_bwd_f32.cu", "studiosr_tpu/ops/pallas/oca_core.py:157"),
    "window_attention_pallas_f32": ("studiosr_tpu_torch/csrc/window_attn.cu",
                                    "studiosr_tpu/ops/pallas/window_attn.py:115"),
    # B5 and B9 at HAT's f32 step (window 16: the second family of the f32
    # kernels, its attention pass csrc/tf_window16.cuh)
    "fused_window_attention_block_ws16_f32": ("studiosr_tpu_torch/csrc/window_attention_f32.cu",
                                              "studiosr_tpu/ops/pallas/swin_block.py:549"),
    "attention_bwd_ws16_f32": ("studiosr_tpu_torch/csrc/attn_bwd_f32.cu", "studiosr_tpu/ops/pallas/attn_bwd.py:508"),
})
# HAT x4's f32 training (the JAX Trainer's ``bfloat16=False``) at the
# recipe's batch 32 of 64x64 crops, HAT_TRAIN_MODEL's widths
HAT_F32_TRAIN_STEPS = 3
HAT_F32_TRAIN_DIR = ROOT / "build" / "chip_smoke_hat_f32_train"
# f32 B5 and B9 at windows 9-16 where the 3xTF32 kernels decline the
# geometry and the first design (window_attention16_f32, attn_bwd16_f32)
# keeps it by rule: head dim 64 (C 128, 2 heads; C 192, 3 heads) and C not
# a multiple of 4 (C 90, 6 heads of 15); C11's geometries, above the 3xTF32
# kernels' C or head dim, at their windows (C 264 / 12 heads at 12, C 256 /
# 4 heads at 16), which the first design takes since its LN + q|k|v and dln
# passes were restaged; C 448 (8 heads of 56), above the first design's
# widest f32 C (F32_FIRST_MAX_C, 416), no kernel takes, and the wrappers raise
WS16_F32_FIRST_DESIGN_WINDOWS = (9, 12, 16)
WS16_F32_FIRST_DESIGN_GEOMETRIES = ((torch.float32, 128, 2), (torch.float32, 192, 3), (torch.float32, 90, 6))
WS16_F32_C11 = ((12, (torch.float32, 264, 12)), (16, (torch.float32, 256, 4)))
WS16_F32_DECLINED = (448, 8)
# f32 B11 and B10 where their 3xTF32 kernels decline the geometry and the
# first designs (cab_body_f32, ocab_f32) keep it: B11 (C, Cm) at Cm 72 and
# C 30; B10 (C, heads, hidden) at head dim 48 and C 30
HAT_F32_FIRST_DESIGN_CAB = ((180, 72), (30, 10))
HAT_F32_FIRST_DESIGN_OCAB = ((96, 2, 192), (30, 2, 60))
# The C entry every launch of B5-B9, B12 and B13 must take in a run of each
# dtype: bf16 the kernels written for the H100 (their geometry rules hold at
# every width the paths train); f32 B5 and B8 / B9 (windows 2-16), B6 (and
# its CAB join), B7 and B13 up to HAT's window 16 the f32 kernels written
# for the H100 (3xTF32 on the tensor cores: SwinFIR's recipe and HAT's f32
# step train in f32), the others the older kernels.
TRAIN_ENTRIES = {
    torch.bfloat16: {"attention_bwd": "attn_bwd_mma_bf16", "attention_bwd_ws16": "attn_bwd16_mma_bf16",
                     "attention_bwd_large": "attn_bwd_large_mma_bf16",
                     "fused_window_attention_block": "window_attention_mma_bf16",
                     "fused_window_attention_block_ws16": "window_attention16_mma_bf16",
                     "fused_window_attention_block_large": "window_attention_large_mma_bf16",
                     "mlp_bwd": "mlp_bwd_mma_bf16",
                     "fused_mlp_block": "mlp_block_mma_bf16", "oca_core_bwd": "oca_core_bwd_mma_bf16",
                     "oca_core_fwd": "oca_core_fwd_mma_bf16", "oca_core_bwd_large": "oca_core_bwd_large_mma_bf16",
                     "oca_core_fwd_large": "oca_core_fwd_large_mma_bf16"},
    torch.float32: {"attention_bwd": "attn_bwd_mma_f32", "attention_bwd_ws16": "attn_bwd16_mma_f32",
                    "attention_bwd_large": "attn_bwd_large_f32",
                    "fused_window_attention_block": "window_attention_mma_f32",
                    "fused_window_attention_block_ws16": "window_attention16_mma_f32",
                    "fused_window_attention_block_large": "window_attention_large_f32", "mlp_bwd": "mlp_bwd_mma_f32",
                    "fused_mlp_block": "mlp_block_mma_f32", "fused_mlp_block_extra": "mlp_block_extra_mma_f32",
                    "fused_cab_body": "cab_body_mma_f32", "fused_ocab_block": "ocab_mma_f32",
                    "oca_core_bwd": "oca_core_bwd_mma_f32",
                    "oca_core_fwd": "oca_core_fwd_f32", "oca_core_bwd_large": "oca_core_bwd_f32",
                    "oca_core_fwd_large": "oca_core_fwd_f32"},
}
# The kernels redesigned in bf16 last, held to the same bits from launch to
# launch (no atomic sums) at the path's batch (phases 6, 10 and 13).
BITWISE = ("fused_mlp_block", "fused_mlp_block_extra", "oca_core_bwd", "fused_cab_body", "oca_core_fwd",
           "fused_ocab_block", "fused_window_attention_block_large", "oca_core_fwd_large")
# The f32 kernels redesigned last, held to the same bits from launch to
# launch in f32 (phases 6, 10 and 13)
BITWISE_F32 = ("fused_window_attention_block", "fused_mlp_block", "fused_mlp_block_extra", "oca_core_bwd",
               "fused_window_attention_block_ws16", "attention_bwd_ws16", "fused_cab_body", "fused_ocab_block")
# B1 in bf16 beyond the main path's shape, as the card tests take it: (C,
# heads, map, shift): C 32 with 2 heads of 16 (the trained fixtures), C 180
# at H != W and an odd window count (a half-empty last window pair), d 8,
# d 12 with an odd count of 8-column output tiles, d 10.
B1_ODD_CASES = ((32, 2, (2, 16, 24), 0), (32, 2, (2, 16, 24), 4), (180, 6, (1, 24, 16), 4),
                (180, 6, (1, 24, 24), 4), (16, 2, (1, 8, 24), 4), (24, 2, (2, 24, 8), 4), (60, 6, (1, 16, 16), 4))
# f32 B1 at geometries the 3xTF32 kernel declines, which keep swin_block.cu's
# first design by rule: C above 180 (184, 8 heads of 23), head dim above 32
# (96, 2 heads of 48), C not a multiple of 4 (90, 6 heads of 15).
B1_F32_FIRST_DESIGN_CASES = ((184, 8, (1, 24, 16), 4), (96, 2, (2, 16, 24), 0), (90, 6, (1, 16, 24), 4))
WINDOW_ATTN_CASES = (
    ("adaptive", 256, 4, 256, 32, False, 0), ("static", 1024, 4, 64, 32, True, 0),
    ("mask over 2 images", 128, 4, 64, 32, True, 64), ("N 1024", 4, 4, 1024, 32, True, 0),
    ("N 36 d 16", 64, 2, 36, 16, True, 0), ("d 12", 64, 4, 64, 12, False, 0),
)

# MaxSR x4 training: MAXSR_MAIN (adaptive; and its static mode) at the JAX
# Trainer's defaults (batch 32 of 64x64 LR crops, bf16 over f32 masters, Adam
# 2e-4 (0.9, 0.99), L1), fused_train left to the Trainer: each of the 32
# attention pairs a step through B5 and B8 (C 128, 4 heads of 32, window 8,
# zero qkv / proj biases) and B6 and B7 (hidden 512).
MAXSR_TRAIN_STEPS = 3
MAXSR_TRAIN_DIR = ROOT / "build" / "chip_smoke_maxsr_train"
# the MaxSR Trainer's evaluation set: square LR maps whose adaptive windows
# (9, 12) the training kernels do not take; evaluations run plainly
MAXSR_EVAL_SIDES = (72, 128)
MAXSR_PER_STEP = {"fused_window_attention_block": 32, "attention_bwd": 32, "fused_mlp_block": 32, "mlp_bwd": 32}
# the kernels line's MaxSR-step rows: row name -> the wrapper whose launches it counts
MAXSR_ROWS = {f"{name}_maxsr": name for name in MAXSR_PER_STEP}
# MaxSR adaptive fused training at square LR crops of other windows: (side,
# batch, the gradient witness's batch). 48² (the EDSR-style patch) has
# windows of 7 (B5 + B8, one 64-token tile a window), 96² of 10 and 144² of
# 12 (B5 + B9, two and three tiles); the batches keep a step under about 25
# GiB (96² at batch 32 would take about 80). The plain runs of the gradient
# witness recompute each attention pair in the backward (``train_grads``), so
# the f64 one fits the card at 144² and batch 4.
MAXSR_WINDOW_CROPS = ((48, 32, 4), (96, 8, 4), (144, 4, 4))
MAXSR_WINDOW_STEPS = 3
KERNELS.update({row: KERNELS[name] for row, name in MAXSR_ROWS.items()})
# How hold_grads holds a model's gradients: the f32 fused run against the f64
# witness, or (MaxSR) against plain autograd in f32, whose own reading from the
# witness goes up to 1.8e-5 (conv_last.weight, adaptive, batch 4: sums over
# 262,144 output pixels), so that only the fused-vs-plain reading isolates the
# kernels' error; and the parameters whose gradient is 0 in exact arithmetic
# (MaxSR's MBConv convs' biases, each followed by a BatchNorm on batch
# statistics), whose error is measured against the norm of all the
# reference's gradients, not against their own.
GRAD_RULES = {"f32_against": ("fused", torch.float32), "zero_grads": ()}
MAXSR_GRAD_RULES = {"f32_against": ("fused-vs-plain", torch.float32),
                    "zero_grads": ("fn.0.bias", "fn.3.bias", "fn.7.bias")}

# The eight conv families (no TPU kernel in the JAX package: cuDNN convs) at
# their build defaults, the published widths; x4 serving, bf16, batch 1,
# 256x256 LR; EDSR and SRResNet (BatchNorm) train 3 steps at their recipes.
CONV_FAMILIES = ("srcnn", "espcn", "vdsr", "srresnet", "edsr", "rcan", "han", "imdn")
CONV_TRAIN = ("edsr", "srresnet")
CONV_TRAIN_STEPS = 3
CONV_TRAIN_DIR = ROOT / "build" / "chip_smoke_conv_train"
# Their trained checkpoints (tests/fixtures/quality) and floors
# (tests/models/test_quality_fixture.py): (directory, model, scale, LR suffix);
# plain f32 > bicubic + 2.0 dB, bf16 > bicubic + 1.5; the ESPCN x2 checkpoint
# (``ckpt``) > bicubic + 1.0 and > 30 dB, its bf16 > bicubic + 1.0.
# C6: MaxSR adaptive served fused at a 1025² LR input (windows of 33² = 1089
# tokens, above B15's 1024), narrowed so the plain core's f32 scores (1089
# windows x 1089² x 4 B = 5.2 GB an attention call) fit: dim 32, one head,
# one stage of one trio (two attention calls a forward).
DECLINE_LR = 1025
DECLINE_MODEL = dict(scale=4, adaptive=True, dim=32, dim_head=32, depth=[1], window_size=8, dropout=0.1)
# The training entry point: a DIV2K-layout corpus of four seeded HR images
# (sides multiples of 12 between 600 and 719: 2 x 2 crops in every pack, 16
# a pack) with their X2 / X3 / X4 by the port's bicubic, written with Paeth
# rows; scripts/torch_train.py at SwinIR classical x4's recipe (batch 32 of
# 64²), 6 iterations, evaluations at 3 and 6, then resumed to 9.
ENTRY_SIDES = ((600, 648), (696, 624), (660, 600), (636, 684))
ENTRY_STEPS, ENTRY_RESUMED = 6, 9
ENTRY_PACK = 16
# B5-B8's bf16 H100 kernels as the profiler's trace names them
ENTRY_TRACE_KERNELS = {"fused_window_attention_block": "wa_attn_kernel", "fused_mlp_block": "mf_kernel",
                       "mlp_bwd": "mb_prod_kernel", "attention_bwd": "am_attn_kernel"}
CONV_TRAINED = (("ckpt", "espcn", 2, "_lr"), ("srcnn_ckpt", "srcnn", 2, "_lrx2"), ("vdsr_ckpt", "vdsr", 2, "_lrx2"),
                ("srresnet_ckpt", "srresnet", 4, "_lrx4"), ("edsr_ckpt", "edsr", 4, "_lrx4"),
                ("rcan_ckpt", "rcan", 4, "_lrx4"), ("han_ckpt", "han", 4, "_lrx4"), ("han_x8_ckpt", "han", 8, "_lrx8"),
                ("imdn_ckpt", "imdn", 4, "_lrx4"))
CONV_FLOOR_PLAIN, CONV_FLOOR_BF16, ESPCN_FLOOR, ESPCN_ABSOLUTE = 2.0, 1.5, 1.0, 30.0
# C7, fused serving at windows other than 8: SwinFIR x4 at window 12 with SwinIR
# classical's widths (embed 180, depths [6]x6, 6 heads, mlp ratio 2, the SFBs),
# depth not cut; bf16, batch 1, 256² LR (264² after the flip padding); each
# Swin block as B5 (window 12: its multi-tile family, the shift folded into
# its reads) then B6, B14 for the SFBs, B3 for the tail, no B1.
WINDOWS_MAIN = dict(MAIN, window_size=12)
WINDOWS_PER_FORWARD = {"fused_window_attention_block_ws16": 36, "fused_mlp_block": 36, "fused_resblock": 7,
                       "fused_upsample_x4": 1}
WINDOWS_ROWS = {"fused_window_attention_block_ws16": "fused_window_attention_block_swinfir_ws12",
                "fused_mlp_block": "fused_mlp_block_swinfir_ws12"}
KERNELS.update({row: KERNELS[name] for name, row in WINDOWS_ROWS.items()})
# routing coverage at a reduced depth (two groups of two blocks), SwinIR x4 at
# the published widths: windows 4, 16 and 24 take B5 + B6 (B5 in its three
# families), window 8 B1
WINDOWS_REDUCED = dict(MAIN, depths=[2, 2], num_heads=[6, 6])
WINDOWS_COVERAGE = {4: {"fused_window_attention_block": 4, "fused_mlp_block": 4},
                    16: {"fused_window_attention_block_ws16": 4, "fused_mlp_block": 4},
                    24: {"fused_window_attention_block_large": 4, "fused_mlp_block": 4},
                    8: {"fused_swin_block": 4}}
WINDOWS_LR = 64
# B5 and its backward above window 16 (the streaming family, ``_large``):
# the kernel checks at windows 17 to 33 (N 289 to 1089; 32 is 16 whole
# 64-token chunks, 33 the most padding), each geometry on a map of 2 x 3
# windows, batch 2, shift 0 and ws / 2, with and without drop-path (a 0 and a
# 1.25 scale): bf16 at MaxSR's C 128 / 4 heads and SwinIR's C 180 / 6 (the
# kernels written for the H100), bf16 at C 128 / 2 heads (head dim 64: the
# older kernels), f32 at C 128 / 4 heads; then window 32 timed at C 128 / 4
# heads on 4 x 4 windows
KERNELS.update({
    "fused_window_attention_block_large": (
        "studiosr_tpu_torch/csrc/window_attention_mma.cu", "studiosr_tpu/ops/pallas/swin_block.py:549"),
    "attention_bwd_large": ("studiosr_tpu_torch/csrc/attn_bwd_mma.cu", "studiosr_tpu/ops/pallas/attn_bwd.py:508"),
})
LARGE_WINDOWS = (17, 20, 24, 32, 33)
LARGE_GEOMETRIES = ((torch.bfloat16, 128, 4), (torch.bfloat16, 180, 6), (torch.bfloat16, 128, 2),
                    (torch.float32, 128, 4))
LARGE_TIMED = (32, 128, 4, 4)  # window, C, heads, windows a side
LARGE_ROWS = {"fused_window_attention_block_large": "fused_window_attention_block_large_ws32",
              "attention_bwd_large": "attention_bwd_large_ws32"}
KERNELS.update({row: KERNELS[name] for name, row in LARGE_ROWS.items()})
# SwinIR classical x4 at window 24 (JingyunLiang/SwinIR's classical widths:
# embed 180, depths [6]x6, 6 heads, mlp ratio 2), depth not cut: bf16, batch
# 1, 256² LR (264² after the flip padding, 121 windows of 576 tokens); each
# Swin block as B5 (the streaming family) then B6, B2 7 and B3 1, no B1
LARGE_SWINIR = dict(MAIN, window_size=24)
LARGE_SWINIR_PER_FORWARD = {"fused_window_attention_block_large": 36, "fused_mlp_block": 36, "fused_conv3x3": 7,
                            "fused_upsample_x4": 1}
KERNELS["fused_window_attention_block_large_swinir_ws24"] = KERNELS["fused_window_attention_block_large"]
# MaxSR x4 adaptive fused training at a 289² LR crop (window 17, batch 1; the
# witness at batch 1 too), as phase_maxsr_windows trains its crops
LARGE_MAXSR_CROP = (289, 1, 1)
# HAT at every window (B10, B12 and B13 beyond windows 8 and 16): HAT x4 at
# XPixelGroup/HAT options/test/HAT_SRx4.yml's widths (C 180, depths [6]x6, 6
# heads, overlap 0.5, mlp ratio 2), depth not cut, at window 24 (a 36 x 36
# key window): served in bf16 at batch 1, 256² LR (a 264² map, 121 windows
# of 576 queries and 1296 keys) and trained fused at the JAX recipe (batch
# 32 of 64² crops, padded to 72²: 288 windows a step); window 12 served the
# same way (484 windows of 144 queries and 324 keys). The kernel checks run
# at windows 4, 12, 24 and 32; B12 / B13 above 256 queries or 576 keys count
# under their ``_large`` counters.
HAT_WS24 = dict(HAT_MAIN, window_size=24)
HAT_WS24_TRAIN = dict(HAT_WS24, drop_path_rate=0.1)
HAT_WINDOW_CHECKS = (4, 12, 24, 32)
HAT_WINDOWS_SERVED = (24, 12)
HAT_WS24_STEPS = 3
HAT_WS24_DIR = ROOT / "build" / "chip_smoke_hat_ws24_train"
KERNELS.update({
    "oca_core_fwd_large": ("studiosr_tpu_torch/csrc/oca_fwd_mma.cu", "studiosr_tpu/ops/pallas/oca_core.py:117"),
    "oca_core_bwd_large": ("studiosr_tpu_torch/csrc/oca_bwd_mma.cu", "studiosr_tpu/ops/pallas/oca_core.py:157"),
})
HAT_WS24_PER_STEP = {"fused_window_attention_block_large": 36, "attention_bwd_large": 36, "fused_mlp_block": 36,
                     "mlp_bwd": 36, "oca_core_fwd_large": 6, "oca_core_bwd_large": 6}
# the tiled device loop on the card: SwinIR x4 (MAIN, bf16 fused) on a 512 x
# 384 image at tile 128, overlap 16, tile batch 8 (20 tiles, 3 batches)
TILED_IMAGE, TILED_TILE, TILED_OVERLAP = (512, 384), 128, 16
# The zoo, offline: release-layout files written under a temporary
# ./pretrained from seeded port models at the published widths, then read by
# from_pretrained (the CLI without --ckpt for SwinIR x4).
ZOO_SWINIR_FILE = "001_classicalSR_DF2K_s64w8_SwinIR-M_x4.pth"
ZOO_OTHERS = (("hat", "HAT_SRx4.pth", "params_ema"), ("edsr", "r32f256x4.pth", None),
              ("rcan", "models_ECCV2018RCAN/RCAN_BIX4.pt", None))
ZOO_PER_FORWARD = {"fused_swin_block": 36, "fused_conv3x3": 7, "fused_upsample_x4": 1}

# Serving over a mesh in one process (A20, C10): SwinIR x4 (MAIN) at a
# 1024² LR image and HAT x4 (HAT_MAIN) at 512², bf16 fused, tiles of 128
# with the default overlap 16 and tile batch 8, over two slots on the card
# (each its own replica, host thread and stream), both loops; each slot's
# launches of the kernels its tiles run (HAT's tile batches hold more than
# one image, so B6 without the CAB join); MESH_EVAL images scored.
MESH_TILED = dict(tile=128, tile_overlap=16, tile_batch=8)
MESH_MODELS = (("swinir", 1024, ("fused_swin_block", "fused_conv3x3", "fused_upsample_x4")),
               ("hat", 512, ("fused_cab_body", "fused_window_attention_block_ws16", "fused_mlp_block",
                             "fused_ocab_block")))
MESH_EVAL = (4, 128)  # images, LR side


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


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """(least time in ms, what bounds it) at the bf16 tensor-core (or
    ``peak``) and HBM peaks."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
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


def f32_entry_failures(label: str, launches: dict) -> list:
    """[] when every f32 B1, B2, B3, B4 and B14 launch of ``launches`` went
    through the 3xTF32 entry written for the H100 (``F32_ENTRIES``,
    ``engagement.entries()`` since the same reset), else the failures."""
    entries, failed = engagement.entries(), []
    for name, entry in F32_ENTRIES.items():
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
        if m and fn and re.search(stem, fn):
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
    start = time.perf_counter()
    library = native.build()  # raises with g++'s output if the host library does not build
    native.library()
    log(f"build: host library {library.name} ({native.SOURCES}) loaded, {time.perf_counter() - start:.1f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def kernel_cases(model: SwinIR, dev: torch.device, dtype: torch.dtype):
    """(name, label, kernel fn, plain fn, operands, plain operands) at the
    main path's shapes: the operands with this model's weights as serving
    lays them out for ``dtype``, the plain operands with the same weights
    taken from the modules (dense, HWIO, in ``dtype``), so that no layout
    of the program's own stands on the reference's side."""
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
        dense = [t.to(dtype) if i in (2, 4, 9, 11) else t for i, t in enumerate(
            dense_b1_operands(model.module.layers[0].residual_group.blocks[1 if shift else 0]))]
        kw = dict(heads=heads, window_size=ws, shift=shift)
        cases.append(
            ("fused_swin_block", f"shift {shift}", lambda *a, kw=kw: fused_swin_block(*a, **kw),
             lambda *a, kw=kw: swin_block_plain(*a, **kw), (x, *ops.values()), (x, *dense))
        )
    w, b = prep["convs"][0]
    hwio = _conv_operands(model.module.layers[0].conv, dtype)[0]
    for label, kw, extra in (
        ("plain", {}, None),
        ("extra", {}, skip),
        ("lrelu0.01", {"activation": "lrelu0.01"}, None),
        ("residual", {"residual": True}, None),
    ):
        cases.append(
            ("fused_conv3x3", label, lambda x_, w_, b_, e_, kw=kw: fused_conv3x3(x_, w_, b_, extra=e_, **kw),
             lambda x_, w_, b_, e_, kw=kw: conv3x3_plain(x_, w_, b_, extra=e_, **kw), (x, w, b, extra),
             (x, hwio, b, extra))
        )
    up = model.module.upsample._modules
    tail = [t for conv in (up["0"], up["2"], model.module.conv_last) for t in _conv_operands(conv, dtype)]
    cases.append(("fused_upsample_x4", "x4", fused_upsample_x4, upsample_x4_plain, (x64, *prep["tail"]), (x64, *tail)))
    return cases


def phase_kernels(model: SwinIR, dev: torch.device) -> dict:
    """Every kernel against its plain version, f32 then bf16, each f32
    launch through its 3xTF32 entry (``F32_ENTRIES``). Returns the max abs
    error per kernel: bf16 (the main path's dtype) under its name, f32 under
    the name + "_f32"."""
    errors, failed = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        for name, label, kernel, plain, ops, plain_ops in kernel_cases(model, dev, dtype):
            engagement.reset()
            got = kernel(*ops)
            torch.cuda.synchronize()
            if dtype == torch.float32:
                failed += f32_entry_failures(f"{name} [{label}] f32", engagement.counters())
            want = plain(plain_ops[0].float(), *plain_ops[1:])  # f32 inside; the modules' weights
            torch.cuda.synchronize()
            err = kernel_check(f"{name} [{label}]", got, want, dtype, failed)
            key = name if dtype == torch.bfloat16 else f"{name}_f32"
            errors[key] = max(errors.get(key, 0.0), err)
    if failed:
        raise AssertionError("serving kernels disagree with their plain versions: " + "; ".join(failed))
    return errors


def dense_b1_operands(blk) -> list:
    """A Swin block's B1 operands, dense and f32, in ``fused_swin_block``'s
    order after x (serving holds them packed in either dtype)."""
    heads = blk.attn.num_heads
    ops = _b5_b6_operands(blk, heads, relative_position_index(blk.window_size), torch.float32)
    a, m = ops["attn"], ops["mlp"]
    return [a["ln_w"], a["ln_b"], a["wqkv"], a["bqkv"], a["wproj"], a["bproj"], a["bias"], m["ln_w"], m["ln_b"],
            m["w1"], m["b1"], m["w2"], m["b2"]]


def b1_operands(gen, c: int, heads: int, dev: torch.device, wdtype: torch.dtype = torch.bfloat16):
    """Seeded dense B1 operands at C ``c`` (hidden 2 C): weights in
    ``wdtype``, the rest f32, in ``fused_swin_block``'s order after x."""
    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    bf, hidden = wdtype, 2 * c
    return [randn(c, scale=0.1) + 1, randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5, dtype=bf),
            randn(3 * c, scale=0.1), randn(c, c, scale=c**-0.5, dtype=bf), randn(c, scale=0.1),
            randn(heads, 64, 64, scale=0.5), randn(c, scale=0.1) + 1, randn(c, scale=0.1),
            randn(c, hidden, scale=c**-0.5, dtype=bf), randn(hidden, scale=0.1),
            randn(hidden, c, scale=hidden**-0.5, dtype=bf), randn(c, scale=0.1)]


def phase_b1_b14_checks(model: SwinIR, dev: torch.device) -> None:
    """The kernels written for the H100 beyond the main path's variant: B1
    at the card tests' odd geometries against its plain version, bf16 then
    f32, every bf16 launch through ``swin_block_mma_bf16`` and every f32
    one through ``swin_block_mma_f32``; f32 B1 at the geometries that keep
    the first design (``swin_block_f32``) the same way; B1 on the blob serving packed at
    load time equals B1 on the dense weights (packed per call) bit for bit
    at the main path's shape; B14 on packed weights equals B14 on HWIO bit
    for bit."""
    from studiosr_tpu_torch.ops.cuda.conv3x3 import pack_conv3x3_weights, prepare_conv3x3_weights

    failed = []
    gen = torch.Generator(device="cpu").manual_seed(SEED + 30)
    for dtype, cases in ((torch.bfloat16, B1_ODD_CASES), (torch.float32, B1_ODD_CASES + B1_F32_FIRST_DESIGN_CASES)):
        for c, heads, shape, shift in cases:
            ops = b1_operands(gen, c, heads, dev, dtype)
            x = torch.randn(*shape, c, generator=gen).to(dev, dtype)
            kw = dict(heads=heads, window_size=8, shift=shift)
            engagement.reset()
            got = fused_swin_block(x, *ops, **kw)
            if dtype == torch.bfloat16:
                failed += entry_failures(f"B1 C {c}", engagement.counters())
            else:
                entry = "swin_block_mma_f32" if b1_f32_takes(c, heads, 2 * c) else "swin_block_f32"
                if engagement.entries() != {"fused_swin_block": {entry: 1}}:
                    failed.append(f"B1 f32 C {c}, {heads} heads took {engagement.entries()}, expected {entry}")
            want = swin_block_plain(x.float(), *[t.float() for t in ops], **kw)
            kernel_check(f"fused_swin_block [{str(dtype)[6:]}, C {c}, {heads} heads, {'x'.join(map(str, shape))}, "
                         f"shift {shift}]", got, want, dtype, failed)
    blk = model.module.layers[0].residual_group.blocks[1]
    prep = prepare_serving(model.module, model.config, torch.bfloat16)["blocks"][0][1]
    dense = [t.to(torch.bfloat16) if i in (2, 4, 9, 11) else t for i, t in enumerate(dense_b1_operands(blk))]
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
    written for the H100); a narrow f32 tail (Cin 4: 4 Cin <= 16) through
    ``upsample_x4_f32``, the FMA kernel it keeps by rule; and in bf16 at the main path's 264 x 264 x 64,
    B3 and B4 x2 / x3 on the weights packed at load time equal the same
    tails on HWIO weights (packed per call) bit for bit."""
    failed = []
    gen = torch.Generator(device="cpu").manual_seed(SEED + 31)
    for dtype in (torch.float32, torch.bfloat16):
        entry = "upsample_x4_mma_bf16" if dtype == torch.bfloat16 else "upsample_x4_mma_f32"
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
    x = torch.randn(2, 37, 53, 4, generator=gen).to(dev)
    ops = tail_ops(gen, dev, torch.float32, 4, 2, 2)
    engagement.reset()
    got = fused_upsample_x4(x, *ops)
    if engagement.entries() != {"fused_upsample_x4": {"upsample_x4_f32": 1}}:
        failed.append(f"B3 f32 Cin 4 took {engagement.entries()}")
    kernel_check("fused_upsample_x4 [2x37x53x4]", got, upsample_x4_plain(x, *ops), torch.float32, failed)
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
    """The tail's weights back in HWIO, whichever layout they came in (f32's
    packed images as hi + lo)."""
    s, n_colors = 2 if scale == 4 else scale, tail[-1].shape[0]
    out = [unpack_shuffle_conv_weights(t, cin, s) if t.dim() == 6 else
           unpack_conv3x3_f32_weights(t, cin, s * s * cin) if t.dim() == 5 else t for t in tail[:-2]]
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
    model.enable_fused(True).serving_prep()  # the f32 load-time layout, outside the counted forward
    engagement.reset()
    fused = model(x)
    torch.cuda.synchronize()
    F32_SERVING["swinir launches"] = launches32 = engagement.counters()
    failed32 = f32_entry_failures("swinir f32 forward", launches32)
    failed32 += [f"swinir f32 forward: {name} {launches32.get(name, 0)} launches, expected {per}"
                 for name, per in PER_FORWARD.items() if launches32.get(name, 0) != per]
    rel32 = rel_l2(fused, plain)
    log(f"e2e f32 fused vs plain: rel_l2 {rel32:.3e} limit {E2E_F32_REL_L2:.0e}")
    if not rel32 <= E2E_F32_REL_L2:
        raise AssertionError("f32 fused forward disagrees with the plain forward")
    if failed32:
        raise AssertionError("; ".join(failed32))
    del fused
    fwd32 = time_ms(lambda: model(x), iters=3)
    model.enable_fused(False)
    plain32 = time_ms(lambda: model(x), iters=2, warmup=1)
    model.enable_fused(True)
    log(f"forward f32 batch 1 {LR}x{LR} (TF32 off): fused {fwd32:.3f} ms, plain {plain32:.3f} ms")

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
    for name, label, kernel, plain, ops, _ in kernel_cases(model, dev, torch.bfloat16):
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
                dense_b1_operands(model.module.layers[0].residual_group.blocks[1]))])
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
    return rows + f32_serving_rows(model, dev, errors)


def f32_serving_rows(model: SwinIR, dev: torch.device, errors: dict) -> list:
    """The f32 rows of B1, B2 and B3 (the 3xTF32 kernels written for the
    H100) at the main path's shapes, on the weights serving lays out in f32:
    time, plain time, bound at 3xTF32 (the FMA pipes' floor logged), and the
    yardsticks: B2 beside cuDNN's f32 ``F.conv2d`` + add (TF32 off), B1
    beside B5 f32 + B6 f32 on the same map and weights and the block as a
    sequence of f32 PyTorch calls, B3 beside the tail as f32 PyTorch calls.
    Launches are the f32 forward's of phase 4."""
    rows, launches = [], F32_SERVING["swinir launches"]
    for name, label, kernel, plain, ops, dense in kernel_cases(model, dev, torch.float32):
        if label not in ("shift 4", "extra", "x4"):
            continue
        ms = time_ms(lambda: kernel(*ops), iters=10)
        plain_ms = time_ms(lambda: plain(*ops), iters=3, warmup=1)
        x_, library_ms = ops[0], None
        pix, c = x_.numel() // x_.shape[-1], x_.shape[-1]
        if name == "fused_swin_block":
            heads, hidden = MAIN["num_heads"][0], ops[11].shape[-1]
            flops = 2 * pix * c * (3 * c + c + 2 * hidden) + 4 * pix * 64 * c
            moved = 2 * nbytes(x_) + nbytes(*[t for t in ops[1:] if t is not None])
            dense = dense[1:]  # ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2
            ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2 = dense

            def b5_b6():
                y = fused_window_attention_block(x_, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, heads=heads,
                                                 window_size=8, shift=4)
                return fused_mlp_block(y.reshape(-1, c), ln2_w, ln2_b, w1, b1, w2, b2).reshape(x_.shape)

            pair_ms = time_ms(b5_b6, iters=10)
            wmask = torch.from_numpy(calculate_mask(tuple(x_.shape[1:3]), 8, 4)).to(dev)
            seq_ms = time_ms(lambda: b1_torch_sequence(x_, dense, heads, 4, wmask), iters=5)
            log(f"time fused_swin_block f32 yardsticks: B5 f32 + B6 f32 on the same map and weights {pair_ms:.3f} ms "
                f"(rel_l2 {rel_l2(b5_b6(), kernel(*ops)):.2e} against B1); the block as a sequence of f32 PyTorch "
                f"calls (TF32 off) {seq_ms:.3f} ms")
        elif name == "fused_conv3x3":
            w, b, extra = dense[1:]  # HWIO
            flops = 2 * pix * 9 * w.shape[2] * w.shape[3]
            moved = nbytes(x_, w, b, extra) + pix * w.shape[3] * x_.element_size()
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            library_ms = time_ms(
                lambda: F.conv2d(x_.permute(0, 3, 1, 2), w_oihw, b, padding=1).permute(0, 2, 3, 1) + extra, iters=10)
        else:
            n_colors = ops[6].shape[0]
            flops = 2 * 9 * c * (pix * 4 * c + 4 * pix * 4 * c + 16 * pix * n_colors)
            moved = nbytes(*dense) + 16 * pix * n_colors * x_.element_size()
            seq = sequence_weights(dense[1:], c, 4, torch.float32)
            seq_ms = time_ms(lambda: tail_sequence(x_, seq, 4), iters=10)
            log(f"time fused_upsample_x4 f32 yardstick (the tail as f32 PyTorch calls, TF32 off): {seq_ms:.3f} ms")
        bms, by = bound_ms(flops, moved, PEAK_TF32X3_FLOPS)
        row = f"{name}_f32"
        source, replaces = KERNELS[row]
        rows.append(dict(name=row, route="cuda", source=source, replaces=replaces, launches=launches.get(name, 0),
                         max_abs_err=errors[row], ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=library_ms))
        log(f"time {row} [{label}]: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bms:.4f} ms at 3xTF32 ({by}; "
            f"the FMA pipes {flops / 66.9e9:.4f} ms), library {library_ms if library_ms is None else round(library_ms, 4)}"
            f" ms, {flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB, {100 * bms / ms:.1f} % of the bound; "
            f"{ptxas_report(row)}")
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
    and, at batch 32, the kernels of ``BITWISE`` (bf16) and ``BITWISE_F32``
    (f32) launched twice for the same bits. Returns the bf16 max abs error
    of each kernel's first output at batch 32."""
    errors: dict = {}
    failed = []
    for batch in (CHECK_BATCH, TRAIN_BATCH):
        for dtype in (torch.float32, torch.bfloat16):
            for name, label, kernel, plain, ops in (cases or train_kernel_cases)(model, dev, dtype, batch):
                engagement.reset()
                got = _flat(kernel(*ops))
                torch.cuda.synchronize()
                failed += train_entry_failures(f"{name} [{label}] batch {batch}", engagement.counters(), dtype)
                if batch == TRAIN_BATCH and name in (BITWISE if dtype == torch.bfloat16 else BITWISE_F32):
                    again = _flat(kernel(*ops))
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    log(f"check {name} [{label}] batch {batch} {str(dtype)[6:]}: two launches give the same bits: "
                        f"{same}")
                    if not same:
                        failed.append(f"{name} [{label}] batch {batch}: two launches differ")
                    del again
                want = _flat(plain(*[t.float() for t in ops]))
                torch.cuda.synchronize()
                for i, (k, p) in enumerate(zip(got, want)):
                    err = kernel_check(f"{name} [{label}] batch {batch} output {i}", k, p, dtype, failed)
                    if dtype == torch.bfloat16 and i == 0 and batch == TRAIN_BATCH:
                        errors[name] = max(errors.get(name, 0.0), err)
                if name in PASS_THROUGH and not label.startswith(("ragged", "maxsr")) and not torch.equal(
                        got[0][0], ops[PASS_THROUGH[name]][0]):  # MaxSR's pairs have no drop-path
                    failed.append(f"{name} [{label}] batch {batch} {dtype}: a dropped sample is not passed through")
                del got, want
                torch.cuda.empty_cache()
    if failed:
        raise AssertionError("training kernels disagree with their plain versions: " + "; ".join(failed))
    return errors


def _unit_batch(dev: torch.device, batch: int, seed: int, crop: int = TRAIN_CROP):
    rng = np.random.default_rng(seed)
    lq = rng.integers(0, 256, (batch, crop, crop, 3), dtype=np.uint8)
    gt = rng.integers(0, 256, (batch, 4 * crop, 4 * crop, 3), dtype=np.uint8)
    return torch.from_numpy(lq).to(dev), torch.from_numpy(gt).to(dev)


def train_grads(model, dev: torch.device, seed: int, grad_runs=GRAD_RUNS, crop: int = TRAIN_CROP,
                batch: int = CHECK_BATCH, recompute: tuple = ("_AttentionPair",)) -> dict:
    """Loss and every parameter's gradient of the port's ``model`` (SwinIR or
    HAT, f32 weights from ``seed``) at batch 4 (``batch``) of ``crop``² LR maps, one run for each (path,
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

    ``grad_runs`` lists the (path, dtype) runs, the f64 witness first. The
    plain runs recompute the modules whose class ``recompute`` names in the
    backward (``recomputed``).

    Returns {(path, dtype): (loss, {name: grad}, launches, (L1 signs,
    ReLU sides) unlike the witness's)}."""
    module = model.module.train()
    lq, gt = _unit_batch(dev, batch, seed + 3, crop)
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
    pairs = [m for m in module.modules() if type(m).__name__ in recompute]
    try:
        for path, dtype in grad_runs:
            for pair in pairs:  # the plain runs recompute each such module (MaxSR's attention pairs) in the backward
                if path == "plain":
                    pair.forward = recomputed(pair)
                else:
                    pair.__dict__.pop("forward", None)
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
        for pair in pairs:
            pair.__dict__.pop("forward", None)
        module.fused_train = False
    return runs


def recomputed(module: torch.nn.Module):
    """``module``'s forward under activation checkpointing: the backward
    recomputes it from its input and the parameters it was called with (the
    run's leaves, handed in explicitly, so the recomputation sees them after
    ``functional_call`` has put the module's own back). A MaxSR attention
    pair draws nothing at random, so the recomputation is the forward; the
    plain f64 witness then holds one pair's scores at a time, not all 32.
    HAT's window attention and OCAB draw nothing at random either (its drop
    path is drawn in the HAB around them)."""
    forward = module.forward

    def run(*args, **kwargs):
        if getattr(module, "_recomputing", False):
            return forward(*args, **kwargs)
        names, params = zip(*module.named_parameters())

        def fn(x, *leaves):
            module._recomputing = True
            try:
                return functional_call(module, dict(zip(names, leaves)), (x, *args[1:]), kwargs)
            finally:
                module._recomputing = False

        return torch.utils.checkpoint.checkpoint(fn, args[0], *params, use_reentrant=False)

    return run


def grad_report(runs: dict, seed: int, label: str = "", zero_grads: tuple = (), batch: int = CHECK_BATCH) -> dict:
    """Every run's loss and gradients against the f64 witness, logged; the
    parameters named by the suffixes ``zero_grads`` against the norm of all
    the reference's gradients. Returns {(path, dtype): {"loss": rel, "all":
    rel_l2, "params": {name: rel_l2}}} plus the fused f32 run against the
    plain f32 run under ("fused-vs-plain", f32)."""
    ref_loss, ref, _, _ = runs[("plain", torch.float64)]
    names = list(ref)
    ref_all = torch.cat([ref[k].flatten() for k in names])

    def compare(loss, grads, ref_loss, ref, ref_all):
        norm = float(torch.linalg.vector_norm(ref_all.double()))
        return {
            "loss": abs(loss - ref_loss) / abs(ref_loss),
            "all": rel_l2(torch.cat([grads[k].flatten() for k in names]), ref_all),
            "params": {k: (float(torch.linalg.vector_norm(grads[k].double() - ref[k].double())) / norm
                           if k.endswith(zero_grads) else rel_l2(grads[k], ref[k])) for k in names},
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
        tables = [v for v, k in params if k.endswith(("bias_table", "rel_pos_bias.weight"))] or [float("nan")]
        others = [(v, k) for v, k in params if not k.endswith(("bias_table", "rel_pos_bias.weight"))]
        against = "plain f32" if path == "fused-vs-plain" else "f64 plain"
        flips = "" if r["flipped"] is None else (
            f"; kinks on the other side from the witness: L1 {r['flipped'][0]}, ReLU {r['flipped'][1]}")
        log(f"{label}grads seed {seed} {path} {str(dtype)[6:]} vs {against}, batch {batch}: "
            f"loss rel {r['loss']:.3e}"
            f"{flips}; all gradients rel_l2 {r['all']:.3e}; per parameter median {params[len(params) // 2][0]:.3e}, "
            f"worst {params[0][0]:.3e} ({params[0][1]}); bias tables median {float(np.median(tables)):.3e} "
            f"worst {max(tables):.3e}; others worst {others[0][0]:.3e} ({others[0][1]})")
    return report


def phase_train_grads(dev: torch.device, name: str = "swinir") -> None:
    """The fused-train module's loss and gradients, f32 and bf16, and the
    plain f32 and bf16 controls, against an f64 witness: plain autograd of
    the port's SwinIR (or HAT, or MaxSR in both modes) in f64 on the same
    weights, batch and drop-path (dropsample) draws."""
    if name == "maxsr":  # both modes, the adaptive one (the default) first
        for adaptive in (True, False):
            model = MaxSR.build(**{**MAXSR_MAIN, "adaptive": adaptive}, seed=SEED, device=dev)
            hold_grads(dev, model, MAXSR_PER_STEP, f"maxsr {'adaptive' if adaptive else 'static'} ", MAXSR_GRAD_RULES)
        return
    if name == "swinir":
        model, per_step, label = SwinIR.build(**TRAIN_MODEL, seed=SEED, device=dev), PER_STEP, ""
    else:
        model, per_step, label = HAT.build(**HAT_TRAIN_MODEL, seed=SEED, device=dev), HAT_PER_STEP, "hat "
    hold_grads(dev, model, per_step, label)


def hold_grads(dev: torch.device, model, per_step: dict, label: str, rules: dict = GRAD_RULES,
               crop: int = TRAIN_CROP, batch: int = CHECK_BATCH, recompute: tuple = ("_AttentionPair",)) -> None:
    """``train_grads`` of ``model`` held to the limits of PERF.md section 2,
    its f32 run and its zero-gradient parameters as ``rules`` says."""
    runs = train_grads(model, dev, SEED, crop=crop, batch=batch, recompute=recompute)
    del model
    report = grad_report(runs, SEED, label, rules["zero_grads"], batch)
    failed = []
    for (path, dtype), (_, grads, launches, _) in runs.items():
        expected = per_step if path == "fused" else {}
        if any(launches.get(k, 0) != expected.get(k, 0) for k in set(launches) | set(expected)):
            failed.append(f"{path} {dtype}: launches {launches}, expected {expected}")
        if not all(torch.isfinite(g).all() for g in grads.values()):
            failed.append(f"{path} {dtype}: non-finite gradients")
        if path == "fused":
            failed += train_entry_failures(f"{label}grads fused {dtype}", launches, dtype, GRAD_ENTRIES[(path, dtype)])
    f32, bf16 = report[rules["f32_against"]], report[("fused", torch.bfloat16)]
    against = "plain autograd in f32" if rules["f32_against"][0] == "fused-vs-plain" else "the f64 witness"
    control = report[("plain", torch.bfloat16)]["params"]
    worst32 = max(f32["params"].values())
    worst16 = max(bf16["params"].values())
    limits16 = {k: max(GRAD_BF16_REL_L2, GRAD_BF16_CONTROL * control[k]) for k in bf16["params"]}
    raised = {k: round(v, 4) for k, v in limits16.items() if v > GRAD_BF16_REL_L2}
    log(f"{label}grads held: fused f32 vs {against}: loss rel {f32['loss']:.3e} and each parameter (worst "
        f"{worst32:.3e}) <= {GRAD_F32_REL_L2:.0e}; fused bf16 loss rel {bf16['loss']:.3e} and all gradients "
        f"{bf16['all']:.3e} <= {GRAD_BF16_REL_L2:.0e}, each parameter (worst {worst16:.3e}) <= "
        f"{GRAD_BF16_REL_L2:.0e} or {GRAD_BF16_CONTROL:g}x the plain bf16 control's error (limits above "
        f"{GRAD_BF16_REL_L2:.0e}: {raised})")
    if max(f32["loss"], worst32) > GRAD_F32_REL_L2:
        failed.append(f"f32 fused gradients disagree with {against}")
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
             eval_interval: int = TRAIN_STEPS, ckpt_path: Path = TRAIN_DIR, evaluator=None) -> Trainer:
    def criterion(pred, target):
        loss = l1_loss(pred, target)
        losses.append(loss.detach())
        return loss

    if model is None:
        model = SwinIR.build(**TRAIN_MODEL, seed=seed, device=dev)
    return Trainer(model, MemoryPairs(SEED), evaluator, batch_size=TRAIN_BATCH, num_workers=4, max_iters=steps,
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
    if name.startswith("fused_window_attention_block"):
        n = ops[7].shape[-1]  # tokens a window: the window's own, not its padding to whole tiles
        flops = 2 * tokens * c * 4 * c + 4 * tokens * n * c
        moved = 2 * nbytes(x) + nbytes(*ops[1:])
    elif name.startswith("attention_bwd"):
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


def yardstick_report(name: str, ops, ms: float, bms: float, kw: dict) -> float:
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
    return yard


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
    ocab = prep["ocab"][0]
    # bf16 serving hands B10 one blob (q|k|v, proj, fc1, fc2 packed at load
    # time) and the bias in bf16; the plain version gets the weights back dense
    dense = (unpack_ocab_block(ocab["wqkv"], c, heads, ocab["b1"].numel()) if ocab["wproj"] is None else None)
    cases.append(("fused_ocab_block", "border windows", lambda *o: fused_ocab_block(*o, **kw),
                  lambda *o, dense=dense: ocab_plain(*(o if dense is None else dense_ocab(o, dense)), **kw),
                  (x, *ocab.values())))
    return cases


def dense_ocab(ops, dense) -> tuple:
    """B10's operands (x first) with the weights ``dense`` = (wqkv, wproj, w1,
    w2) in place of the blob."""
    wqkv, wproj, w1, w2 = dense
    return (*ops[:3], wqkv, ops[4], wproj, *ops[6:10], w1, ops[11], w2, ops[13])


def phase_hat_kernels(model: HAT, dev: torch.device) -> dict:
    """The HAT kernels against their plain versions, f32 then bf16, every
    output held to the serving kernels' rule; the f32 launches of B5 at
    window 16 and of B6's join through the entries ``TRAIN_ENTRIES`` names,
    and the kernels of ``BITWISE`` (bf16) and ``BITWISE_F32`` (f32) launched
    twice for the same bits. Returns the bf16 max abs error of each
    kernel's first output, and the f32 one of B6's join, B11 and B10 under
    their ``HAT_F32_ROWS`` names."""
    errors: dict = {}
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, label, kernel, plain, ops in hat_kernel_cases(model, dev, dtype):
            engagement.reset()
            got = _flat(kernel(*ops))
            torch.cuda.synchronize()
            if dtype == torch.float32:
                failed += train_entry_failures(f"{name} [{label}] f32", engagement.counters(), dtype)
            if name in (BITWISE if dtype == torch.bfloat16 else BITWISE_F32):
                same = all(torch.equal(a, b) for a, b in zip(got, _flat(kernel(*ops))))
                log(f"check {name} [{label}] {str(dtype)[6:]}: two launches give the same bits: {same}")
                if not same:
                    failed.append(f"{name} [{label}]: two launches differ")
            want = _flat(plain(*[None if t is None else t.float() for t in ops]))
            torch.cuda.synchronize()
            for i, (k, p) in enumerate(zip(got, want)):
                err = kernel_check(f"{name} [{label}] output {i}", k, p, dtype, failed)
                if dtype == torch.bfloat16 and i == 0:
                    errors[name] = max(errors.get(name, 0.0), err)
                elif name + "_f32" in HAT_F32_ROWS and i == 0:
                    errors[name + "_f32"] = max(errors.get(name + "_f32", 0.0), err)
            del got, want
    if failed:
        raise AssertionError("HAT kernels disagree with their plain versions: " + "; ".join(failed))
    return errors


def phase_hat_end_to_end(model: HAT, dev: torch.device) -> dict:
    """Fused vs plain HAT forward (f32, its launches of B11, B5 at window
    16, B6's join and B10, ``HAT_PER_FORWARD`` of each, through the f32
    entries ``TRAIN_ENTRIES`` names; then bf16 against f32 plain), then the
    served requests with their launch counts. Returns the served launches
    and, under ``HAT_F32_ROWS``' names, the f32 forward's launches of B6's
    join, B11 and B10."""
    images = requests()
    x = torch.from_numpy(images[0]).to(dev).float()[None] / 255.0
    plain = model.enable_fused(False)(x)
    engagement.reset()
    fused = model.enable_fused(True)(x)
    torch.cuda.synchronize()
    launches32 = engagement.counters()
    failed = train_entry_failures("hat e2e f32", launches32, torch.float32)
    rel32 = rel_l2(fused, plain)
    log(f"hat e2e f32 fused vs plain: rel_l2 {rel32:.3e} limit {E2E_F32_REL_L2:.0e}; launches {launches32}")
    with torch.inference_mode():
        fwd32 = time_ms(lambda: model(x), iters=3, warmup=1)
        model.enable_fused(False)
        plain32 = time_ms(lambda: model(x), iters=2, warmup=1)
        model.enable_fused(True)
    b5 = launches32.get("fused_window_attention_block_ws16", 0)
    log(f"time hat x4 f32 forward {LR}x{LR}: fused {fwd32:.3f} ms (B5 at window 16 {b5} launches through its 3xTF32 "
        f"entry), plain {plain32:.3f} ms")
    for name in ("fused_window_attention_block_ws16", "fused_cab_body", "fused_ocab_block"):
        if launches32.get(name, 0) != HAT_PER_FORWARD[name]:
            failed.append(f"the f32 HAT forward launched {name} {launches32.get(name, 0)} times, expected "
                          f"{HAT_PER_FORWARD[name]}")
    model.half()
    fused16 = model(x)
    torch.cuda.synchronize()
    rel16 = rel_l2(fused16, plain)
    log(f"hat e2e bf16 fused vs f32 plain: rel_l2 {rel16:.3e} limit {E2E_BF16_REL_L2:.0e}")
    if launches32.get("fused_mlp_block_extra", 0) != HAT_PER_FORWARD["fused_mlp_block_extra"]:
        failed.append(f"the f32 HAT forward launched B6's join {launches32.get('fused_mlp_block_extra', 0)} times")
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
    return {**launches, **{row: launches32.get(name, 0) for row, name in HAT_F32_ROWS.items()}}


def hat_bounds(name: str, ops) -> tuple:
    """(flops, bytes) of one launch from its operands: each input read once,
    each output written once."""
    x = ops[0]
    c = x.shape[-1]
    tokens = x.numel() // c
    if name == "fused_cab_body":  # ops[3] may be packed: Cm from b1
        flops = 2 * 2 * tokens * 9 * c * ops[4].numel()
        moved = 2 * nbytes(x) + nbytes(*ops[1:]) + 4 * x.shape[0] * c  # + the f32 sums
    elif name == "fused_window_attention_block_ws16":
        n = HAT_MAIN["window_size"] ** 2
        flops = 2 * tokens * c * 4 * c + 4 * tokens * n * c
        moved = 2 * nbytes(x) + nbytes(*ops[1:])
    elif name == "fused_mlp_block_extra":  # ops[3] may be the packed blob: hidden from b1
        flops = 4 * tokens * c * ops[4].numel()
        moved = 2 * nbytes(x) + nbytes(*ops[1:])
    else:  # B10; ops[10] may be None (the blob): hidden from b1
        nk, hidden = ops[7].shape[-1], ops[11].numel()
        flops = 2 * tokens * c * 4 * c + 4 * tokens * nk * c + 4 * tokens * c * hidden
        moved = 2 * nbytes(x) + nbytes(*ops[1:])
    return flops, moved


def cab_yardstick(ops, ms: float, bms: float, row: str = "fused_cab_body") -> None:
    """B11's share of its bound, its ptxas line and its yardstick: the same
    function as a sequence of PyTorch calls in the map's dtype
    (``F.layer_norm``, channels-last cuDNN ``F.conv2d``, TF32 off in f32,
    the exact ``F.gelu``, ``F.conv2d``, the sum;
    scripts/torch_time_conv_kernels.py), timed here and never on the path,
    on the weights serving packed."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_time_conv_kernels import cab_sequence

    x, ln_w, ln_b, w1, b1, w2, b2 = ops
    c, cm = x.shape[-1], b1.numel()
    oihw = [unpack_cab_weights(w, *io, n) if w.dim() == 7 else unpack_conv3x3_f32_weights(w, *io, n) if w.dim() == 5
            else w for w, io, n in ((w1, (c, cm), 64), (w2, (cm, c), 96))]
    oihw = [w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last) for w in oihw]
    yard = time_ms(lambda: cab_sequence(x, ln_w, ln_b, oihw[0], b1.to(x.dtype), oihw[1], b2.to(x.dtype)), iters=10)
    log(f"  {row}: {100 * bms / ms:.1f} % of the bound; yardstick ({str(x.dtype)[6:]} PyTorch sequence) "
        f"{yard:.3f} ms, kernel / yardstick {ms / yard:.3f}; {ptxas_report(row)}")


def ocab_yardstick(ops, ms: float, bms: float, ws: int = HAT_MAIN["window_size"], row: str = "fused_ocab_block") -> float:
    """B10's share of its bound, its ptxas line and its yardstick: the same
    block as a sequence of PyTorch calls in the map's dtype (``F.layer_norm``,
    ``F.linear``, the unfold of the zero-padded k | v map, SDPA with the
    bias as its mask, the projection and the residual, the MLP half;
    scripts/torch_time_attn_kernels.py), timed here and never on the path,
    on the weights serving packed. No one PyTorch call computes the block,
    so its JSON row's library time stays null."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_time_attn_kernels import ocab_forward_sequence

    c, heads = ops[0].shape[-1], HAT_MAIN["num_heads"][0]
    if ops[5] is None:  # the blob's weights
        ops = dense_ocab(ops, unpack_ocab_block(ops[3], c, heads, ops[11].numel()))
    sequence = ocab_forward_sequence(ops[0], ops[1:], heads, ws, HAT_MAIN["overlap_ratio"], dtype=ops[0].dtype)
    yard = time_ms(sequence, iters=5, warmup=1)
    del sequence
    torch.cuda.empty_cache()
    log(f"  {row}: {100 * bms / ms:.1f} % of the bound; yardstick ({str(ops[0].dtype)[6:]} PyTorch sequence) "
        f"{yard:.3f} ms, kernel / yardstick {ms / yard:.3f}; {ptxas_report(row)}")
    return yard


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
        elif name == "fused_cab_body":
            cab_yardstick(ops, ms, bms)
        elif name == "fused_ocab_block":
            ocab_yardstick(ops, ms, bms)
    # B6's join, B11 and B10 in f32 (the f32 HAT forward's), bound at 3xTF32;
    # B11 and B10 beside the same function as a sequence of f32 PyTorch calls
    f32_cases = {c[0]: c for c in hat_kernel_cases(model, dev, torch.float32)}
    for row, name in HAT_F32_ROWS.items():
        _, label, kernel, plain, ops = f32_cases[name]
        ms = time_ms(lambda: kernel(*ops), iters=10)
        plain_ms = time_ms(lambda: plain(*ops), iters=3, warmup=1)
        flops, moved = hat_bounds(name, ops)
        t_ops, t_bytes = flops / PEAK_TF32X3_FLOPS, moved / PEAK_BYTES
        bms, by = 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
        source, replaces = KERNELS[row]
        rows.append(dict(name=row, route="cuda", source=source, replaces=replaces, launches=launches.get(row, 0),
                         max_abs_err=errors[row], ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=None))
        log(f"time {row} [{label}] f32: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}, 3xTF32; the "
            f"FMA pipes {1e3 * flops / PEAK_FMA_FLOPS:.4f} ms), {flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB; "
            f"launches {launches.get(row, 0)} in the f32 forward; {100 * bms / ms:.1f} % of the bound; "
            f"{ptxas_report(row)}")
        if name == "fused_cab_body":
            cab_yardstick(ops, ms, bms, row)
        elif name == "fused_ocab_block":
            ocab_yardstick(ops, ms, bms, row=row)
    del f32_cases, ops
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
        # the path's bias in its dtype, as the bf16 step gathers it from its bf16 table (B12 reads it so); f32 else
        bias = (torch.randn(hh, nq, nk, generator=gen) * 2.0).to(dev, dtype if label == "path" else torch.float32)
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
        else:
            log(f"  {name}: {100 * bms / ms:.1f} % of the bound; kernel / library {ms / library_ms:.3f}; "
                f"{ptxas_report(name)}")
        source, replaces = KERNELS[name]
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches.get(name, 0),
                         max_abs_err=errors[name], ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=library_ms))
    log(f"hat train step: kernels {kernel_total:.1f} ms (B6, B7 at SwinIR's step times), the rest (CAB convs, "
        f"OCAB projections and MLP, LayerNorms, tail, loss, optimizer, gaps) {step_ms - kernel_total:.1f} ms")
    return rows


def phase_hat_train_f32(dev: torch.device) -> list:
    """HAT x4's f32 training, the JAX Trainer's ``bfloat16=False``:
    ``Trainer.run`` for HAT_F32_TRAIN_STEPS steps at batch 32 of 64x64
    crops, fused_train on: the launches a step (HAT_PER_STEP), every f32
    launch through its entry (TRAIN_ENTRIES: B5 and B9 at window 16 through
    the 3xTF32 ``window_attention16_mma_f32`` and ``attn_bwd16_mma_f32``;
    B13 through ``oca_core_bwd_mma_f32``, F32_ENTRIES), finite losses, moved
    weights; step ms, images/s and peak memory over 3 steps after a warm-up.
    Then B13 at the step's shapes (512 windows, 6 heads, 256 | 576, d 30, the
    OCAB's views, an f32 bias), and B5 and B9 at window 16 (batch 32 of 64 x
    64 maps, block 1's weights, shift 8, drop-path scales, an f32 bias),
    each against its plain version, twice for the same bits, timed beside
    its plain version and its bound at 3xTF32, B13 beside SDPA's f32
    backward and B5 / B9 beside the same function as a sequence of f32
    PyTorch calls: the ``oca_core_bwd_f32``,
    ``fused_window_attention_block_ws16_f32`` and ``attention_bwd_ws16_f32``
    rows."""
    shutil.rmtree(HAT_F32_TRAIN_DIR, ignore_errors=True)
    model = HAT.build(**HAT_TRAIN_MODEL, seed=SEED, device=dev)
    losses: list = []

    def criterion(pred, target):
        loss = l1_loss(pred, target)
        losses.append(loss.detach())
        return loss

    steps = HAT_F32_TRAIN_STEPS
    trainer = Trainer(model, MemoryPairs(SEED), batch_size=TRAIN_BATCH, bfloat16=False, num_workers=4,
                      max_iters=steps, eval_interval=steps + 1, ckpt_path=str(HAT_F32_TRAIN_DIR), seed=SEED,
                      log_interval=100, loss_function=criterion)
    before = {k: p.detach().clone() for k, p in model.module.named_parameters()}
    engagement.reset()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, entries = engagement.counters(), engagement.entries()
    values = [float(v) for v in losses]
    log(f"\nhat trained {steps} steps in f32 in {seconds:.3f} s (host clock, first steps included); bf16 "
        f"{trainer.bfloat16}, fused_train {trainer.fused_train}; launches {launches}; losses "
        f"{[round(v, 6) for v in values]}")
    failed = []
    if trainer.bfloat16 or not trainer.fused_train:
        failed.append("the f32 HAT trainer did not run f32 with fused_train on the card")
    for name in set(launches) | set(HAT_PER_STEP):
        if launches.get(name, 0) != HAT_PER_STEP.get(name, 0) * steps:
            failed.append(f"hat f32 {name}: {launches.get(name, 0)} launches in {steps} steps, expected "
                          f"{HAT_PER_STEP.get(name, 0)} a step")
    failed += train_entry_failures("hat f32 trainer", launches, torch.float32, entries)
    failed += f32_entry_failures("hat f32 trainer", launches)
    if len(values) != steps or not all(np.isfinite(values)):
        failed.append(f"hat f32 losses {values}")
    moved = sum(not torch.equal(p.detach(), before[k]) for k, p in model.module.named_parameters())
    if moved != len(before):
        failed.append(f"only {moved} of {len(before)} HAT parameters changed in f32")
    shutil.rmtree(HAT_F32_TRAIN_DIR, ignore_errors=True)
    del before, trainer

    module = model.module
    module.fused_train = True
    tx = build_optimizer()
    state = prepare_state(module, tx)
    step = make_train_step(module, tx, l1_loss, bfloat16=False)
    lq, gt = _unit_batch(dev, TRAIN_BATCH, SEED + 4)
    gen = torch.Generator().manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(state, lq, gt, gen), iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    module.fused_train = False
    del state, tx, step
    torch.cuda.empty_cache()
    log(f"hat train step f32 batch {TRAIN_BATCH} {TRAIN_CROP}x{TRAIN_CROP}: {step_ms:.3f} ms, "
        f"{TRAIN_BATCH / (step_ms / 1e3):.1f} images/s, peak memory {peak:.2f} GiB")

    cases = {(name, label): (kernel, plain, o) for name, label, kernel, plain, o in
             hat_train_kernel_cases(model, dev, torch.float32, TRAIN_BATCH)}
    ops = cases[("oca_core_bwd", "path")][2]
    shifted = f"shift {HAT_MAIN['window_size'] // 2}"
    ws16 = {name: cases[(name, shifted)] for name in ("fused_window_attention_block_ws16", "attention_bwd_ws16")}
    del model, cases
    engagement.reset()
    got = oca_core_bwd(*ops)
    again = oca_core_bwd(*ops)
    torch.cuda.synchronize()
    if engagement.entries() != {"oca_core_bwd": {"oca_core_bwd_mma_f32": 2}}:
        failed.append(f"oca_core_bwd f32 at the step's shapes: entries {engagement.entries()}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        failed.append("oca_core_bwd f32 at the step's shapes: two launches differ")
    want = oca_core_bwd_plain(*ops)
    errs = [kernel_check(f"oca_core_bwd [hat f32 step, {TRAIN_BATCH * 16} windows] output {i}", a, e,
                         torch.float32, failed) for i, (a, e) in enumerate(zip(got, want))]
    del got, again, want
    torch.cuda.empty_cache()
    ms = time_ms(lambda: oca_core_bwd(*ops), iters=5)
    plain_ms = time_ms(lambda: oca_core_bwd_plain(*ops), iters=2, warmup=1)
    library_ms = sdpa_ms("oca_core_bwd", ops)
    flops, moved_bytes = oca_bounds("oca_core_bwd", ops)
    bms, by = bound_ms(flops, moved_bytes, PEAK_TF32X3_FLOPS)
    per = HAT_PER_STEP["oca_core_bwd"]
    log(f"time oca_core_bwd f32 [hat f32 step, {TRAIN_BATCH * 16} windows]: {ms:.3f} ms ({100 * per * ms / step_ms:.1f} "
        f"% of the f32 step at {per} a step), plain {plain_ms:.3f} ms, bound {bms:.4f} ms at 3xTF32 ({by}; the FMA "
        f"pipes {1e3 * flops / PEAK_FMA_FLOPS:.4f}), library (SDPA f32 backward with the mask's gradient) "
        f"{library_ms if library_ms is None else round(library_ms, 4)} ms, {flops / 1e9:.2f} GFLOP, "
        f"{moved_bytes / 1e6:.1f} MB; kernel / library "
        f"{'none' if library_ms is None else round(ms / library_ms, 3)}, {100 * bms / ms:.1f} % of the bound; "
        f"{ptxas_report('oca_core_bwd_f32')}")
    del ops
    torch.cuda.empty_cache()
    source, replaces = KERNELS["oca_core_bwd_f32"]
    rows = [dict(name="oca_core_bwd_f32", route="cuda", source=source, replaces=replaces,
                 launches=launches.get("oca_core_bwd", 0), max_abs_err=errs[0], ms=ms, plain_ms=plain_ms, bound_ms=bms,
                 bound_by=by, library_ms=library_ms)]
    rows += hat_f32_ws16_rows(ws16, launches, step_ms, shifted, dev, failed)
    if failed:
        raise AssertionError("; ".join(failed))
    return rows


def phase_ws16_f32_first_design(dev: torch.device) -> None:
    """f32 B5 and its backward at windows 9-16 on the geometries the 3xTF32
    kernels decline (``WS16_F32_FIRST_DESIGN_*``, and C11's
    ``WS16_F32_C11`` at their windows): against their plain versions at the
    f32 limit, shift 0 and ws / 2, with and without a drop-path scale, every
    launch through ``window_attention16_f32`` / ``attn_bwd16_f32``
    (``large_window_checks`` on the ``_ws16`` family); first, at
    ``WS16_F32_DECLINED``, above the first design's widest f32 C, both
    wrappers raise NotImplementedError and launch nothing. Then the first
    designs of f32 B11 and B10 (``cab_body_f32``, ``ocab_f32``) at the
    geometries their 3xTF32 kernels decline (``HAT_F32_FIRST_DESIGN_*``)
    against their plain versions."""
    failed = []
    start = time.perf_counter()
    c, heads = WS16_F32_DECLINED
    ws = WS16_F32_FIRST_DESIGN_WINDOWS[1]
    x, g, ops = large_window_ops(dev, torch.float32, c, heads, ws, (1, ws, ws), SEED + c)
    kw = dict(heads=heads, window_size=ws, shift=ws // 2)
    engagement.reset()
    for name, fn in (("fused_window_attention_block", lambda: fused_window_attention_block(x, *ops, **kw)),
                     ("attention_bwd", lambda: attention_bwd(x, g, *ops, **kw))):
        try:
            fn()
            failed.append(f"{name} f32 at window {ws}, C {c}: no error")
        except NotImplementedError as err:
            log(f"check {name} f32 at window {ws}, C {c} / {heads} heads declines: {err}")
    if engagement.counters():
        failed.append(f"the declined f32 geometry launched {engagement.counters()}")
    del x, g, ops
    large_window_checks(dev, failed, WS16_F32_FIRST_DESIGN_WINDOWS, WS16_F32_FIRST_DESIGN_GEOMETRIES, "_ws16")
    for ws, geometry in WS16_F32_C11:
        large_window_checks(dev, failed, (ws,), (geometry,), "_ws16")
    hat_f32_first_design_checks(dev, failed)
    log(f"ws16 f32 first design: kernel checks in {time.perf_counter() - start:.1f} s")
    if failed:
        raise AssertionError("ws16 f32 first design: " + "; ".join(failed))


def hat_f32_first_design_checks(dev: torch.device, failed: list) -> None:
    """f32 B11 and B10 on their first designs (``cab_body_f32``,
    ``ocab_f32``) at the geometries their 3xTF32 kernels decline
    (``HAT_F32_FIRST_DESIGN_CAB`` / ``_OCAB``, a 24 x 40 map and HAT's
    window 16 on a 32 x 48 one) against their plain versions at the f32
    limit, each launch through its first-design entry."""
    gen = torch.Generator().manual_seed(SEED + 48)
    r = lambda *size, k=1.0: (torch.randn(*size, generator=gen) * k).to(dev)  # noqa: E731
    engagement.reset()
    for c, cm in HAT_F32_FIRST_DESIGN_CAB:
        x = r(1, 24, 40, c)
        ops = [1 + r(c, k=0.1), r(c, k=0.1), r(3, 3, c, cm, k=(9 * c) ** -0.5), r(cm, k=0.1),
               r(3, 3, cm, c, k=(9 * cm) ** -0.5), r(c, k=0.1)]
        for i, (a, e) in enumerate(zip(fused_cab_body(x, *ops), cab_body_plain(x, *ops))):
            kernel_check(f"fused_cab_body f32 first design [C {c}, Cm {cm}] output {i}", a, e, torch.float32, failed)
    ws, overlap = HAT_MAIN["window_size"], HAT_MAIN["overlap_ratio"]
    owin, _ = overlap_window(ws, overlap)
    for c, heads, hidden in HAT_F32_FIRST_DESIGN_OCAB:
        x = r(1, 2 * ws, 3 * ws, c)
        ops = [1 + r(c, k=0.1), r(c, k=0.1), r(c, 3 * c, k=c**-0.5), r(3 * c, k=0.1), r(c, c, k=c**-0.5),
               r(c, k=0.1), r(heads, ws * ws, owin * owin, k=0.5), 1 + r(c, k=0.1), r(c, k=0.1),
               r(c, hidden, k=c**-0.5), r(hidden, k=0.1), r(hidden, c, k=hidden**-0.5), r(c, k=0.1)]
        kw = dict(heads=heads, window_size=ws, overlap_ratio=overlap)
        kernel_check(f"fused_ocab_block f32 first design [C {c}, {heads} heads, hidden {hidden}]",
                     fused_ocab_block(x, *ops, **kw), ocab_plain(x, *ops, **kw), torch.float32, failed)
    torch.cuda.synchronize()
    want = {"fused_cab_body": {"cab_body_f32": len(HAT_F32_FIRST_DESIGN_CAB)},
            "fused_ocab_block": {"ocab_f32": len(HAT_F32_FIRST_DESIGN_OCAB)}}
    log(f"check f32 B11 / B10 first designs: entries {engagement.entries()}")
    if engagement.entries() != want:
        failed.append(f"the f32 first designs of B11 / B10 took {engagement.entries()}, expected {want}")


def hat_f32_ws16_rows(ws16: dict, launches: dict, step_ms: float, label: str, dev: torch.device,
                      failed: list) -> list:
    """B5 and B9 in f32 at HAT's f32 step (``ws16``: {name: (kernel, plain,
    operands)} at ``label``'s shift) against their plain versions, each
    launched twice through its 3xTF32 entry for the same bits, then timed
    beside its plain version, its bound at 3xTF32 (the FMA pipes' beside
    it) and the same function as a sequence of f32 PyTorch calls
    (scripts/torch_time_attn_kernels.py: cuBLAS with TF32 off, SDPA with the
    bias and shift mask as its mask, LayerNorm; the backward by
    ``torch.autograd.grad``), timed here and never on the path. No one
    PyTorch call computes either function, so their rows' library time is
    null. Returns the ``*_ws16_f32`` rows."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_time_attn_kernels import attention_half_forward_sequence, attention_half_sequence

    ws, heads = HAT_MAIN["window_size"], HAT_MAIN["num_heads"][0]
    kw = kw_of(label, ws, TRAIN_BATCH, dev)
    rows = []
    for name, (kernel, plain, ops) in ws16.items():
        entry = TRAIN_ENTRIES[torch.float32][name]
        engagement.reset()
        got = _flat(kernel(*ops))
        again = _flat(kernel(*ops))
        torch.cuda.synchronize()
        if engagement.entries() != {name: {entry: 2}}:
            failed.append(f"{name} f32 at the step's shapes: entries {engagement.entries()}, expected {entry}")
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"check {name} [hat f32 step, {label}] f32: two launches give the same bits: {same}")
        if not same:
            failed.append(f"{name} f32 at the step's shapes: two launches differ")
        want = _flat(plain(*ops))
        errs = [kernel_check(f"{name} [hat f32 step, {label}] output {i}", a, e, torch.float32, failed)
                for i, (a, e) in enumerate(zip(got, want))]
        del got, again, want
        torch.cuda.empty_cache()
        ms = time_ms(lambda: kernel(*ops), iters=5)
        plain_ms = time_ms(lambda: plain(*ops), iters=2, warmup=1)
        if name == "attention_bwd_ws16":
            sequence = attention_half_sequence(ops[0], ops[1], ops[2:], heads, ws, kw["shift"], kw["drop_path"],
                                               dtype=torch.float32)
        else:
            sequence = attention_half_forward_sequence(ops[0], ops[1:], heads, ws, kw["shift"], kw["drop_path"],
                                                       dtype=torch.float32)
        seq_ms = time_ms(sequence, iters=3, warmup=1)
        del sequence
        torch.cuda.empty_cache()
        flops, moved = train_bounds(name, ops)
        bms, by = bound_ms(flops, moved, PEAK_TF32X3_FLOPS)
        per = HAT_PER_STEP[name]
        log(f"time {name} f32 [hat f32 step, {label}]: {ms:.3f} ms ({100 * per * ms / step_ms:.1f} % of the f32 step "
            f"at {per} a step), plain {plain_ms:.3f} ms, bound {bms:.4f} ms at 3xTF32 ({by}; the FMA pipes "
            f"{1e3 * flops / PEAK_FMA_FLOPS:.4f}), yardstick (f32 PyTorch sequence) {seq_ms:.3f} ms, "
            f"{flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB; kernel / yardstick {ms / seq_ms:.3f}, "
            f"{100 * bms / ms:.1f} % of the bound; {ptxas_report(name + '_f32')}")
        source, replaces = KERNELS[name + "_f32"]
        rows.append(dict(name=name + "_f32", route="cuda", source=source, replaces=replaces,
                         launches=launches.get(name, 0), max_abs_err=errs[0], ms=ms, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by, library_ms=None))
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
            entry = "upsample_s_mma_bf16" if dtype == torch.bfloat16 else "upsample_s_mma_f32"
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


def phase_resblock_kernels(dev: torch.device) -> dict:
    """B14 against its plain version, f32 then bf16, at SwinFIR's map (the
    path's LeakyReLU 0.2 / res_scale 1, and ReLU / 0.1) and at a ragged odd
    height (every activation and scale), each f32 launch through its 3xTF32
    entry. Returns {dtype: max abs error at the path's variant}."""
    failed, errors = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for si, shape in enumerate(RESBLOCK_SHAPES):
            for activation, res_scale in RESBLOCK_VARIANTS[: 2 if si == 0 else 4]:
                ops = resblock_ops(dev, dtype, shape, SEED + 20 + si)
                engagement.reset()
                got = fused_resblock(*ops, res_scale=res_scale, activation=activation)
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    failed += f32_entry_failures(f"B14 f32 {shape}", engagement.counters())
                want = resblock_plain(*[t.float() for t in ops], res_scale=res_scale, activation=activation)
                part = f"fused_resblock [{'x'.join(map(str, shape))} {activation} res_scale {res_scale}]"
                err = kernel_check(part, got, want, dtype, failed)
                if si == 0 and res_scale == 1.0:
                    errors[dtype] = err
                del got, want
    if failed:
        raise AssertionError("B14 disagrees with its plain version: " + "; ".join(failed))
    return errors


def phase_swinfir_serving(dev: torch.device, errors: dict) -> list:
    """SwinFIR x4 at full width: fused vs plain (f32, bf16 against f32
    plain; the f32 forward's B1, B14 and B3 launches through their 3xTF32
    entries), uint8 fused vs plain in f32, three bf16 requests with their
    launch counts, the forwards' times (bf16 fused; f32 fused and plain) and
    B14's time at the path's shapes in bf16 and in f32. Returns B14's JSON
    rows (bf16, f32)."""
    model = SwinFIR.build(**MAIN, seed=SEED, device=dev)
    log(f"\nmodel: SwinFIR x4 embed {MAIN['embed_dim']} depths {MAIN['depths']}, {model.count_parameters()} parameters")
    images = requests()
    x = torch.from_numpy(images[0]).to(dev).float()[None] / 255.0
    plain = model.enable_fused(False)(x)
    plain8 = model.inference(images[0])
    prep32 = model.enable_fused(True).serving_prep()  # the f32 load-time layout, outside the counted forward
    engagement.reset()
    fused = model(x)
    torch.cuda.synchronize()
    launches32 = engagement.counters()
    failed = f32_entry_failures("swinfir f32 forward", launches32)
    failed += [f"swinfir f32 forward: {name} {launches32.get(name, 0)} launches, expected {per}"
               for name, per in SWINFIR_PER_FORWARD.items() if launches32.get(name, 0) != per]
    fused8 = model.inference(images[0])
    torch.cuda.synchronize()
    rel32 = rel_l2(fused, plain)
    diff = np.abs(fused8.astype(int) - plain8.astype(int))
    fwd32 = time_ms(lambda: model(x), iters=3)
    model.enable_fused(False)
    plain32 = time_ms(lambda: model(x), iters=2, warmup=1)
    model.enable_fused(True)
    log(f"swinfir forward f32 batch 1 {LR}x{LR} (TF32 off): fused {fwd32:.3f} ms, plain {plain32:.3f} ms")
    row32 = resblock_f32_row(prep32["convs"][0], launches32.get("fused_resblock", 0), errors[torch.float32], dev,
                             fwd32)
    model.half()
    fused16 = model(x)
    torch.cuda.synchronize()
    rel16 = rel_l2(fused16, plain)
    log(f"swinfir e2e fused vs plain: f32 rel_l2 {rel32:.3e} limit {E2E_F32_REL_L2:.0e}; uint8 f32 max diff "
        f"{diff.max()} LSB on {100 * (diff > 0).mean():.4f} % of values; bf16 vs f32 plain rel_l2 {rel16:.3e} limit "
        f"{E2E_BF16_REL_L2:.0e}")
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
               launches=launches.get("fused_resblock", 0), max_abs_err=errors[torch.bfloat16], ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)
    del model
    torch.cuda.empty_cache()
    return [row, row32]


def resblock_f32_row(pair: dict, launches: int, error: float, dev: torch.device, fwd: float) -> dict:
    """B14 in f32 (both passes on the 3xTF32 conv written for the H100) at
    SwinFIR's map, on the weights serving lays out in f32: time, plain time,
    bound at 3xTF32 (the FMA pipes' floor logged) and cuDNN's two f32 convs
    + leaky_relu + add (TF32 off)."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 22)
    xb = torch.randn(*RESBLOCK_SHAPES[0], generator=gen).to(dev)
    c = xb.shape[-1]
    ops = (xb, pair["s0"], pair["b0"], pair["s2"], pair["b2"])
    ms = time_ms(lambda: fused_resblock(*ops, activation="lrelu0.2"), iters=10)
    plain_ms = time_ms(lambda: resblock_plain(*ops, activation="lrelu0.2"), iters=5)
    w1o, w2o = (unpack_conv3x3_f32_weights(w, c, c).permute(3, 2, 0, 1).contiguous() for w in (pair["s0"], pair["s2"]))

    def library():
        xc = xb.permute(0, 3, 1, 2)
        h1 = F.leaky_relu(F.conv2d(xc, w1o, pair["b0"], padding=1), 0.2)
        return xb + F.conv2d(h1, w2o, pair["b2"], padding=1).permute(0, 2, 3, 1)

    library_ms = time_ms(library, iters=10)
    flops = 2 * 2 * (xb.numel() // c) * 9 * c * c
    moved = 2 * nbytes(xb) + nbytes(w1o, pair["b0"], w2o, pair["b2"])
    bms, by = bound_ms(flops, moved, PEAK_TF32X3_FLOPS)
    per = SWINFIR_PER_FORWARD["fused_resblock"]
    log(f"time fused_resblock_f32 [lrelu0.2] at {'x'.join(map(str, xb.shape))}: {ms:.3f} ms ({100 * per * ms / fwd:.1f} "
        f"% of the f32 forward at {per} a forward), plain {plain_ms:.3f} ms, bound {bms:.4f} ms at 3xTF32 ({by}; the "
        f"FMA pipes {flops / 66.9e9:.4f} ms), library (cuDNN f32 F.conv2d x2 + leaky_relu + add, TF32 off) "
        f"{library_ms:.4f} ms, {100 * bms / ms:.1f} % of the bound; {ptxas_report('fused_resblock_f32')}")
    source, replaces = KERNELS["fused_resblock_f32"]
    return dict(name="fused_resblock_f32", route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=error, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)


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


def swinfir_f32_rows(model, dev: torch.device, launches: dict, failed: list) -> list:
    """B5 and B8 (shift 4), B6 and B7 in f32 at SwinFIR's step shapes, with
    ``model``'s weights, on their f32 kernels written for the H100: every
    output against the plain version (the f32 rule), the time, the plain
    version's, the bound at 3xTF32 (the FMA pipes' beside it in the log),
    the same function as a sequence of f32 PyTorch calls (TF32 off; timed
    here, never on the path), the ptxas line; ``launches`` the trainer
    run's."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_time_attn_kernels import (
        attention_half_forward_sequence, attention_half_sequence, mlp_half_backward_sequence,
        mlp_half_forward_sequence,
    )

    rows = []
    for name, label, kernel, plain, ops in train_kernel_cases(model, dev, torch.float32, TRAIN_BATCH):
        if label in ("shift 0", "ragged rows"):
            continue
        row = f"{name}_f32"
        engagement.reset()
        got = _flat(kernel(*ops))
        torch.cuda.synchronize()
        failed += train_entry_failures(f"swinfir {row}", engagement.counters(), torch.float32)
        want = _flat(plain(*ops))
        err = max(kernel_check(f"swinfir {row} [{label}] output {i}", k, p, torch.float32, failed)
                  for i, (k, p) in enumerate(zip(got, want)))
        del got, want
        ms = time_ms(lambda: kernel(*ops), iters=10)
        plain_ms = time_ms(lambda: plain(*ops), iters=3, warmup=1)
        flops, moved = train_bounds(name, ops)
        t_ops, t_bytes = flops / PEAK_TF32X3_FLOPS, moved / PEAK_BYTES
        bms, by = 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
        kw = kw_of(label if label.startswith("shift") else "shift 0", MAIN["window_size"], TRAIN_BATCH, dev)
        if name == "attention_bwd":
            sequence = attention_half_sequence(ops[0], ops[1], ops[2:], kw["heads"], kw["window_size"], kw["shift"],
                                               kw["drop_path"], dtype=torch.float32)
        elif name == "fused_window_attention_block":
            sequence = attention_half_forward_sequence(ops[0], ops[1:], kw["heads"], kw["window_size"], kw["shift"],
                                                       kw["drop_path"], dtype=torch.float32)
        elif name == "fused_mlp_block":
            sequence = mlp_half_forward_sequence(ops[0], ops[1:7], kw["drop_path"], TRAIN_CROP * TRAIN_CROP,
                                                 dtype=torch.float32)
        else:
            sequence = mlp_half_backward_sequence(*ops[:2], ops[2:], kw["drop_path"], TRAIN_CROP * TRAIN_CROP,
                                                  dtype=torch.float32)
        yard = time_ms(sequence, iters=3, warmup=1)
        del sequence
        torch.cuda.empty_cache()
        source, replaces = KERNELS[row]
        rows.append(dict(name=row, route="cuda", source=source, replaces=replaces, launches=launches.get(name, 0),
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None))
        log(f"time {row} [{label}] f32 batch {TRAIN_BATCH}: {ms:.3f} ms ({PER_STEP[name] * ms:.1f} ms a step at "
            f"{PER_STEP[name]} a step), plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}, 3xTF32; "
            f"the FMA pipes {1e3 * flops / PEAK_FMA_FLOPS:.4f} ms), {flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB; "
            f"launches {launches.get(name, 0)} in the trainer's steps; yardstick (f32 PyTorch sequence) {yard:.3f} ms, "
            f"{100 * bms / ms:.1f} % of the bound; {ptxas_report(row)}")
    return rows


def phase_swinfir_train(dev: torch.device) -> list:
    """``Trainer.run`` on SwinFIR for 3 steps at its recipe (batch 32, f32,
    fused_train by default on the card), then 7 steps of one batch timed
    (the last 5): launch counts, finite losses that fall over the trainer's
    steps, moved weights, step ms, images/s, peak memory. Returns the rows
    of B5-B8 in f32 (``swinfir_f32_rows``)."""
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
    del before
    rows = swinfir_f32_rows(model, dev, launches, failed)

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
    return rows


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
    """B15 against its plain version, f32 then bf16, over WINDOW_ATTN_CASES,
    each launch through its dtype's entry (``window_attn_flash_f32`` /
    ``_bf16``); N 1089 must raise. Then ms, plain ms, bound and SDPA ms at the
    two MaxSR shapes, bf16 and f32 (bound at 3xTF32). Returns ({(label,
    dtype): timing}, {dtype: max abs error at the adaptive shape})."""
    failed, error = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        entry = "window_attn_flash_f32" if dtype == torch.float32 else H100_ENTRIES["window_attention_pallas"]
        for i, case in enumerate(WINDOW_ATTN_CASES):
            q, k, v, bias, mask = window_attn_ops(dev, dtype, case, SEED + 30 + i)
            engagement.reset()
            got = window_attention(q, k, v, bias=bias, mask=mask)
            torch.cuda.synchronize()
            if engagement.entries() != {"window_attention_pallas": {entry: 1}}:
                failed.append(f"window_attention [{case[0]}] {dtype}: entries {engagement.entries()}")
            want = attention_plain(q.float(), k.float(), v.float(), bias, mask)
            _, bw, heads, n, d, _, nw = case
            part = f"window_attention [{case[0]}: {bw} windows, {heads} heads, N {n}, d {d}" + (
                f", mask of {nw} windows]" if nw else "]")
            err = kernel_check(part, got, want, dtype, failed)
            if case[0] == "adaptive":
                error[dtype] = err
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
    for dtype in (torch.bfloat16, torch.float32):
        for i, case in enumerate(WINDOW_ATTN_CASES[:2]):
            q, k, v, bias, mask = ops = window_attn_ops(dev, dtype, case, SEED + 30 + i)
            ms = time_ms(lambda: window_attention(q, k, v, bias=bias), iters=10)
            plain_ms = time_ms(lambda: attention_plain(q, k, v, bias), iters=5)
            attn_mask = None if bias is None else bias.to(q.dtype)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, scale=1.0),
                                 iters=10)
            flops, moved = window_attn_bounds(*ops)
            bms, by = bound_ms(flops, moved, PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_TF32X3_FLOPS)
            timing[(case[0], dtype)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)
            log(f"time window_attention [{case[0]}] {str(dtype)[6:]} ({case[1]} windows, N {case[3]}): {ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}{'' if dtype == torch.bfloat16 else ', 3xTF32'}), "
                f"library (F.scaled_dot_product_attention{'' if bias is None else ', bias as mask'}) "
                f"{library_ms:.4f} ms, {flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB; kernel / library "
                f"{ms / library_ms:.2f}, {100 * bms / ms:.1f} % of the bound")
            del q, k, v, ops
    log(f"  window_attention_pallas: {ptxas_report('window_attention_pallas')}")
    log(f"  window_attention_pallas f32: {ptxas_report('window_attention_pallas_f32')}")
    return timing, error


def phase_maxsr_serving(dev: torch.device, adaptive: bool) -> tuple:
    """MaxSR x4 at full width in one mode: fused vs plain (f32, bf16 against
    f32 plain; the f32 forward's 32 B15 launches through
    ``window_attn_flash_f32``), three bf16 requests with 32 B15 launches a
    forward and nothing else, the forward's time in bf16 and in f32. Returns
    (launches, forward ms, the f32 forward's B15 launches, its ms)."""
    mode = "adaptive" if adaptive else "static"
    model = MaxSR.build(**{**MAXSR_MAIN, "adaptive": adaptive}, seed=SEED, device=dev)
    log(f"\nmodel: MaxSR x4 {mode} dim {MAXSR_MAIN['dim']} depth {MAXSR_MAIN['depth']}, "
        f"{model.count_parameters()} parameters")
    images = requests()
    x = torch.from_numpy(images[0]).to(dev).float()[None] / 255.0
    plain = model.enable_fused(False)(x)
    engagement.reset()
    fused = model.enable_fused(True)(x)
    torch.cuda.synchronize()
    launches32 = engagement.counters()
    rel32 = rel_l2(fused, plain)
    failed = f32_entry_failures(f"maxsr {mode} f32 forward", launches32)
    if launches32 != MAXSR_PER_FORWARD:
        failed.append(f"maxsr {mode} f32 forward: launches {launches32}, expected {MAXSR_PER_FORWARD}")
    fwd32 = time_ms(lambda: model(x), iters=3, warmup=1)
    log(f"maxsr {mode} forward f32 fused batch 1 {LR}x{LR}: {fwd32:.3f} ms; launches {launches32}")
    model.half()
    fused16 = model(x)
    torch.cuda.synchronize()
    rel16 = rel_l2(fused16, plain)
    log(f"maxsr {mode} e2e fused vs plain: f32 rel_l2 {rel32:.3e} limit {E2E_F32_REL_L2:.0e}; bf16 vs f32 plain "
        f"rel_l2 {rel16:.3e} limit {E2E_BF16_REL_L2:.0e}")
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
    return launches, fwd, launches32.get("window_attention_pallas", 0), fwd32


def phase_maxsr(dev: torch.device) -> list:
    """Phases 22-23; B15's JSON rows, bf16 and f32 (timed at the adaptive
    shape, the default mode), their launches those of both modes' requests
    (bf16) and of both modes' fused f32 forwards (f32)."""
    timing, error = phase_window_attn_kernels(dev)
    launches, launches32, fwds = 0, 0, {}
    for adaptive in (True, False):
        counts, fwd, count32, fwd32 = phase_maxsr_serving(dev, adaptive)
        launches += counts.get("window_attention_pallas", 0)
        launches32 += count32
        fwds[(adaptive, torch.bfloat16)], fwds[(adaptive, torch.float32)] = fwd, fwd32
    per = MAXSR_PER_FORWARD["window_attention_pallas"]
    for dtype in (torch.bfloat16, torch.float32):
        for label, adaptive in (("adaptive", True), ("static", False)):
            ms = timing[(label, dtype)]["ms"]
            log(f"maxsr {label} {str(dtype)[6:]}: B15 {per} x {ms:.3f} ms = "
                f"{100 * per * ms / fwds[(adaptive, dtype)]:.1f} % of the forward")
    log(f"  window_attention_pallas_f32 static: {timing[('static', torch.float32)]}")
    rows = []
    for name, dtype, count in (("window_attention_pallas", torch.bfloat16, launches),
                               ("window_attention_pallas_f32", torch.float32, launches32)):
        source, replaces = KERNELS[name]
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces, launches=count,
                         max_abs_err=error[dtype], **timing[("adaptive", dtype)]))
    return rows



# -- MaxSR training (B5-B8 at its geometry) ------------------------------------------


def maxsr_train_kernel_cases(models, dev: torch.device, dtype: torch.dtype, batch: int):
    """(name, label, kernel fn, plain fn, operands) of B5, B8, B6 and B7 at
    MaxSR's training shapes ((batch, 64, 64, 128) maps, 4 heads of 32, window
    8, zero qkv and proj biases, no drop-path) with the first attention
    pair's weights of each mode of ``models`` (adaptive, static): the
    static mode's table bias gathered in the run's dtype (as the bf16 step
    gathers it from its bf16 table), the adaptive mode's f32 zero bias and
    inner LayerNorm; B6 and B7 (hidden 512) on the static pair's rows,
    whole and less 37 (a ragged last tile)."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 40)
    c, ws = MAXSR_MAIN["dim"], MAXSR_MAIN["window_size"]
    heads = c // MAXSR_MAIN["dim_head"]

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    x = randn(batch, TRAIN_CROP, TRAIN_CROP, c)
    g = randn(batch, TRAIN_CROP, TRAIN_CROP, c, scale=1e-3)
    w = lambda t: t.detach().t().to(dtype).contiguous()  # noqa: E731
    f = lambda t: t.detach().float().contiguous()  # noqa: E731
    zb3, zb1 = torch.zeros(3 * c, device=dev), torch.zeros(c, device=dev)
    kw = dict(heads=heads, window_size=ws, shift=0)
    cases = []
    for mode, model in zip(("adaptive", "static"), models):
        pair = next(model.module._trios(0))[1]
        attn, ff = pair._modules[pair.attn_name], pair._modules[pair.ff_name]
        a = attn.fn
        if a.static:
            ln, bias = attn.norm, gather_rel_bias(f(a.rel_pos_bias.weight), relative_position_index(ws), heads)
            bias = bias.to(dtype)
        else:
            ln, bias = a.norm, torch.zeros(heads, ws * ws, ws * ws, device=dev)
        attn_ops = (f(ln.weight), f(ln.bias), w(a.to_qkv.weight), zb3, w(a.to_out._modules["0"].weight), zb1, bias)
        label = f"maxsr {mode}"
        cases.append(("fused_window_attention_block", label, lambda *o: fused_window_attention_block(*o, **kw),
                      lambda *o: window_attention_plain(*o, **kw), (x, *attn_ops)))
        cases.append(("attention_bwd", label, lambda *o: attention_bwd(*o, **kw),
                      lambda *o: attention_bwd_plain(*o, **kw), (x, g, *attn_ops)))
        if a.static:
            net = ff.fn.net._modules
            rows = batch * TRAIN_CROP * TRAIN_CROP
            xr, gr = x.reshape(rows, c), g.reshape(rows, c)
            mlp_ops = (f(ff.norm.weight), f(ff.norm.bias), w(net["0"].weight), f(net["0"].bias), w(net["3"].weight))
            cases.append(("fused_mlp_block", "maxsr rows", fused_mlp_block, mlp_block_plain,
                          (xr, *mlp_ops, f(net["3"].bias))))
            cases.append(("fused_mlp_block", "maxsr ragged rows", fused_mlp_block, mlp_block_plain,
                          (xr[: rows - 37], *mlp_ops, f(net["3"].bias))))
            cases.append(("mlp_bwd", "maxsr rows", mlp_bwd, mlp_bwd_plain, (xr, gr, *mlp_ops)))
    return cases


def maxsr_models(dev: torch.device) -> tuple:
    return tuple(MaxSR.build(**{**MAXSR_MAIN, "adaptive": adaptive}, seed=SEED, device=dev)
                 for adaptive in (True, False))


def phase_maxsr_train(dev: torch.device):
    """``Trainer.run`` on MaxSR x4 (the build defaults) for 3 steps at the
    JAX Trainer's defaults, nothing passed to turn the kernels on: bf16 and
    fused_train by default on the card, launch counts per step (B5-B8 32
    each, nothing else, every launch through its bf16 H100 entry), finite
    losses, moved weights, the MBConvs' BatchNorm running statistics moved;
    after the last step an evaluation on the card of square LR maps of
    ``MAXSR_EVAL_SIDES`` (windows 9 and 12: the plain path, no launch)."""
    shutil.rmtree(MAXSR_TRAIN_DIR, ignore_errors=True)
    rng = np.random.default_rng(SEED + 5)
    eval_root = MAXSR_TRAIN_DIR / "eval" / "square"
    scale = MAXSR_MAIN["scale"]
    (eval_root / "HR").mkdir(parents=True)
    (eval_root / "LR_bicubic" / f"X{scale}").mkdir(parents=True)
    for side in MAXSR_EVAL_SIDES:
        imwrite(str(eval_root / "HR" / f"{side}.png"), rng.integers(0, 256, (scale * side,) * 2 + (3,), np.uint8))
        imwrite(str(eval_root / "LR_bicubic" / f"X{scale}" / f"{side}.png"),
                rng.integers(0, 256, (side, side, 3), np.uint8))
    losses: list = []
    model = MaxSR.build(**MAXSR_MAIN, seed=SEED, device=dev)
    trainer = _trainer(dev, SEED, losses, model=model, steps=MAXSR_TRAIN_STEPS, eval_interval=MAXSR_TRAIN_STEPS,
                       ckpt_path=MAXSR_TRAIN_DIR, evaluator=Evaluator2("square", scale, root=str(eval_root.parent)))
    module = model.module
    before = {k: p.detach().clone() for k, p in module.named_parameters()}
    stats = {k: v.clone() for k, v in module.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    engagement.reset()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = engagement.counters()
    steps = MAXSR_TRAIN_STEPS
    values = [float(v) for v in losses]
    log(f"\nmaxsr trained {steps} steps in {seconds:.3f} s (host clock, first steps included); bf16 "
        f"{trainer.bfloat16}, fused_train {trainer.fused_train}; launches {launches}")
    log(f"maxsr losses {[round(v, 6) for v in values]}; evaluation on the card of square LR maps "
        f"{MAXSR_EVAL_SIDES} (windows {[math.ceil(math.sqrt(s)) for s in MAXSR_EVAL_SIDES]}): PSNR "
        f"{trainer.best_psnr:.4f} dB")
    failed = []
    if not (np.isfinite(trainer.best_psnr) and trainer.best_psnr > 0):
        failed.append(f"maxsr trainer evaluation: PSNR {trainer.best_psnr}")
    if not (trainer.bfloat16 and trainer.fused_train):
        failed.append("the trainer did not default to bf16 and fused_train for MaxSR on the card")
    for name in set(launches) | set(MAXSR_PER_STEP):
        if launches.get(name, 0) != MAXSR_PER_STEP.get(name, 0) * steps:
            failed.append(f"maxsr {name}: {launches.get(name, 0)} launches in {steps} steps, expected "
                          f"{MAXSR_PER_STEP.get(name, 0)} a step")
    failed += train_entry_failures("maxsr trainer", launches, torch.bfloat16)
    if len(values) != steps or not all(np.isfinite(values)):
        failed.append(f"maxsr losses {values}")
    moved = sum(not torch.equal(p.detach(), before[k]) for k, p in module.named_parameters())
    if moved != len(before):
        failed.append(f"only {moved} of {len(before)} MaxSR parameters changed")
    state = module.state_dict()
    stat_moved = sum(not torch.equal(state[k], v) for k, v in stats.items())
    log(f"maxsr trainer: {stat_moved} of {len(stats)} BatchNorm running statistics moved")
    if not stats or stat_moved != len(stats):
        failed.append("the MBConvs' BatchNorm running statistics did not all move in the fused steps")
    shutil.rmtree(MAXSR_TRAIN_DIR, ignore_errors=True)
    if failed:
        raise AssertionError("; ".join(failed))
    return model, launches, steps


def phase_maxsr_train_timing(model, models, dev: torch.device, errors: dict, launches: dict, steps: int) -> list:
    """MaxSR step ms, images/s and peak memory over 5 steps after 2 warm-up
    steps; B5, B8 (both modes), B6 and B7 at batch 32: ms, plain ms, bound,
    the bf16 PyTorch yardstick; the kernels line's MaxSR-step rows (B5 and
    B8 timed in the adaptive mode, the default)."""
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
    log(f"maxsr train step bf16 batch {TRAIN_BATCH} {TRAIN_CROP}x{TRAIN_CROP}: {step_ms:.3f} ms, "
        f"{TRAIN_BATCH / (step_ms / 1e3):.1f} images/s, peak memory {peak:.2f} GiB")
    rows, kernel_total = [], 0.0
    ones = torch.ones(TRAIN_BATCH, device=dev)  # the yardsticks' drop-path scale: 1, as MaxSR's pairs have none
    for name, label, kernel, plain, ops in maxsr_train_kernel_cases(models, dev, torch.bfloat16, TRAIN_BATCH):
        if label == "maxsr ragged rows":
            continue
        ms = time_ms(lambda: kernel(*ops), iters=10)
        plain_ms = time_ms(lambda: plain(*ops), iters=3, warmup=1)
        flops, moved = train_bounds(name, ops)
        bms, by = bound_ms(flops, moved)
        per = MAXSR_PER_STEP[name]
        log(f"time {name} [{label}] bf16 batch {TRAIN_BATCH}: {ms:.3f} ms ({100 * per * ms / step_ms:.1f} % of a "
            f"MaxSR step at {per} a step), plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), {flops / 1e9:.2f} "
            f"GFLOP, {moved / 1e6:.1f} MB; launches {launches.get(name, 0)} in {steps} steps")
        kw = dict(heads=MAXSR_MAIN["dim"] // MAXSR_MAIN["dim_head"], window_size=MAXSR_MAIN["window_size"], shift=0,
                  drop_path=ones, rows_per_sample=TRAIN_CROP * TRAIN_CROP)
        yardstick_report(name, ops, ms, bms, kw)
        if label == "maxsr static" and name in ("fused_window_attention_block", "attention_bwd"):
            continue  # the rows are the adaptive mode's, the default
        kernel_total += per * ms
        source, replaces = KERNELS[name]
        rows.append(dict(name=f"{name}_maxsr", route="cuda", source=source, replaces=replaces,
                         launches=launches.get(name, 0), max_abs_err=errors[name], ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, library_ms=None))
    log(f"maxsr train step: kernels {kernel_total:.1f} ms, the rest (MBConvs, LayerNorms, stem, fusion, tail, "
        f"loss, optimizer, gaps) {step_ms - kernel_total:.1f} ms")
    return rows


# -- MaxSR adaptive fused training at other square crops (B5 / B8 / B9 at windows 7-12) --


def maxsr_window_per_step(ws: int) -> dict:
    """MaxSR's launches a fused step at window ``ws``: 32 of each, B5 and the
    attention backward under their window family's keys."""
    suffix = window_family(ws)
    return {"fused_window_attention_block" + suffix: 32, "attention_bwd" + suffix: 32, "fused_mlp_block": 32,
            "mlp_bwd": 32}


def phase_maxsr_windows(dev: torch.device, crops=MAXSR_WINDOW_CROPS) -> list:
    """MaxSR x4 adaptive at full width, bf16 over f32 masters, fused_train,
    at square LR crops whose windows the earlier phases do not reach
    (``MAXSR_WINDOW_CROPS``: 48² has windows of 7, 96² of 10, 144² of 12, the
    map zero-padded to the window's square): ``MAXSR_WINDOW_STEPS`` steps
    each, the launches per kernel (32 of B5, B8 or B9, B6 and B7 a step,
    through their bf16 H100 entries), finite losses, the step's ms and peak
    memory; B5 and B8 / B9 against their plain versions on the first
    attention pair's operands of a step (its input and its bf16 weights),
    timed with their plain versions, bounds and bf16 PyTorch yardsticks;
    the f64 gradient witness at the crop's witness batch (``hold_grads``,
    MaxSR's rules). ``crops`` as ``MAXSR_WINDOW_CROPS``. Returns the kernels
    line's rows, one a kernel a window."""
    import studiosr_tpu_torch.models.maxsr as maxsr_module

    rows, failed = [], []
    for side, batch, witness_batch in crops:
        ws = math.ceil(math.sqrt(side))
        per_step = maxsr_window_per_step(ws)
        model = MaxSR.build(**MAXSR_MAIN, seed=SEED, device=dev)
        module = model.module
        module.fused_train = True
        tx = build_optimizer()
        state = prepare_state(module, tx)
        step = make_train_step(module, tx, l1_loss, bfloat16=True)
        lq, gt = _unit_batch(dev, batch, SEED + 6, side)
        captured = []
        vjp = maxsr_module.attention_map_vjp

        def capture(*args):  # the first attention pair's operands of the first step
            if not captured:
                captured.append([a.detach().clone() if torch.is_tensor(a) else a for a in args])
            return vjp(*args)

        gen = torch.Generator().manual_seed(SEED)
        maxsr_module.attention_map_vjp = capture
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            engagement.reset()
            losses = []
            for _ in range(MAXSR_WINDOW_STEPS):
                state, loss = step(state, lq, gt, gen)
                losses.append(float(loss))
            torch.cuda.synchronize()
            launches, entries = engagement.counters(), engagement.entries()
        finally:
            maxsr_module.attention_map_vjp = vjp
        peak = torch.cuda.max_memory_allocated() / 2**30
        step_ms = time_ms(lambda: step(state, lq, gt, gen), iters=2, warmup=1)
        module.fused_train = False
        del state, tx, step
        torch.cuda.empty_cache()
        log(f"\nmaxsr windows: LR {side}² (window {ws}, map {ws * ws}², batch {batch}) bf16 fused: "
            f"{MAXSR_WINDOW_STEPS} steps, losses {[round(v, 6) for v in losses]}, launches {launches}; step "
            f"{step_ms:.3f} ms, {batch / (step_ms / 1e3):.1f} images/s, peak memory {peak:.2f} GiB")
        label = f"maxsr {side}² window {ws}"
        for name in set(launches) | set(per_step):
            if launches.get(name, 0) != per_step.get(name, 0) * MAXSR_WINDOW_STEPS:
                failed.append(f"{label} {name}: {launches.get(name, 0)} launches in {MAXSR_WINDOW_STEPS} steps, "
                              f"expected {per_step.get(name, 0)} a step")
        failed += train_entry_failures(label, launches, torch.bfloat16, entries)
        if not all(np.isfinite(losses)):
            failed.append(f"{label} losses {losses}")

        x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, dp, shift, heads, ws_ = captured[0]
        attn_ops = (ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias)
        g = (torch.randn(x.shape, generator=torch.Generator().manual_seed(SEED + ws)) * 1e-3).to(dev, x.dtype)
        kw = dict(heads=heads, window_size=ws_, shift=shift, drop_path=dp)
        cases = (("fused_window_attention_block", fused_window_attention_block, window_attention_plain, (x, *attn_ops)),
                 ("attention_bwd", attention_bwd, attention_bwd_plain, (x, g, *attn_ops)))
        for base, kernel, plain, ops in cases:
            name = base + window_family(ws)
            got = _flat(kernel(*ops, **kw))
            want = _flat(plain(*[t.float() for t in ops], **kw))
            err = [kernel_check(f"{name} [{label}] output {i}", k, p, torch.bfloat16, failed)
                   for i, (k, p) in enumerate(zip(got, want))][0]  # the row's error: the first output's
            del got, want
            ms = time_ms(lambda: kernel(*ops, **kw), iters=10)
            plain_ms = time_ms(lambda: plain(*ops, **kw), iters=3, warmup=1)
            flops, moved = train_bounds(base, ops)
            bms, by = bound_ms(flops, moved)
            log(f"time {name} [{label}] bf16: {ms:.3f} ms ({100 * 32 * ms / step_ms:.1f} % of the step at 32 a "
                f"step), plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), {flops / 1e9:.2f} GFLOP, "
                f"{moved / 1e6:.1f} MB; launches {launches.get(name, 0)} in {MAXSR_WINDOW_STEPS} steps")
            yard = yardstick_report(name, ops, ms, bms, dict(kw, drop_path=torch.ones(batch, device=dev)))
            source, replaces = KERNELS[name]
            rows.append(dict(name=f"{name}_maxsr_ws{ws}", route="cuda", source=source, replaces=replaces,
                             launches=launches.get(name, 0), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bms, bound_by=by, library_ms=None))
            log(f"  {name} [{label}] yardstick (bf16 PyTorch sequence, not a single call): {yard:.3f} ms")
            torch.cuda.empty_cache()
        del captured, x, g, attn_ops, cases, module, model
        torch.cuda.empty_cache()
        hold_grads(dev, MaxSR.build(**MAXSR_MAIN, seed=SEED, device=dev), per_step, f"maxsr {side}² ",
                   MAXSR_GRAD_RULES, crop=side, batch=witness_batch)
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("maxsr windows: " + "; ".join(failed))
    return rows


# -- C7: fused serving at windows other than 8 ---------------------------------------


def window_bounds(name: str, ops, ws: int) -> tuple:
    """(flops, bytes) of one B5 or B6 launch on its served operands: each
    input read once, each output written once; B5's products over the
    window's own ws² tokens, not its padding to whole tiles."""
    x = ops[0]
    c = x.shape[-1]
    tokens = x.numel() // c
    if name.startswith("fused_window_attention_block"):
        flops = 2 * tokens * c * 4 * c + 4 * tokens * ws * ws * c
    else:
        flops = 4 * tokens * c * ops[4].numel()  # hidden from b1: w1 may be the packed blob
    return flops, 2 * nbytes(x) + nbytes(*ops[1:])


def windows_coverage(dev: torch.device) -> list:
    """SwinIR x4 at the published widths, depth cut to [2]x2, bf16 and f32,
    at windows 4, 16, 24 and 8: the fused forward against the plain f32 one
    and the launches of a forward, each through its dtype's entry (window 24
    raised before B5's streaming family was written; now it serves)."""
    failed = []
    x = torch.rand(1, WINDOWS_LR, WINDOWS_LR, 3, generator=torch.Generator().manual_seed(SEED + 12)).to(dev)
    for ws, per in WINDOWS_COVERAGE.items():
        for dtype in (torch.float32, torch.bfloat16):
            model = SwinIR.build(**dict(WINDOWS_REDUCED, window_size=ws), seed=SEED, device=dev)
            plain = model(x)
            if dtype == torch.bfloat16:
                model.half()
            model.enable_fused(True).serving_prep()
            engagement.reset()
            fused = model(x)
            torch.cuda.synchronize()
            launches, entries = engagement.counters(), engagement.entries()
            want = dict(per, fused_conv3x3=3, fused_upsample_x4=1)
            rel = rel_l2(fused, plain)
            limit = E2E_F32_REL_L2 if dtype == torch.float32 else E2E_BF16_REL_L2
            label = f"windows swinir [2]x2 window {ws} {str(dtype)[6:]}"
            log(f"{label}: fused vs plain f32 rel_l2 {rel:.3e} limit {limit:.0e}; launches {launches}")
            if not rel <= limit:
                failed.append(f"{label}: rel_l2 {rel:.3e}")
            if launches != want:
                failed.append(f"{label}: launches {launches}, expected {want}")
            failed += train_entry_failures(label, launches, dtype, entries)
            if dtype == torch.bfloat16:
                failed += entry_failures(label, launches)
            del model
    return failed


def phase_windows_serving(dev: torch.device) -> list:
    """SwinFIR x4 at window 12 and full width, bf16 fused (``WINDOWS_MAIN``):
    the forward against the plain f32 forward, the launches of a forward
    (B5 36 at window 12, B6 36, B14 7, B3 1, B1 none, each through its bf16
    H100 entry), the forward's ms over 5 forwards after 2 warm-ups; B5 and B6
    alone on the served operands of the first shifted block, against their
    plain versions, timed beside them, their bounds and bf16 PyTorch
    yardsticks; then the routing coverage (``windows_coverage``). Returns the
    kernels line's two rows."""
    failed = []
    model = SwinFIR.build(**WINDOWS_MAIN, seed=SEED, device=dev)
    log(f"\nmodel: SwinFIR x4 window {WINDOWS_MAIN['window_size']} embed {WINDOWS_MAIN['embed_dim']} depths "
        f"{WINDOWS_MAIN['depths']}, {model.count_parameters()} parameters")
    x = torch.from_numpy(requests()[0]).to(dev).float()[None] / 255.0
    plain = model(x)
    model.half().enable_fused(True)
    prep = model.serving_prep()  # load-time weight layout, outside the counted run
    engagement.reset()
    fused = model(x)
    torch.cuda.synchronize()
    launches, entries = engagement.counters(), engagement.entries()
    rel = rel_l2(fused, plain)
    log(f"windows swinfir window 12 bf16 fused vs f32 plain: rel_l2 {rel:.3e} limit {E2E_BF16_REL_L2:.0e}; "
        f"launches {launches}")
    if not rel <= E2E_BF16_REL_L2:
        failed.append(f"swinfir window 12: bf16 fused vs f32 plain rel_l2 {rel:.3e}")
    if not bool(torch.isfinite(fused).all()) or fused.shape != (1, 4 * LR, 4 * LR, 3):
        failed.append(f"swinfir window 12: bad forward {tuple(fused.shape)}")
    if launches != WINDOWS_PER_FORWARD:
        failed.append(f"swinfir window 12: launches {launches}, expected {WINDOWS_PER_FORWARD}")
    failed += entry_failures("windows swinfir window 12", launches)
    failed += train_entry_failures("windows swinfir window 12", launches, torch.bfloat16, entries)
    del plain, fused
    fwd = time_ms(lambda: model(x), iters=5)
    log(f"windows swinfir window 12 forward bf16 batch 1 {LR}x{LR}: {fwd:.3f} ms, "
        f"{LR * LR / 1e6 / (fwd / 1e3):.3f} LR MP/s")

    ws, heads = WINDOWS_MAIN["window_size"], WINDOWS_MAIN["num_heads"][0]
    hp = LR + (-LR % ws)
    c = WINDOWS_MAIN["embed_dim"]
    gen = torch.Generator().manual_seed(SEED + 13)
    xb = torch.randn(1, hp, hp, c, generator=gen).to(dev, torch.bfloat16)
    blk = prep["blocks"][0][1]  # the first shifted block's served operands
    attn = blk["attn"]
    attn_ops = (xb, attn["ln_w"], attn["ln_b"], attn["wqkv"], attn["bqkv"], attn["wproj"], attn["bproj"],
                attn["bias"])
    wqkv, wproj, bias = unpack_window_attention(attn["wqkv"], c, heads, ws)
    kw = dict(heads=heads, window_size=ws, shift=ws // 2)
    mlp = blk["mlp"]
    rows = xb.reshape(-1, c)
    mlp_ops = (rows, mlp["ln_w"], mlp["ln_b"], mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"])
    w1, w2 = unpack_mlp_block(mlp["w1"], c, mlp["b1"].numel())
    cases = (
        ("fused_window_attention_block_ws16", lambda: fused_window_attention_block(*attn_ops, **kw),
         lambda ops: window_attention_plain(*ops, **kw), attn_ops,
         (xb, attn["ln_w"], attn["ln_b"], wqkv, attn["bqkv"], wproj, attn["bproj"], bias)),
        ("fused_mlp_block", lambda: fused_mlp_block(*mlp_ops), lambda ops: mlp_block_plain(*ops), mlp_ops,
         (rows, mlp["ln_w"], mlp["ln_b"], w1, mlp["b1"], w2, mlp["b2"])),
    )
    rows_out = []
    for name, kernel, plain_fn, ops, dense in cases:
        engagement.reset()
        got = kernel()
        if engagement.counters() != {name: 1}:
            failed.append(f"{name} at window 12 launched {engagement.counters()}")
        # the plain version in f32 on the same bf16 input (it reads the packed weights as they are)
        err = kernel_check(f"{name} [swinfir window 12]", got, plain_fn((ops[0].float(), *ops[1:])), torch.bfloat16,
                           failed)
        del got
        ms = time_ms(kernel, iters=20)
        plain_ms = time_ms(lambda: plain_fn(ops), iters=3, warmup=1)
        flops, moved = window_bounds(name, ops, ws)
        bms, by = bound_ms(flops, moved)
        per = WINDOWS_PER_FORWARD[name]
        log(f"time {name} [swinfir window 12] bf16: {ms:.3f} ms ({100 * per * ms / fwd:.1f} % of a forward at {per} "
            f"a forward), plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), {flops / 1e9:.2f} GFLOP, "
            f"{moved / 1e6:.1f} MB; launches {launches.get(name, 0)} in the forward")
        yard = yardstick_report(name, dense, ms, bms, kw if name != "fused_mlp_block" else {})
        log(f"  {name} [swinfir window 12] yardstick (bf16 PyTorch sequence, not a single call): {yard:.3f} ms")
        source, replaces = KERNELS[WINDOWS_ROWS[name]]
        rows_out.append(dict(name=WINDOWS_ROWS[name], route="cuda", source=source, replaces=replaces,
                             launches=launches.get(name, 0), max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                             bound_by=by, library_ms=None))
        torch.cuda.empty_cache()
    del model, prep, attn_ops, mlp_ops, cases, xb, rows
    torch.cuda.empty_cache()
    failed += windows_coverage(dev)
    if failed:
        raise AssertionError("windows serving: " + "; ".join(failed))
    return rows_out


# -- B5 and its backward above window 16 -------------------------------------------------


def large_window_ops(dev: torch.device, dtype: torch.dtype, c: int, heads: int, ws: int, shape, seed: int):
    """x, g (``shape`` + (C,), in ``dtype``) and B5's dense operands at window
    ``ws``: LN weights, q|k|v and proj weights (``dtype``) and biases, the
    (heads, N, N) bias (f32), from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *size, k=1.0: torch.randn(*size, generator=gen) * k  # noqa: E731
    n = ws * ws
    ops = [1 + r(c, k=0.1), r(c, k=0.1), r(c, 3 * c, k=c**-0.5), r(3 * c, k=0.1), r(c, c, k=c**-0.5), r(c, k=0.1),
           r(heads, n, n, k=0.5)]
    ops = [t.to(dev, dtype if i in (2, 4) else torch.float32) for i, t in enumerate(ops)]
    return r(*shape, c).to(dev, dtype), r(*shape, c).to(dev, dtype), ops


def large_window_checks(dev: torch.device, failed: list, windows=LARGE_WINDOWS, geometries=LARGE_GEOMETRIES,
                        family: str = "_large") -> dict:
    """B5 and its backward against their plain versions at every window of
    ``windows`` (by default the streaming family's, ``LARGE_WINDOWS``) and
    geometry of ``geometries`` (2 x 3 windows, batch 2; shift 0 and ws / 2,
    with and without drop-path), each launch through ``family``'s entry of
    its route; the serving blob gives the dense weights' bits, the backward
    (and, on the H100 core, the forward) repeats its bits, and a dropped
    sample passes through (dx = g). One line a window and geometry.
    Returns the launches at window 32 in the geometry that is timed."""
    timed = {}
    for ws in windows:
        for dtype, c, heads in geometries:
            x, g, ops = large_window_ops(dev, dtype, c, heads, ws, (2, 2 * ws, 3 * ws), SEED + ws + c + heads)
            xf, gf, opsf = x.float(), g.float(), [t.float() for t in ops]
            if dtype == torch.bfloat16:
                kind = "_mma_bf16" if mma_takes(c, heads) else "_bf16"
            else:
                kind = "_mma_f32" if f32_mma_takes(c, heads, ws) else "_f32"
            label = f"{family[1:]} window {ws} {str(dtype)[6:]} C {c} / {heads} heads"
            worst, n = 0.0, 0
            engagement.reset()
            for shift in (0, ws // 2):
                for dp in (None, torch.tensor([0.0, 1.25], device=dev)):
                    kw = dict(heads=heads, window_size=ws, shift=shift, drop_path=dp)
                    case = f"{label} shift {shift}" + (" drop-path" if dp is not None else "")
                    y = fused_window_attention_block(x, *ops, **kw)
                    if kind == "_mma_bf16" and "fused_window_attention_block" + family in BITWISE and not torch.equal(
                            y, fused_window_attention_block(x, *ops, **kw)):
                        failed.append(f"{case}: the forward's bits differ from launch to launch")
                    grads = attention_bwd(x, g, *ops, **kw)
                    pairs = [(y, window_attention_plain(xf, *opsf, **kw))]
                    pairs += list(zip(grads, attention_bwd_plain(xf, gf, *opsf, **kw)))
                    for i, (got, want) in enumerate(pairs):
                        got = got.float()
                        if not bool(torch.isfinite(got).all()) or got.shape != want.shape:
                            failed.append(f"{case} output {i}: non-finite or {tuple(got.shape)}")
                            continue
                        if dtype == torch.float32:
                            err = float((got - want).abs().max()) / (F32_RTOL * float(want.abs().max()) + F32_ATOL)
                        else:
                            err = rel_l2(got, want) / BF16_REL_L2
                        worst, n = max(worst, err), n + 1
                        if not err <= 1.0:
                            failed.append(f"{case} output {i}: {err:.3f} of its limit")
                    if dp is not None and not (torch.equal(y[0], x[0]) and torch.equal(grads[0][0], g[0])):
                        failed.append(f"{case}: a dropped sample does not pass through")
                    if not all(torch.equal(a, b) for a, b in zip(grads, attention_bwd(x, g, *ops, **kw))):
                        failed.append(f"{case}: the backward's bits differ from launch to launch")
                    if kind == "_mma_bf16" and shift == 0 and dp is None:
                        blob = pack_window_attention(ops[2], ops[4], ops[6], heads)
                        if not torch.equal(y, fused_window_attention_block(x, ops[0], ops[1], blob, ops[3], None,
                                                                           ops[5], None, **kw)):
                            failed.append(f"{case}: the serving blob gives other bits than the dense weights")
                    del y, grads, pairs
            torch.cuda.synchronize()
            entries, launches = engagement.entries(), engagement.counters()
            stem = FAMILY_STEM[family]
            forwards = 4 + (kind == "_mma_bf16") * (1 + 4 * ("fused_window_attention_block" + family in BITWISE))
            want = {"fused_window_attention_block" + family: {f"window_attention{stem}{kind}": forwards},
                    "attention_bwd" + family: {f"attn_bwd{stem}{kind}": 8}}
            if entries != want:
                failed.append(f"{label}: entries {entries}, expected {want}")
            if (ws, c, heads, dtype, family) == (*LARGE_TIMED[:3], torch.bfloat16, "_large"):
                timed = launches
            rule = "max abs error vs 1e-4 max|p| + 1e-5" if dtype == torch.float32 else "rel_l2 vs 1e-2"
            log(f"check {label}: {n} outputs over shift 0 / {ws // 2} with and without drop-path, worst "
                f"{worst:.3f} of the limit ({rule}); entries {entries}")
            del x, g, ops, xf, gf, opsf
            torch.cuda.empty_cache()
    return timed


def large_window_timing(dev: torch.device, launches: dict, failed: list) -> list:
    """B5 and its backward at window 32 (C 128, 4 heads, bf16, batch 1, 4 x 4
    windows, shift 16, drop-path scales of 1): against their plain versions,
    timed beside them, with their bounds and bf16 PyTorch yardsticks. The
    kernels line's two ``_ws32`` rows."""
    ws, c, heads, side = LARGE_TIMED
    x, g, ops = large_window_ops(dev, torch.bfloat16, c, heads, ws, (1, side * ws, side * ws), SEED + 32)
    kw = dict(heads=heads, window_size=ws, shift=ws // 2, drop_path=torch.ones(1, device=dev))
    rows = []
    cases = (("fused_window_attention_block_large", fused_window_attention_block, window_attention_plain, (x, *ops)),
             ("attention_bwd_large", attention_bwd, attention_bwd_plain, (x, g, *ops)))
    for name, kernel, plain, args in cases:
        got = _flat(kernel(*args, **kw))
        want = _flat(plain(*[t.float() for t in args], **kw))
        err = [kernel_check(f"{name} [window {ws}] output {i}", k, p, torch.bfloat16, failed)
               for i, (k, p) in enumerate(zip(got, want))][0]
        del got, want
        ms = time_ms(lambda: kernel(*args, **kw), iters=10)
        plain_ms = time_ms(lambda: plain(*args, **kw), iters=3, warmup=1)
        flops, moved = train_bounds(name, args)
        bms, by = bound_ms(flops, moved)
        log(f"time {name} [window {ws}, C {c}, {heads} heads, {side}x{side} windows] bf16: {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), {flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB")
        yard = yardstick_report(name, args, ms, bms, kw)
        source, replaces = KERNELS[name]
        rows.append(dict(name=LARGE_ROWS[name], route="cuda", source=source, replaces=replaces,
                         launches=launches.get(name, 0), max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by, library_ms=None))
        torch.cuda.empty_cache()
    return rows


def large_window_swinir(dev: torch.device, failed: list) -> tuple:
    """SwinIR classical x4 at window 24 (``LARGE_SWINIR``), bf16 fused, batch
    1, 256² LR: against the plain f32 forward, the launches of a forward (B5
    36 through its streaming family's H100 entry, B6 36, B2 7, B3 1, B1
    none), its ms and LR MP/s beside window 8's (``MAIN``) in this run; B5
    alone on the first shifted block's served operands against its plain
    version, timed, with its bound and bf16 PyTorch yardstick. Returns (the
    kernels line's row, the window-8 model, bf16 fused)."""
    name = "fused_window_attention_block_large"
    model = SwinIR.build(**LARGE_SWINIR, seed=SEED, device=dev)
    x = torch.from_numpy(requests()[0]).to(dev).float()[None] / 255.0
    plain = model(x)
    model.half().enable_fused(True)
    prep = model.serving_prep()  # load-time weight layout, outside the counted run
    engagement.reset()
    fused = model(x)
    torch.cuda.synchronize()
    launches, entries = engagement.counters(), engagement.entries()
    rel = rel_l2(fused, plain)
    log(f"\nlarge windows: SwinIR x4 window 24 bf16 fused vs f32 plain: rel_l2 {rel:.3e} limit "
        f"{E2E_BF16_REL_L2:.0e}; launches {launches}")
    if not rel <= E2E_BF16_REL_L2 or fused.shape != (1, 4 * LR, 4 * LR, 3) or not bool(torch.isfinite(fused).all()):
        failed.append(f"swinir window 24: rel_l2 {rel:.3e}, shape {tuple(fused.shape)}")
    if launches != LARGE_SWINIR_PER_FORWARD:
        failed.append(f"swinir window 24: launches {launches}, expected {LARGE_SWINIR_PER_FORWARD}")
    failed += entry_failures("large windows swinir window 24", launches)
    failed += train_entry_failures("large windows swinir window 24", launches, torch.bfloat16, entries)
    del plain, fused
    fwd = time_ms(lambda: model(x), iters=5)
    main = SwinIR.build(**MAIN, seed=SEED, device=dev).half().enable_fused(True)
    fwd8 = time_ms(lambda: main(x), iters=5)
    log(f"large windows: SwinIR x4 forward bf16 batch 1 {LR}x{LR}: window 24 {fwd:.3f} ms "
        f"({LR * LR / 1e6 / (fwd / 1e3):.3f} LR MP/s), window 8 {fwd8:.3f} ms ({LR * LR / 1e6 / (fwd8 / 1e3):.3f} "
        f"LR MP/s)")

    ws, heads, c = 24, LARGE_SWINIR["num_heads"][0], LARGE_SWINIR["embed_dim"]
    hp = LR + (-LR % ws)
    xb = torch.randn(1, hp, hp, c, generator=torch.Generator().manual_seed(SEED + 24)).to(dev, torch.bfloat16)
    attn = prep["blocks"][0][1]["attn"]  # the first shifted block's served operands
    ops = (xb, attn["ln_w"], attn["ln_b"], attn["wqkv"], attn["bqkv"], attn["wproj"], attn["bproj"], attn["bias"])
    wqkv, wproj, bias = unpack_window_attention(attn["wqkv"], c, heads, ws)
    dense = (xb, attn["ln_w"], attn["ln_b"], wqkv, attn["bqkv"], wproj, attn["bproj"], bias)
    kw = dict(heads=heads, window_size=ws, shift=ws // 2)
    engagement.reset()
    got = fused_window_attention_block(*ops, **kw)
    if engagement.counters() != {name: 1}:
        failed.append(f"{name} at window 24 launched {engagement.counters()}")
    if name in BITWISE and not torch.equal(got, fused_window_attention_block(*ops, **kw)):
        failed.append(f"{name} [swinir window 24]: two launches differ")
    err = kernel_check(f"{name} [swinir window 24]", got, window_attention_plain(xb.float(), *ops[1:], **kw),
                       torch.bfloat16, failed)
    del got
    ms = time_ms(lambda: fused_window_attention_block(*ops, **kw), iters=20)
    plain_ms = time_ms(lambda: window_attention_plain(*ops, **kw), iters=3, warmup=1)
    flops, moved = window_bounds(name, ops, ws)
    bms, by = bound_ms(flops, moved)
    log(f"time {name} [swinir window 24] bf16: {ms:.3f} ms ({100 * 36 * ms / fwd:.1f} % of a forward at 36 a "
        f"forward), plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), {flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} "
        f"MB; launches {launches.get(name, 0)} in the forward")
    yard = yardstick_report(name, dense, ms, bms, kw)
    log(f"  {name} [swinir window 24] yardstick (bf16 PyTorch sequence, not a single call): {yard:.3f} ms")
    source, replaces = KERNELS[name]
    row = dict(name=f"{name}_swinir_ws24", route="cuda", source=source, replaces=replaces,
               launches=launches.get(name, 0), max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               library_ms=None)
    del model, prep, ops, dense, xb, attn
    torch.cuda.empty_cache()
    return row, main


def large_window_tiled(dev: torch.device, model, failed: list) -> None:
    """The tiled device loop on the card: ``model`` (SwinIR x4, bf16 fused) on
    a seeded ``TILED_IMAGE`` uint8 image, ``device_loop`` True against False,
    bit for bit, with the host seconds of each (a second call of each)."""
    image = np.random.default_rng(SEED + 5).integers(0, 256, (*TILED_IMAGE, 3), dtype=np.uint8)
    kw = dict(tile=TILED_TILE, tile_overlap=TILED_OVERLAP, tile_batch=8)
    seconds, outs = {}, {}
    for loop in (True, False, True, False):
        start = time.perf_counter()
        engagement.reset()
        outs[loop] = model.inference_tiled(image, device_loop=loop, **kw)
        seconds[loop] = time.perf_counter() - start
        if not engagement.counters().get("fused_swin_block"):
            failed.append(f"tiled device_loop={loop}: no B1 launch")
    same = np.array_equal(outs[True], outs[False])
    log(f"large windows: tiled SwinIR x4 bf16 {TILED_IMAGE[0]}x{TILED_IMAGE[1]} tile {TILED_TILE} overlap "
        f"{TILED_OVERLAP}: device loop {seconds[True]:.3f} s, host loop {seconds[False]:.3f} s (host clock, second "
        f"call of each); outputs {'bit for bit equal' if same else 'DIFFER'} {outs[True].shape}")
    if not same or outs[True].shape != (4 * TILED_IMAGE[0], 4 * TILED_IMAGE[1], 3):
        failed.append("tiled: device_loop=True differs from the host loop")


def phase_large_windows(dev: torch.device) -> list:
    """B5 and its backward above window 16, then the tiled device loop:
    the kernel checks (``large_window_checks``) and window 32 timed; SwinIR
    x4 served at window 24; MaxSR x4 adaptive trained fused at a 289² crop
    (window 17: ``phase_maxsr_windows``, the f64 witness at batch 1); the
    tiled device loop against the host loop. Returns the kernels line's
    rows."""
    failed = []
    start = time.perf_counter()
    timed = large_window_checks(dev, failed)
    rows = large_window_timing(dev, timed, failed)
    log(f"large windows: kernel checks and window 32 timed in {time.perf_counter() - start:.1f} s")
    row, main = large_window_swinir(dev, failed)
    rows.append(row)
    large_window_tiled(dev, main, failed)
    del main
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("large windows: " + "; ".join(failed))
    rows += phase_maxsr_windows(dev, (LARGE_MAXSR_CROP,))
    return rows


# -- HAT at every window (B10, B12 and B13 beyond windows 8 and 16) ----------------------


def hat_window_ocab_ops(dev: torch.device, dtype: torch.dtype, ws: int, shape, seed: int):
    """x (``shape`` + (C,)) and B10's dense operands at HAT x4's widths (C
    180, 6 heads, hidden 360) and window ``ws``, overlap 0.5, from ``seed``:
    LN weights, q|k|v, proj, fc1 and fc2 (``dtype``) and their biases (f32),
    the (heads, ws², owin²) bias in the map's dtype, as serving rounds it."""
    gen = torch.Generator().manual_seed(seed)
    c, heads = HAT_MAIN["embed_dim"], HAT_MAIN["num_heads"][0]
    hidden = int(c * HAT_MAIN["mlp_ratio"])
    owin, _ = overlap_window(ws, HAT_MAIN["overlap_ratio"])
    r = lambda *size, k=1.0: torch.randn(*size, generator=gen) * k  # noqa: E731
    ops = [1 + r(c, k=0.1), r(c, k=0.1), r(c, 3 * c, k=c**-0.5), r(3 * c, k=0.1), r(c, c, k=c**-0.5), r(c, k=0.1),
           r(heads, ws * ws, owin * owin, k=0.5), 1 + r(c, k=0.1), r(c, k=0.1), r(c, hidden, k=c**-0.5),
           r(hidden, k=0.1), r(hidden, c, k=hidden**-0.5), r(c, k=0.1)]
    ops = [t.to(dev, dtype if i in (2, 4, 6, 9, 11) else torch.float32) for i, t in enumerate(ops)]
    return r(*shape, c).to(dev, dtype), ops


def hat_window_checks(dev: torch.device, failed: list) -> None:
    """B12 / B13 and B10 against their plain versions at every window of
    ``HAT_WINDOW_CHECKS``, f32 then bf16, at HAT x4's widths: B12 / B13 on 9
    windows of the OCAB's transposed views (6 heads of 30, logits of a few
    units, the bias in the path's dtype), B10 on a map of 2 x 3 windows
    (bf16 on the serving blob); each launch through its dtype's entry, B13's
    bits (and in bf16 those of B12's large entry) repeated, the blob giving
    the dense weights' bits. One line a window and dtype."""
    c, heads = HAT_MAIN["embed_dim"], HAT_MAIN["num_heads"][0]
    d, bw = c // heads, 9
    for ws in HAT_WINDOW_CHECKS:
        owin, _ = overlap_window(ws, HAT_MAIN["overlap_ratio"])
        nq, nk = ws * ws, owin * owin
        fwd, bwd = counter("oca_core_fwd", nq, nk), counter("oca_core_bwd", nq, nk)
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator().manual_seed(SEED + 100 + ws)

            def view(n, scale):  # (bw, heads, n, d) over (bw, n, heads, d) storage, as the OCAB's views
                return (torch.randn(bw, n, heads, d, generator=gen) * scale).to(dev, dtype).transpose(1, 2)

            q, k, v, g = view(nq, 2 * d**-0.5), view(nk, 1.0), view(nk, 1.0), view(nq, 1.0)
            bias = (torch.randn(heads, nq, nk, generator=gen) * 2.0).to(dev, dtype)
            label = f"hat window {ws} {str(dtype)[6:]}"
            engagement.reset()
            out = oca_core_fwd(q, k, v, bias)
            twice = dtype == torch.bfloat16 and fwd in BITWISE
            if twice and not torch.equal(out, oca_core_fwd(q, k, v, bias)):
                failed.append(f"{fwd} [{label}]: two launches differ")
            grads = oca_core_bwd(q, k, v, bias, g)
            again = oca_core_bwd(q, k, v, bias, g)
            torch.cuda.synchronize()
            want = {fwd: {TRAIN_ENTRIES[dtype][fwd]: 1 + twice}, bwd: {TRAIN_ENTRIES[dtype][bwd]: 2}}
            if engagement.entries() != want:
                failed.append(f"{label}: entries {engagement.entries()}, expected {want}")
            errs = [kernel_check(f"{fwd} [{label}, {bw} windows, {nq} | {nk}]", out,
                                 oca_core_plain(q.float(), k.float(), v.float(), bias), dtype, failed)]
            plain = oca_core_bwd_plain(q.float(), k.float(), v.float(), bias, g.float())
            errs += [kernel_check(f"{bwd} [{label}] output {i}", a, e, dtype, failed)
                     for i, (a, e) in enumerate(zip(grads, plain))]
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                failed.append(f"{bwd} [{label}]: two launches differ")
            del q, k, v, g, bias, out, grads, again, plain

            x, ops = hat_window_ocab_ops(dev, dtype, ws, (1, 2 * ws, 3 * ws), SEED + 200 + ws)
            kw = dict(heads=heads, window_size=ws, overlap_ratio=HAT_MAIN["overlap_ratio"])
            engagement.reset()
            got = fused_ocab_block(x, *ops, **kw)
            same = True
            if dtype == torch.bfloat16:
                served = list(ops)
                served[2], served[4], served[9], served[11] = (pack_ocab_block(ops[2], ops[4], ops[9], ops[11], heads),
                                                               None, None, None)
                same = torch.equal(got, fused_ocab_block(x, *served, **kw)) and torch.equal(
                    got, fused_ocab_block(x, *ops, **kw))
            torch.cuda.synchronize()
            hidden = ops[11].shape[0]
            entry = ("ocab_mma_bf16" if dtype == torch.bfloat16 else "ocab_mma_f32" if ocab_f32_mma_takes(
                c, heads, ws, HAT_MAIN["overlap_ratio"], hidden) else "ocab_f32")
            n = 3 if dtype == torch.bfloat16 else 1
            if engagement.entries() != {"fused_ocab_block": {entry: n}}:
                failed.append(f"{label} B10: entries {engagement.entries()}, expected {n} through {entry}")
            if not same:
                failed.append(f"{label} B10: the blob, dense weights or a second launch give other bits")
            errs.append(kernel_check(f"fused_ocab_block [{label}, map {2 * ws}x{3 * ws}]", got,
                                     ocab_plain(x.float(), *[t.float() for t in ops], **kw), dtype, failed))
            log(f"check {label}: B12 / B13 entries {want}, B10 through {entry}, worst max abs error "
                f"{max(errs):.3e}")
            del x, ops, got
            torch.cuda.empty_cache()


def hat_window_serving(dev: torch.device, ws: int, failed: list) -> tuple:
    """HAT x4 at window ``ws`` (``HAT_MAIN``'s widths, depth not cut), bf16
    fused, batch 1, 256² LR, against the plain f32 forward: the launches of
    a forward (B11, B5, B6 with the join 36 each, B10 6 on the H100 kernel,
    B2 7, B3 1), its ms; then B10 alone on group 0's served operands on a
    264² map, against its plain version, timed with its bound and bf16
    PyTorch sequence. Returns (the kernels line's row, forward ms)."""
    model = HAT.build(**dict(HAT_MAIN, window_size=ws), seed=SEED, device=dev)
    x = torch.from_numpy(requests()[0]).to(dev).float()[None] / 255.0
    plain = model.enable_fused(False)(x)
    model.half().enable_fused(True)
    prep = model.serving_prep()  # load-time weight layout, outside the counted run
    engagement.reset()
    fused = model(x)
    torch.cuda.synchronize()
    launches = engagement.counters()
    per = {"fused_cab_body": 36, "fused_window_attention_block" + window_family(ws): 36, "fused_mlp_block_extra": 36,
           "fused_ocab_block": 6, "fused_conv3x3": 7, "fused_upsample_x4": 1}
    rel = rel_l2(fused, plain)
    log(f"\nhat windows: HAT x4 window {ws} bf16 fused vs f32 plain: rel_l2 {rel:.3e} limit {E2E_BF16_REL_L2:.0e}; "
        f"launches {launches}")
    if not rel <= E2E_BF16_REL_L2 or fused.shape != (1, 4 * LR, 4 * LR, 3) or not bool(torch.isfinite(fused).all()):
        failed.append(f"hat window {ws}: rel_l2 {rel:.3e}, shape {tuple(fused.shape)}")
    if launches != per:
        failed.append(f"hat window {ws}: launches {launches}, expected {per}")
    failed += entry_failures(f"hat windows window {ws}", launches)
    del plain, fused
    fwd = time_ms(lambda: model(x), iters=5)
    log(f"hat windows: HAT x4 forward bf16 batch 1 {LR}x{LR} at window {ws}: {fwd:.3f} ms "
        f"({LR * LR / 1e6 / (fwd / 1e3):.3f} LR MP/s)")

    name, c, heads = "fused_ocab_block", HAT_MAIN["embed_dim"], HAT_MAIN["num_heads"][0]
    hp = LR + (-LR % ws)
    xb = torch.randn(1, hp, hp, c, generator=torch.Generator().manual_seed(SEED + ws)).to(dev, torch.bfloat16)
    ops = (xb, *prep["ocab"][0].values())
    # the served blob (q|k|v, proj, fc1, fc2) and the bias in bf16; the plain version on the dense weights
    dense = dense_ocab(ops, unpack_ocab_block(ops[3], c, heads, ops[11].numel()))
    kw = dict(heads=heads, window_size=ws, overlap_ratio=HAT_MAIN["overlap_ratio"])
    engagement.reset()
    got = fused_ocab_block(*ops, **kw)
    if engagement.entries() != {name: {"ocab_mma_bf16": 1}}:
        failed.append(f"{name} at window {ws} launched {engagement.entries()}")
    err = kernel_check(f"{name} [hat window {ws}, {hp}x{hp}]", got, ocab_plain(*[t.float() for t in dense], **kw),
                       torch.bfloat16, failed)
    del got
    ms = time_ms(lambda: fused_ocab_block(*ops, **kw), iters=20)
    plain_ms = time_ms(lambda: ocab_plain(*dense, **kw), iters=3, warmup=1)
    flops, moved = hat_bounds(name, ops)
    bms, by = bound_ms(flops, moved)
    log(f"time {name} [hat window {ws}, {hp}x{hp}] bf16: {ms:.3f} ms ({100 * 6 * ms / fwd:.1f} % of a forward at 6 a "
        f"forward), plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), {flops / 1e9:.2f} GFLOP, "
        f"{moved / 1e6:.1f} MB; launches {launches.get(name, 0)} in the forward")
    yard = ocab_yardstick(ops, ms, bms, ws)
    log(f"  {name} [hat window {ws}] yardstick (bf16 PyTorch sequence, not a single call): {yard:.3f} ms")
    source, replaces = KERNELS[name]
    row = dict(name=f"{name}_ws{ws}", route="cuda", source=source, replaces=replaces, launches=launches.get(name, 0),
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)
    del model, prep, ops, dense, xb
    torch.cuda.empty_cache()
    return row, fwd


def hat_ws24_train(dev: torch.device, failed: list) -> tuple:
    """Trainer.run on HAT x4 at window 24 (``HAT_WS24_TRAIN``) for
    ``HAT_WS24_STEPS`` steps at the recipe (the trainer's defaults on the
    card: bf16, fused_train, batch 32 of 64² crops): launches a step, finite
    losses, peak memory; then the step's ms over 5 steps after 2 warm-up
    steps. Returns (launches of the run, step ms)."""
    shutil.rmtree(HAT_WS24_DIR, ignore_errors=True)
    losses: list = []
    model = HAT.build(**HAT_WS24_TRAIN, seed=SEED, device=dev)
    trainer = _trainer(dev, SEED, losses, model=model, steps=HAT_WS24_STEPS, eval_interval=HAT_WS24_STEPS + 1,
                       ckpt_path=HAT_WS24_DIR)
    torch.cuda.reset_peak_memory_stats()
    engagement.reset()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, entries = engagement.counters(), engagement.entries()
    peak = torch.cuda.max_memory_allocated() / 2**30
    values = [float(v) for v in losses]
    log(f"\nhat windows: HAT x4 window 24 trained {HAT_WS24_STEPS} steps at batch {TRAIN_BATCH} in {seconds:.3f} s "
        f"(host clock, first steps included); bf16 {trainer.bfloat16}, fused_train {trainer.fused_train}; peak memory "
        f"{peak:.2f} GiB; launches {launches}; losses {[round(v, 6) for v in values]}")
    if not (trainer.bfloat16 and trainer.fused_train):
        failed.append("hat window 24: the trainer did not default to bf16 and fused_train")
    for name in set(launches) | set(HAT_WS24_PER_STEP):
        if launches.get(name, 0) != HAT_WS24_PER_STEP.get(name, 0) * HAT_WS24_STEPS:
            failed.append(f"hat window 24 trainer: {name} {launches.get(name, 0)} launches in {HAT_WS24_STEPS} steps, "
                          f"expected {HAT_WS24_PER_STEP.get(name, 0)} a step")
    if len(values) != HAT_WS24_STEPS or not all(np.isfinite(values)):
        failed.append(f"hat window 24 losses {values}")
    failed += train_entry_failures("hat window 24 trainer", launches, torch.bfloat16, entries)
    shutil.rmtree(HAT_WS24_DIR, ignore_errors=True)
    del trainer

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
    log(f"hat windows: HAT x4 window 24 train step bf16 batch {TRAIN_BATCH} {TRAIN_CROP}x{TRAIN_CROP} (72² after the "
        f"padding, 288 windows): {step_ms:.3f} ms, {TRAIN_BATCH / (step_ms / 1e3):.1f} images/s, peak memory "
        f"{peak:.2f} GiB")
    del state, tx, model, module
    torch.cuda.empty_cache()
    return launches, step_ms


def hat_ws24_oca_rows(dev: torch.device, launches: dict, step_ms: float, failed: list) -> list:
    """B12 and B13 in their large family at the window-24 step's shapes (288
    windows, 6 heads, 576 queries, 1296 keys, d 30, the OCAB's transposed
    views, the bias in bf16 as the bf16 step gathers it): against their
    plain versions, two launches the same bits, timed beside the plain
    versions and SDPA with the bias as its mask. The kernels line's two
    ``_large`` rows."""
    c, heads, ws = HAT_MAIN["embed_dim"], HAT_MAIN["num_heads"][0], 24
    owin, _ = overlap_window(ws, HAT_MAIN["overlap_ratio"])
    d, nq, nk = c // heads, ws * ws, owin * owin
    bw = TRAIN_BATCH * (-(-TRAIN_CROP // ws)) ** 2
    gen = torch.Generator().manual_seed(SEED + 24)

    def view(n, scale):
        return (torch.randn(bw, n, heads, d, generator=gen) * scale).to(dev, torch.bfloat16).transpose(1, 2)

    q, k, v, go = view(nq, 2 * d**-0.5), view(nk, 1.0), view(nk, 1.0), view(nq, 1.0)
    bias = (torch.randn(heads, nq, nk, generator=gen) * 2.0).to(dev, torch.bfloat16)
    rows = []
    for name, kernel, plain, ops in (("oca_core_fwd_large", oca_core_fwd, oca_core_plain, (q, k, v, bias)),
                                     ("oca_core_bwd_large", oca_core_bwd, oca_core_bwd_plain, (q, k, v, bias, go))):
        label = f"hat window 24 step, {bw} windows, {nq} | {nk}"
        engagement.reset()
        got = _flat(kernel(*ops))
        again = _flat(kernel(*ops))
        torch.cuda.synchronize()
        if engagement.entries() != {name: {TRAIN_ENTRIES[torch.bfloat16][name]: 2}}:
            failed.append(f"{name} [{label}]: entries {engagement.entries()}")
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"check {name} [{label}] bf16: two launches give the same bits: {same}")
        if not same:
            failed.append(f"{name} [{label}]: two launches differ")
        del again
        want = _flat(plain(*[t.float() for t in ops]))
        err = [kernel_check(f"{name} [{label}] output {i}", a, e, torch.bfloat16, failed)
               for i, (a, e) in enumerate(zip(got, want))][0]
        del got, want
        torch.cuda.empty_cache()
        ms = time_ms(lambda: kernel(*ops), iters=10)
        plain_ms = time_ms(lambda: plain(*ops), iters=3, warmup=1)
        torch.cuda.empty_cache()
        flops, moved = oca_bounds(name.replace("_large", ""), ops)
        bms, by = bound_ms(flops, moved)
        library_ms = sdpa_ms(name.replace("_large", ""), ops)
        torch.cuda.empty_cache()
        log(f"time {name} [{label}] bf16: {ms:.3f} ms ({100 * 6 * ms / step_ms:.1f} % of a window-24 step at 6 a "
            f"step), plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), library (SDPA, the bias as its mask) "
            f"{library_ms if library_ms is None else round(library_ms, 4)} ms, {flops / 1e9:.2f} GFLOP, "
            f"{moved / 1e6:.1f} MB; launches {launches.get(name, 0)} in {HAT_WS24_STEPS} steps; "
            f"{100 * bms / ms:.1f} % of the bound; {ptxas_report(name)}")
        source, replaces = KERNELS[name]
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches.get(name, 0),
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=library_ms))
    del q, k, v, go, bias
    torch.cuda.empty_cache()
    return rows


def hat_ws24_attention_rows(dev: torch.device, launches: dict, step_ms: float, failed: list) -> list:
    """B5 and B9 in their large families at the window-24 step's shapes
    (batch 32 of 72² maps, 288 windows of 576 tokens, C 180, 6 heads, shift
    12, drop-path scales with a 0, the bias in bf16 as the bf16 step gathers
    it): against their plain versions, B9's two launches the same bits, each
    timed beside its plain version and its bf16 PyTorch sequence, with its
    bound. The kernels line's ``*_large_hat_ws24`` rows (B9's on
    ``lb_core.cuh``)."""
    ws = 24
    c, heads = HAT_MAIN["embed_dim"], HAT_MAIN["num_heads"][0]
    side = -(-TRAIN_CROP // ws) * ws
    x, g, ops = large_window_ops(dev, torch.bfloat16, c, heads, ws, (TRAIN_BATCH, side, side), SEED + 240)
    ops[6] = ops[6].to(torch.bfloat16)
    kw = kw_of(f"shift {ws // 2}", ws, TRAIN_BATCH, dev)
    label = f"hat window 24 step, {TRAIN_BATCH} x {side}² maps, C {c}, {heads} heads"
    rows = []
    cases = (("fused_window_attention_block_large", fused_window_attention_block, window_attention_plain, (x, *ops)),
             ("attention_bwd_large", attention_bwd, attention_bwd_plain, (x, g, *ops)))
    for name, kernel, plain, args in cases:
        engagement.reset()
        got = _flat(kernel(*args, **kw))
        again = _flat(kernel(*args, **kw))
        torch.cuda.synchronize()
        if engagement.entries() != {name: {TRAIN_ENTRIES[torch.bfloat16][name]: 2}}:
            failed.append(f"{name} [{label}]: entries {engagement.entries()}")
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"check {name} [{label}] bf16: two launches give the same bits: {same}")
        if not same:
            failed.append(f"{name} [{label}]: two launches differ")
        del again
        want = _flat(plain(*[t.float() for t in args], **kw))
        err = [kernel_check(f"{name} [{label}] output {i}", a, e, torch.bfloat16, failed)
               for i, (a, e) in enumerate(zip(got, want))][0]
        del got, want
        torch.cuda.empty_cache()
        ms = time_ms(lambda: kernel(*args, **kw), iters=10)
        plain_ms = time_ms(lambda: plain(*args, **kw), iters=3, warmup=1)
        torch.cuda.empty_cache()
        flops, moved = train_bounds(name, args)
        bms, by = bound_ms(flops, moved)
        log(f"time {name} [{label}] bf16: {ms:.3f} ms ({100 * 36 * ms / step_ms:.1f} % of a window-24 step at 36 a "
            f"step), plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), {flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} "
            f"MB; launches {launches.get(name, 0)} in {HAT_WS24_STEPS} steps")
        yardstick_report(name, args, ms, bms, kw)
        source, replaces = KERNELS[name]
        rows.append(dict(name=f"{name}_hat_ws24", route="cuda", source=source, replaces=replaces,
                         launches=launches.get(name, 0), max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by, library_ms=None))
    del x, g, ops
    torch.cuda.empty_cache()
    return rows


def phase_hat_windows(dev: torch.device) -> list:
    """HAT at every window: the kernel checks at windows 4, 12, 24 and 32;
    HAT x4 served at windows 24 and 12 at full width; HAT x4 trained fused
    at window 24 (the Trainer, then the step timed, then B12, B13, B5 and B9
    at the step's shapes); the gradients of the window-24 model against the f64
    witness at batch 4 (the plain runs recompute each window attention and
    OCAB in the backward). Returns the kernels line's rows."""
    failed = []
    start = time.perf_counter()
    hat_window_checks(dev, failed)
    log(f"hat windows: kernel checks at windows {HAT_WINDOW_CHECKS} in {time.perf_counter() - start:.1f} s")
    rows, forwards = [], {}
    for ws in HAT_WINDOWS_SERVED:
        row, forwards[ws] = hat_window_serving(dev, ws, failed)
        rows.append(row)
    launches, step_ms = hat_ws24_train(dev, failed)
    rows += hat_ws24_oca_rows(dev, launches, step_ms, failed)
    rows += hat_ws24_attention_rows(dev, launches, step_ms, failed)
    if failed:
        raise AssertionError("hat windows: " + "; ".join(failed))
    hold_grads(dev, HAT.build(**HAT_WS24_TRAIN, seed=SEED, device=dev), HAT_WS24_PER_STEP, "hat window 24 ",
               recompute=("WindowAttention", "OCAB"))
    log(f"hat windows: {time.perf_counter() - start:.1f} s in all; forwards {forwards} ms")
    return rows


# -- serving over a mesh in one process (A20), every kernel on its operands' card (C10) --


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def slot_launches(model, mesh, fn):
    """``fn()`` and the launches of each slot of ``mesh`` during it, by
    kernel: ``engagement.launched`` is wrapped for the call to file each
    launch also under the stream current on the launching thread, which
    ``run_sharded`` makes the slot's own. The counts themselves are
    unchanged."""
    from studiosr_tpu_torch.parallel import mesh as mesh_module

    streams = {stream.cuda_stream: i for i, (_, stream) in enumerate(mesh_module._slots(model, mesh))}
    per_slot = [Counter() for _ in streams]
    lock, counted = threading.Lock(), engagement.launched

    def launched(name, entry=None):
        counted(name, entry)
        slot = streams.get(torch.cuda.current_stream().cuda_stream)
        if slot is not None:
            with lock:
                per_slot[slot][name] += 1

    engagement.launched = launched
    try:
        out = fn()
    finally:
        engagement.launched = counted
    return out, per_slot


def mesh_model(family: str, device) -> object:
    config = MAIN if family == "swinir" else HAT_MAIN
    return (SwinIR if family == "swinir" else HAT).build(**config, seed=SEED, device=device).half().enable_fused(True)


def mesh_tiled(model, image, mesh, expect, label: str, failed: list) -> dict:
    """Both loops of ``tiled_inference`` over ``mesh`` against the mesh-less
    call on ``model``: the bytes equal, each slot launching every kernel of
    ``expect``; host seconds of a second call of each. Returns {route: s}."""
    from studiosr_tpu_torch.parallel import tiled_inference

    seconds = {}
    for loop in (False, True):
        name = "device loop" if loop else "host loop"
        want = tiled_inference(model, image, device_loop=loop, **MESH_TILED)
        got, per_slot = slot_launches(model, mesh, lambda: tiled_inference(model, image, mesh=mesh, device_loop=loop,
                                                                           **MESH_TILED))
        if got.shape != want.shape or not np.array_equal(got, want):
            failed.append(f"{label} {name}: the mesh's output differs from the mesh-less one")
        for i, counts in enumerate(per_slot):
            missing = [k for k in expect if not counts.get(k)]
            if missing:
                failed.append(f"{label} {name}: slot {i} launched no {missing} (it launched {dict(counts)})")
        for route, run in (("mesh-less", lambda: tiled_inference(model, image, device_loop=loop, **MESH_TILED)),
                           (f"{mesh.size} slots", lambda: tiled_inference(model, image, mesh=mesh, device_loop=loop,
                                                                          **MESH_TILED))):
            torch.cuda.synchronize()
            start = time.perf_counter()
            run()
            seconds[f"{name}, {route}"] = time.perf_counter() - start
        log(f"mesh serving: {label} {name}: {'bytes equal' if np.array_equal(got, want) else 'DIFFER'} "
            f"{got.shape}; launches a slot {[dict(c) for c in per_slot]}")
    return seconds


def phase_mesh_serving(dev: torch.device) -> None:
    """A20 and C10 on the card: SwinIR x4 at 1024² and HAT x4 at 512², bf16
    fused, tiled over a mesh of two slots on this card in both loops, and
    ``evaluate_uint8_batch`` over it, each against the mesh-less call byte
    for byte (scores exactly), with each slot's launches; where the machine
    has two cards or more, the same over a mesh of every card and a model
    built on ``cuda:1`` served while ``cuda:0`` is current. Host seconds of
    each route beside the card's name and power limit."""
    from studiosr_tpu_torch.parallel import get_mesh, tiled_inference

    failed = []
    start = time.perf_counter()
    rng = np.random.default_rng(SEED + 21)
    index = torch.cuda.current_device()
    two = get_mesh([torch.device("cuda", index)] * 2)
    cards = torch.cuda.device_count()
    card = card_line()
    for family, side, expect in MESH_MODELS:
        model = mesh_model(family, dev)
        image = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
        seconds = mesh_tiled(model, image, two, expect, f"{family} x4 {side}²", failed)
        n, lr = MESH_EVAL
        lqs = rng.integers(0, 256, (n, lr, lr, 3), dtype=np.uint8)
        gts = rng.integers(0, 256, (n, 4 * lr, 4 * lr, 3), dtype=np.uint8)
        want = model.evaluate_uint8_batch(lqs, gts, crop_border=4)
        got = model.evaluate_uint8_batch(lqs, gts, crop_border=4, mesh=two)
        same = all(np.array_equal(a, b) for a, b in zip(got, want))
        log(f"mesh serving: {family} evaluate_uint8_batch of {n} {lr}² over 2 slots: PSNR {got[0].tolist()}, "
            f"{'the mesh-less scores exactly' if same else 'DIFFERENT from the mesh-less ' + str(want[0].tolist())}")
        if not same:
            failed.append(f"{family} evaluate_uint8_batch: the mesh's scores differ from the mesh-less ones")
        if cards >= 2:
            every = get_mesh()
            seconds.update({f"every card ({cards}) {k}": v for k, v in
                            mesh_tiled(model, image, every, expect, f"{family} x4 {side}² {cards} cards",
                                       failed).items()})
            with torch.cuda.device(0):
                other = mesh_model(family, "cuda:1")
                moved = np.array_equal(tiled_inference(other, image, **MESH_TILED),
                                       tiled_inference(model, image, **MESH_TILED))
            log(f"mesh serving: {family} built on cuda:1 and served while cuda:0 is current (C10): "
                f"{'the bytes' if moved else 'NOT the bytes'} of cuda:{index}'s")
            if not moved:
                failed.append(f"{family}: served on cuda:1 with cuda:0 current, the output differs from cuda:{index}'s")
            del other
        log(f"mesh serving: {family} x4 {side}² tiled (tile {MESH_TILED['tile']}, overlap "
            f"{MESH_TILED['tile_overlap']}, batch {MESH_TILED['tile_batch']}), host seconds of a second call "
            f"(synchronised before, the copy to the host after): "
            + ", ".join(f"{k} {v:.4f}" for k, v in seconds.items()) + f" [{card}]")
        del model
        torch.cuda.empty_cache()
    if cards < 2:
        log(f"mesh serving: one card (torch.cuda.device_count() == {cards}): the cross-card half did not run")
    if failed:
        raise AssertionError("mesh serving: " + "; ".join(failed))
    log(f"mesh serving: {time.perf_counter() - start:.1f} s in all")


# -- the zoo, offline -------------------------------------------------------------------


def release_state(model, family: str) -> dict:
    """A seeded port model's parameters in a release's layout: the
    state_dict, SwinIR's and HAT's recomputed rel-pos indices and shift
    masks, the MeanShift convs of EDSR and RCAN, and (SwinIR) the first
    three keys under a ``module.`` prefix."""
    state = {k: v.detach().cpu().clone() for k, v in model.module.state_dict().items()}
    ws = model.config.get("window_size", 8)
    if family in ("swinir", "hat"):
        blocks = sorted({k.split(".attn.")[0] for k in state if ".residual_group.blocks." in k and ".attn." in k})
        for i, prefix in enumerate(blocks):
            state[f"{prefix}.attn.relative_position_index"] = torch.zeros(ws * ws, ws * ws, dtype=torch.int64)
            if i % 2:
                state[f"{prefix}.attn_mask"] = torch.zeros(4, ws * ws, ws * ws)
    else:
        for name in ("sub_mean", "add_mean"):
            state[f"{name}.weight"] = torch.eye(3).reshape(3, 3, 1, 1)
            state[f"{name}.bias"] = torch.zeros(3)
    if family == "swinir":
        for key in sorted(state)[:3]:
            state[f"module.{key}"] = state.pop(key)
    return state


def loaded_failures(label: str, model, written: dict) -> list:
    """[] when every parameter and buffer of ``model`` equals the written
    release's (``module.`` prefixes stripped), bit for bit."""
    written = {k[len("module."):] if k.startswith("module.") else k: v for k, v in written.items()}
    bad = [k for k, v in model.module.state_dict().items()
           if not k.endswith("num_batches_tracked") and not torch.equal(v.cpu(), written[k].to(v.dtype))]
    log(f"zoo {label}: {len(model.module.state_dict())} entries loaded, {len(bad)} differ from the written file")
    return [f"zoo {label}: {bad[:5]} differ from the written release"] if bad else []


def phase_zoo(dev: torch.device) -> None:
    """The published-weight zoo with no network: a SwinIR x4 release file
    (``{"params": state}`` from a seeded port SwinIR x4, the recomputed
    buffers, three keys under ``module.``) under a temporary ``./pretrained``;
    ``python3 -m studiosr_tpu_torch`` without ``--ckpt`` serves a fixture LR
    image from there (``--half``); the parameters ``SwinIR.from_pretrained``
    loads equal the written ones bit for bit, and the CLI's PNG equals the
    in-process fused bf16 output, B1-B3 launched; then HAT (``params_ema``),
    EDSR (DIV2K, pixel range 255) and RCAN x4 at their published widths the
    same way, one 32² forward each on the card."""
    failed = []
    lr = imread(str(FIXTURES / "img0_lrx4.png"))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "pretrained").mkdir()
        source = SwinIR.build(scale=4, seed=SEED + 7, device="cpu")
        written = release_state(source, "swinir")
        torch.save({"params": written, "iter": 500000}, root / "pretrained" / ZOO_SWINIR_FILE)
        cmd = [sys.executable, "-m", "studiosr_tpu_torch", "--image", str(FIXTURES / "img0_lrx4.png"), "--scale",
               "4", "--model", "swinir", "--output", "out", "--half"]
        t0 = time.perf_counter()
        subprocess.run(cmd, cwd=root, env=dict(os.environ, PYTHONPATH=str(ROOT)), check=True, timeout=600,
                       capture_output=True, text=True)
        log(f"zoo: the CLI without --ckpt served {ZOO_SWINIR_FILE} in {time.perf_counter() - t0:.1f} s (host clock)")
        cli = imread(str(root / "out" / "img0_lrx4.swinir_x4.png"))
        os.chdir(root)
        try:
            model = SwinIR.from_pretrained(scale=4)
            failed += loaded_failures("swinir x4", model, written)
            model.half().enable_fused(True).serving_prep()
            engagement.reset()
            out = model.inference(lr)
            launches = engagement.counters()
            log(f"zoo swinir x4 in process, fused bf16: launches {launches}; the CLI's PNG "
                f"{'equals' if np.array_equal(cli, out) else 'differs from'} the in-process output "
                f"({int((cli != out).sum())} values differ)")
            if not np.array_equal(cli, out):
                failed.append("zoo: the CLI's PNG differs from the in-process from_pretrained output")
            if launches != ZOO_PER_FORWARD:
                failed.append(f"zoo swinir x4: launches {launches}, expected {ZOO_PER_FORWARD}")
            failed += entry_failures("zoo swinir x4", launches)
            del model, source
            x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(SEED + 8)).to(dev)
            for family, file_name, wrapper in ZOO_OTHERS:
                cls = get_model_class(family)
                kw = {"img_range": 255.0} if family in ("edsr", "rcan") else {}
                written = release_state(cls.build(scale=4, seed=SEED + 7, device="cpu", **kw), family)
                path = root / "pretrained" / file_name
                path.parent.mkdir(parents=True, exist_ok=True)
                torch.save(written if wrapper is None else {wrapper: written}, path)
                model = cls.from_pretrained(scale=4)
                failed += loaded_failures(f"{family} x4", model, written)
                y = model(x * (255.0 if model.img_range == 255.0 else 1.0))
                torch.cuda.synchronize()
                log(f"zoo {family} x4 ({model.count_parameters()} parameters) 32² forward on the card: "
                    f"{tuple(y.shape)}, finite {bool(torch.isfinite(y).all())}")
                if y.shape != (1, 128, 128, 3) or not bool(torch.isfinite(y).all()):
                    failed.append(f"zoo {family} x4: bad forward {tuple(y.shape)}")
                del model
        finally:
            os.chdir(cwd)
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))


# -- the conv families (cuDNN convs; no kernel of the port) ---------------------------


def conv_layer_errors(module: torch.nn.Module) -> tuple:
    """Forward hooks on every NHWC ``Conv`` of ``module``: each call's output
    against the same conv in f32 on the same (bf16) input and weights,
    relative L2. Returns (handles, [(name, rel), ...])."""
    errors = []

    def hook(name):
        def check(conv, inputs, out):
            bias = None if conv.bias is None else conv.bias.float()
            want = conv._conv_forward(inputs[0].permute(0, 3, 1, 2).float(), conv.weight.float(), bias)
            errors.append((name, rel_l2(out, want.permute(0, 2, 3, 1))))
        return check

    handles = [m.register_forward_hook(hook(n)) for n, m in module.named_modules() if isinstance(m, Conv)]
    return handles, errors


def phase_conv_serving(dev: torch.device) -> None:
    """Each conv family x4 at its build defaults (the published widths and
    the reference's flax init): every conv of the bf16 forward against the
    same conv in f32 on the same input (relative L2, held); the bf16 forward
    against the f32 one end to end (relative L2, logged: at the reference
    init RCAN's and HAN's 200 residual blocks grow the output to ~1e6, where
    bf16's rounding is amplified past any limit; the trained checkpoints of
    phase 30 hold it); three bf16 requests through ``inference`` with no
    kernel of the port launched; the bf16 forward's time."""
    images = requests()
    x = torch.from_numpy(images[0]).to(dev).float()[None] / 255.0
    failed = []
    for name in CONV_FAMILIES:
        model = get_model_class(name).build(scale=4, seed=SEED, device=dev)
        plain = model(x)
        model.half()
        handles, layers = conv_layer_errors(model.module)
        engagement.reset()
        try:
            y16 = model(x)
        finally:
            for handle in handles:
                handle.remove()
        outs = [model.inference(im) for im in images]
        launches = engagement.counters()
        torch.cuda.synchronize()
        rel16 = rel_l2(y16, plain)
        worst = max(layers, key=lambda e: e[1])
        fwd = time_ms(lambda: model(x), iters=5)
        log(f"{name} x4 ({model.count_parameters()} parameters) bf16: {len(layers)} conv calls each vs f32 on its "
            f"input, worst rel_l2 {worst[1]:.3e} ({worst[0]}) limit {E2E_BF16_REL_L2:.0e}; end to end vs the f32 "
            f"forward rel_l2 {rel16:.3e} (f32 output std {float(plain.std()):.3e}); served {len(outs)} requests, "
            f"launches {launches}; forward bf16 batch 1 {LR}x{LR}: {fwd:.3f} ms, "
            f"{LR * LR / 1e6 / (fwd / 1e3):.3f} LR MP/s")
        if not worst[1] <= E2E_BF16_REL_L2:
            failed.append(f"{name}: bf16 conv {worst[0]} disagrees with f32 on its input ({worst[1]:.3e})")
        if not bool(torch.isfinite(y16).all()) or y16.shape != (1, 4 * LR, 4 * LR, 3):
            failed.append(f"{name}: bf16 forward {tuple(y16.shape)}, finite {bool(torch.isfinite(y16).all())}")
        if launches:
            failed.append(f"{name}: launched {launches}")
        if any(o.shape != (4 * LR, 4 * LR, 3) or o.dtype != np.uint8 for o in outs):
            failed.append(f"{name}: bad outputs")
        del model, plain, y16
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))


def phase_conv_train(dev: torch.device) -> None:
    """``Trainer.run`` for 3 steps of EDSR and of SRResNet (BatchNorm) at
    their recipes (``get_training_config``) on the seeded in-memory dataset:
    finite losses, moved weights and (SRResNet) running statistics, no kernel
    of the port launched."""
    failed = []
    for name in CONV_TRAIN:
        shutil.rmtree(CONV_TRAIN_DIR, ignore_errors=True)
        model = get_model_class(name).build(scale=4, seed=SEED, device=dev)
        recipe = model.get_training_config()
        loss_fn, losses = get_loss(recipe.pop("loss_function", "l1")), []

        def criterion(pred, target, loss_fn=loss_fn, losses=losses):
            loss = loss_fn(pred, target)
            losses.append(loss.detach())
            return loss

        trainer = Trainer(model, MemoryPairs(SEED), **{**recipe, "max_iters": CONV_TRAIN_STEPS}, num_workers=4,
                          eval_interval=CONV_TRAIN_STEPS + 1, ckpt_path=str(CONV_TRAIN_DIR), seed=SEED,
                          log_interval=100, loss_function=criterion)
        module = model.module
        before = {k: v.clone() for k, v in module.state_dict().items() if not k.endswith("num_batches_tracked")}
        engagement.reset()
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = engagement.counters()
        values = [float(v) for v in losses]
        state = module.state_dict()
        moved = sum(not torch.equal(state[k], v) for k, v in before.items())
        log(f"{name} trained {CONV_TRAIN_STEPS} steps at its recipe (batch {recipe['batch_size']}, bf16 "
            f"{trainer.bfloat16}) in {seconds:.3f} s (host clock); losses {[round(v, 6) for v in values]}; "
            f"{moved} of {len(before)} parameters and running statistics moved; launches {launches}")
        if len(values) != CONV_TRAIN_STEPS or not all(np.isfinite(values)):
            failed.append(f"{name} losses {values}")
        if moved != len(before):
            failed.append(f"{name}: only {moved} of {len(before)} parameters and statistics moved")
        if launches or trainer.bfloat16 != recipe.get("bfloat16", True):
            failed.append(f"{name}: launches {launches}, bf16 {trainer.bfloat16}")
        del trainer, model
        torch.cuda.empty_cache()
    shutil.rmtree(CONV_TRAIN_DIR, ignore_errors=True)
    if failed:
        raise AssertionError("; ".join(failed))


# -- the user's entry points: trained checkpoints, Evaluator, CLI -----------------


def fixture_pairs(scale: int, suffix: str = ""):
    """The three fixture images: (LR at ``scale``, HR mod-cropped to it),
    read with the port's PNG codec; ``suffix`` names another LR file."""
    pairs = []
    for i in range(3):
        hr = imread(str(FIXTURES / f"img{i}_hr.png"))
        hr = hr[: hr.shape[0] // scale * scale, : hr.shape[1] // scale * scale]
        pairs.append((imread(str(FIXTURES / f"img{i}{suffix or f'_lrx{scale}'}.png")), hr))
    return pairs


def bicubic(lr: np.ndarray, h: int, w: int, dev: torch.device) -> np.ndarray:
    x = torch.from_numpy(lr).to(dev).float().permute(2, 0, 1)[None] / 255.0
    up = F.interpolate(x, size=(h, w), mode="bicubic", align_corners=False)
    return torch.clamp(torch.round(up * 255.0), 0, 255).to(torch.uint8)[0].permute(1, 2, 0).cpu().numpy()


def stats_restored(model, subdir: str) -> list:
    """[] when the BatchNorm running statistics (MaxSR's MBConvs, SRResNet's
    blocks) came back from the checkpoint (not the initial mean 0 / variance
    1), else the failure."""
    stats = {k: v for k, v in model.module.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    moved = [k for k, v in stats.items() if not torch.equal(v, torch.zeros_like(v) if k.endswith("mean") else
                                                         torch.ones_like(v))]
    log(f"trained {subdir}: {len(moved)} of {len(stats)} running statistics differ from their initial values")
    return [] if stats and len(moved) == len(stats) else [f"{subdir}: BatchNorm running statistics not restored"]


def phase_trained(dev: torch.device) -> list:
    """The eighteen trained checkpoints on the card, each image against the
    floors. Returns (checkpoint, image, bicubic, plain, fused f32, fused
    bf16) PSNRs."""
    table, failed = [], []
    for subdir, name, scale in TRAINED:
        ckpt = str(FIXTURES / subdir)
        for i, (lr, hr) in enumerate(fixture_pairs(scale)):
            model = load_model(ckpt, name, device=dev)
            if name == "maxsr" and i == 0:
                failed += stats_restored(model, subdir)
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
    for subdir, name, scale, suffix in CONV_TRAINED:
        ckpt = str(FIXTURES / subdir)
        for i, (lr, hr) in enumerate(fixture_pairs(scale, suffix)):
            model = load_model(ckpt, name, device=dev)
            if name == "srresnet" and i == 0:
                failed += stats_restored(model, subdir)
            bi = compute_psnr(bicubic(lr, *hr.shape[:2], dev), hr)
            plain = compute_psnr(model.inference(lr), hr)
            x = torch.from_numpy(lr).to(dev).float()[None] / 255.0
            y32 = model(x)
            engagement.reset()
            rel16 = rel_l2(model.half()(x), y32)
            bf16 = compute_psnr(model.inference(lr), hr)
            launches = engagement.counters()
            table.append((subdir, i, bi, plain, None, bf16))
            log(f"trained {subdir} img{i}: bicubic {bi:.4f} plain f32 {plain:.4f} bf16 {bf16:.4f} dB; bf16 vs f32 "
                f"forward rel_l2 {rel16:.3e} limit {E2E_BF16_REL_L2:.0e}")
            if not rel16 <= E2E_BF16_REL_L2:
                failed.append(f"{subdir} img{i}: bf16 forward vs f32 rel_l2 {rel16:.3e}")
            if name == "espcn":
                if not (plain > bi + ESPCN_FLOOR and plain > ESPCN_ABSOLUTE and bf16 > bi + ESPCN_FLOOR):
                    failed.append(f"{subdir} img{i}: plain {plain:.3f}, bf16 {bf16:.3f} vs bicubic {bi:.3f}")
            elif not (plain > bi + CONV_FLOOR_PLAIN and bf16 > bi + CONV_FLOOR_BF16):
                failed.append(f"{subdir} img{i}: plain {plain:.3f}, bf16 {bf16:.3f} vs bicubic {bi:.3f}")
            if launches:
                failed.append(f"{subdir}: launched {launches}")
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
    # a conv family's checkpoint the same way (EDSR x4, bf16 on cuDNN)
    conv_ckpt = FIXTURES / "edsr_ckpt"
    conv_want = compute_psnr(load_model(str(conv_ckpt), "edsr", device=dev).half().inference(lr), hr)
    out = CLI_DIR / "edsr"
    cmd = [sys.executable, "-m", "studiosr_tpu_torch", "--image", str(image.relative_to(ROOT)), "--scale", "4",
           "--model", "edsr", "--ckpt", str(conv_ckpt.relative_to(ROOT)), "--output", str(out), "--half"]
    t0 = time.perf_counter()
    subprocess.run(cmd, cwd=ROOT, check=True, timeout=600, capture_output=True, text=True)
    conv_cli = compute_psnr(imread(str(out / "img0_lrx4.edsr_x4.png")), hr)
    log(f"cli edsr_ckpt ({time.perf_counter() - t0:.1f} s, host clock): PSNR {conv_cli:.4f} dB; in process bf16 "
        f"{conv_want:.4f} dB")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    failed = []
    if not abs(psnrs["whole"] - want) < CLI_PSNR:
        failed.append(f"the CLI's {psnrs['whole']:.4f} dB differs from the in-process {want:.4f} dB")
    if not abs(conv_cli - conv_want) < CLI_PSNR:
        failed.append(f"the CLI's EDSR {conv_cli:.4f} dB differs from the in-process {conv_want:.4f} dB")
    if not (psnrs["tiled"] > psnrs["whole"] - TILED_PSNR and tiled16 > want - TILED_PSNR):
        failed.append(f"tiled {psnrs['tiled']:.4f} / {tiled16:.4f} dB vs whole {psnrs['whole']:.4f} dB")
    if failed:
        raise AssertionError("; ".join(failed))


def phase_maxsr_decline(dev: torch.device) -> None:
    """C6: MaxSR adaptive with ``enable_fused(True)`` serves a 1025² LR
    image: each attention call over 1024 tokens a window is B15's recorded
    structural decline (two a forward), nothing launches, and the output is
    the unfused route's, bit for bit."""
    model = MaxSR.build(**DECLINE_MODEL, seed=SEED, device=dev).half()
    image = np.random.default_rng(SEED + 77).integers(0, 256, (DECLINE_LR, DECLINE_LR, 3), dtype=np.uint8)
    x = torch.from_numpy(image).to(dev).float()[None] / 255.0
    failed, side = [], 4 * DECLINE_LR
    torch.cuda.reset_peak_memory_stats()
    engagement.reset()
    start = time.perf_counter()
    served = model.enable_fused(True).inference(image)
    seconds = time.perf_counter() - start
    launches, declines = engagement.counters(), engagement.declines()
    with torch.no_grad():
        fused = model(x)
    torch.cuda.synchronize()
    after = engagement.declines()
    engagement.reset()
    unfused_served = model.enable_fused(False).inference(image)
    with torch.no_grad():
        unfused = model(x)
    torch.cuda.synchronize()
    log(f"\nC6: MaxSR adaptive dim {DECLINE_MODEL['dim']}, depth {DECLINE_MODEL['depth']}, fused bf16 at "
        f"{DECLINE_LR}² LR: served {served.shape} {served.dtype} in {seconds:.2f} s (host clock, first call), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}; declines {declines}; the float "
        f"forward's max |fused - unfused| {float((fused - unfused).abs().max()):.3e}; uint8 "
        f"{'equal' if np.array_equal(served, unfused_served) else 'differ'}")
    if served.shape != (side, side, 3) or served.dtype != np.uint8:
        failed.append(f"C6: served {served.shape} {served.dtype}, expected ({side}, {side}, 3) uint8")
    if launches:
        failed.append(f"C6: the declined forward launched {launches}")
    if declines.get("window_attention_pallas", {}).get("count") != 2 or set(declines) != {"window_attention_pallas"}:
        failed.append(f"C6: declines {declines}, expected two of window_attention_pallas (one an attention call)")
    if after.get("window_attention_pallas", {}).get("count") != 4:
        failed.append(f"C6: the float forward recorded {after}, expected two more declines")
    if engagement.declines():
        failed.append(f"C6: the unfused route recorded declines {engagement.declines()}")
    if not (torch.equal(fused, unfused) and np.array_equal(served, unfused_served)):
        failed.append("C6: the declined fused route's output differs from the unfused route's")
    if not bool(torch.isfinite(fused).all()):
        failed.append("C6: non-finite output")
    del model, x, fused, unfused
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))


def entry_corpus(data: Path, dev: torch.device) -> None:
    """ENTRY_SIDES' HR images and their bicubic X2 / X3 / X4 in DIV2K's
    layout (Paeth rows), and a DIV2K_mini set from the fixture PNGs."""
    rng = np.random.default_rng(SEED + 90)
    hr_dir = data / "DIV2K" / "DIV2K_train_HR"
    hr_dir.mkdir(parents=True)
    for i, (h, w) in enumerate(ENTRY_SIDES):
        y, x = np.mgrid[:h, :w]
        base = 128 + 80 * np.sin(x / (9 + 3 * i)) * np.cos(y / (13 + i))
        hr = np.clip(base[..., None] + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
        write_png(str(hr_dir / f"{i + 1:04d}.png"), hr, row_filter=4)
        t = torch.from_numpy(hr).to(dev).float()[None] / 255.0
        for s in (2, 3, 4):
            lr_dir = data / "DIV2K" / "DIV2K_train_LR_bicubic" / f"X{s}"
            lr_dir.mkdir(parents=True, exist_ok=True)
            lr = torch.clamp(torch.round(bicubic_resize(t, h // s, w // s) * 255.0), 0, 255).to(torch.uint8)
            write_png(str(lr_dir / f"{i + 1:04d}x{s}.png"), lr[0].cpu().numpy(), row_filter=4)
    for sub, suffix in (("GTmod12", "hr"), ("LRbicx4", "lrx4")):
        (data / "DIV2K_mini" / sub).mkdir(parents=True)
        for i in range(3):
            imwrite(str(data / "DIV2K_mini" / sub / f"img{i}.png"), imread(str(FIXTURES / f"img{i}_{suffix}.png")))


def host_ms(fn, reps: int) -> float:
    """Median host milliseconds of ``fn()`` over ``reps`` calls."""
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - start))
    return float(np.median(times))


def plain_host_routes(fn):
    """``fn()`` with the host library's callers on their plain versions."""
    available = native.available
    native.available = lambda: False
    try:
        return fn()
    finally:
        native.available = available


def phase_multihost(dev: torch.device, root: Path, common: list) -> list:
    """A17 on the card: ``scripts/torch_train.py --multihost`` as a
    subprocess, a process group of one (``COORDINATOR_ADDRESS`` on a free
    local port, NCCL), the same ``ENTRY_STEPS`` steps as the in-process run
    of ``phase_train_entry`` (whose ``latest`` checkpoint, written at the
    same iteration, is the reference): its parameters bit for bit the run's
    without a group, the gradients and loss having gone through an NCCL
    all-reduce over one rank; then ``evaluate_uint8_batch`` and
    ``tiled_inference`` over the mesh ``[cuda:0]`` against their mesh-less
    outputs on SwinIR x4 serving. Returns the failures."""
    from studiosr_tpu_torch.parallel import get_mesh, tiled_inference

    failed = []
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES="1", PROCESS_ID="0")
    cmd = [sys.executable, "scripts/torch_train.py", *common[:-1], str(root / "ckpt_sub"), "--max-iters",
           str(ENTRY_STEPS), "--profile-dir", str(root / "trace_sub"), "--multihost"]
    start = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, timeout=600, capture_output=True, text=True)
    group = [line for line in proc.stdout.splitlines() if line.startswith("process group:")]
    log(f"multihost: scripts/torch_train.py --multihost as a subprocess: exit {proc.returncode} in "
        f"{time.perf_counter() - start:.1f} s (host clock); {group}")
    sub_files = {p.name for p in (root / "ckpt_sub").iterdir()} if (root / "ckpt_sub").exists() else set()
    if proc.returncode:
        return [f"scripts/torch_train.py --multihost exited {proc.returncode}: {proc.stderr[-3000:]}"]
    if group != ["process group: rank 0 of 1, backend nccl"]:
        failed.append(f"--multihost did not join an NCCL group of one: {group}")
    if not ({"best.model.ckpt", "latest.model.ckpt"} <= sub_files and list((root / "trace_sub").glob("*.json"))):
        failed.append(f"the --multihost subprocess left {sorted(sub_files)} and no trace")
    else:
        got = torch.load(root / "ckpt_sub" / "latest.model.ckpt", weights_only=True)
        want = torch.load(root / "ckpt" / "latest.model.ckpt", weights_only=True)
        differ = sorted(k for k in want if k not in got or not torch.equal(got[k], want[k]))
        log(f"multihost: {len(want) - len(differ)} of {len(want)} parameters of --multihost at iteration "
            f"{ENTRY_STEPS} bit for bit those of the run without a group")
        if differ or set(got) != set(want):
            failed.append(f"--multihost parameters differ from the run without a group: {differ[:5]}")

    model = SwinIR.build(**MAIN, seed=SEED, device=dev).half().enable_fused(True)
    mesh = get_mesh([dev])
    rng = np.random.default_rng(SEED + 17)
    lqs = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    gts = rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    plain = model.evaluate_uint8_batch(lqs, gts, crop_border=4)
    meshed = model.evaluate_uint8_batch(lqs, gts, crop_border=4, mesh=mesh)
    image = rng.integers(0, 256, (100, 120, 3), dtype=np.uint8)
    tiles = tiled_inference(model, image, tile=64, tile_overlap=8, tile_batch=4)
    tiles_mesh = tiled_inference(model, image, tile=64, tile_overlap=8, tile_batch=4, mesh=mesh)
    same = (all(np.array_equal(a, b) for a, b in zip(plain, meshed)), np.array_equal(tiles, tiles_mesh))
    log(f"multihost: mesh {mesh}: evaluate_uint8_batch PSNR {plain[0].tolist()} / {meshed[0].tolist()}, the same "
        f"numbers {same[0]}; tiled_inference {tiles.shape} the same pixels {same[1]}")
    if not all(same):
        failed.append(f"the mesh= routes differ from the mesh-less ones: {same}")
    return failed


def phase_train_entry(dev: torch.device) -> None:
    """``scripts/torch_train.py --model swinir --scale 4 --dataset DIV2K``
    on a DIV2K-layout corpus, in process (``main(argv)``) and as a
    subprocess, then resumed to iteration 9; the prepared packs, the host
    routes, B5-B8's launches, the losses, the checkpoints and the trace
    checked; step, loader and decode times printed."""
    spec = importlib.util.spec_from_file_location("torch_train", ROOT / "scripts" / "torch_train.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    import studiosr_tpu_torch.engine.trainer as trainer_module

    failed, losses = [], []
    get_loss_fn = trainer_module.get_loss

    def recording_loss(name):
        fn = get_loss_fn(name)

        def criterion(pred, target):
            loss = fn(pred, target)
            losses.append(loss.detach())
            return loss

        return criterion

    with tempfile.TemporaryDirectory(prefix="chip_smoke_entry_") as tmp:
        root = Path(tmp)
        data = root / "data"
        start = time.perf_counter()
        entry_corpus(data, dev)
        log(f"\ntrain entry: corpus of {len(ENTRY_SIDES)} HR images written in {time.perf_counter() - start:.1f} s")
        common = ["--model", "swinir", "--scale", "4", "--dataset", "DIV2K", "--data-dir", str(data), "--size", "64",
                  "--eval-interval", "3", "--ckpt", str(root / "ckpt")]
        engagement.reset()
        native.reset_counters()
        trainer_module.get_loss = recording_loss
        try:
            start = time.perf_counter()
            trainer = script.main(common + ["--max-iters", str(ENTRY_STEPS), "--profile-dir", str(root / "trace")])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
        finally:
            trainer_module.get_loss = get_loss_fn
        launches, entries, routes = engagement.counters(), engagement.entries(), native.counters()
        values = [float(v) for v in losses]
        sub = data / "DIV2K" / "sub"
        packs = {p: len(list((sub / p).glob("*.png"))) for p in
                 ("DIV2K_train_HR", *(f"DIV2K_train_LR_bicubic/X{s}" for s in (2, 3, 4)))}
        log(f"train entry in process: {ENTRY_STEPS} iterations in {seconds:.1f} s (host clock: prepare, build, "
            f"steps, 2 evaluations, checkpoints, trace); batch {trainer.batch_size}, bf16 {trainer.bfloat16}, "
            f"fused_train {trainer.fused_train}; packs {packs}; launches {launches}; host routes {routes}; "
            f"best PSNR {trainer.best_psnr:.4f} dB")
        log(f"train entry losses {[round(v, 6) for v in values]}")
        if packs != {p: ENTRY_PACK for p in packs}:
            failed.append(f"prepare built {packs}, expected {ENTRY_PACK} sub-images a pack")
        if trainer.batch_size != TRAIN_BATCH or not (trainer.bfloat16 and trainer.fused_train):
            failed.append("the entry point did not train at the recipe's batch 32, bf16, fused_train")
        for name in PER_STEP:
            if launches.get(name, 0) != PER_STEP[name] * ENTRY_STEPS:
                failed.append(f"train entry {name}: {launches.get(name, 0)} launches in {ENTRY_STEPS} steps, "
                              f"expected {PER_STEP[name]} a step")
        if set(launches) - set(PER_STEP):
            failed.append(f"train entry launched {sorted(set(launches) - set(PER_STEP))} besides B5-B8")
        failed += train_entry_failures("train entry", launches, torch.bfloat16, entries)
        if len(values) != ENTRY_STEPS or not all(np.isfinite(values)):
            failed.append(f"train entry losses {values}")
        crop, unfilter = routes.get("crop_augment", {}), routes.get("unfilter", {})
        originals = len(ENTRY_SIDES) * 4
        if crop.get("native", 0) < TRAIN_BATCH * ENTRY_STEPS or crop.get("numpy", 0):
            failed.append(f"the loader's crop-augment routes {crop}: every sample must take the native one")
        if unfilter.get("native", 0) < originals or unfilter.get("python", 0):
            failed.append(f"PNG unfilter routes {unfilter}: every decode (the {originals} originals first) must "
                          "take the native one")
        files = sorted(p.name for p in (root / "ckpt").iterdir())
        if not {"best.model.ckpt", "best.train.ckpt", "latest.model.ckpt", "latest.train.ckpt"} <= set(files):
            failed.append(f"checkpoints {files}: latest and best expected")
        traces = sorted((root / "trace").glob("*.json"))
        if len(traces) != 1:
            failed.append(f"profile_dir holds {traces}, expected one Chrome trace")
        else:
            start = time.perf_counter()
            events = json.loads(traces[0].read_text())["traceEvents"]
            kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
            named = {name: sum(k in e for e in kernels) for name, k in ENTRY_TRACE_KERNELS.items()}
            log(f"train entry trace {traces[0].name}: {traces[0].stat().st_size / 1e6:.1f} MB, {len(events)} events, "
                f"{len(kernels)} kernels; B5-B8's kernels named {named} times "
                f"({time.perf_counter() - start:.1f} s to read)")
            for name, count in named.items():
                if count < ENTRY_STEPS:
                    failed.append(f"the trace names {ENTRY_TRACE_KERNELS[name]} ({name}) {count} times")
            del events, kernels
        step_ms = [1e3 * t for t in trainer.timings["step"]]
        wait_ms = [1e3 * t for t in trainer.timings["get_batch"]]
        del trainer

        failed += phase_multihost(dev, root, common)

        engagement.reset()
        native.reset_counters()
        resumed = script.main(common + ["--max-iters", str(ENTRY_RESUMED)])
        torch.cuda.synchronize()
        resumed_launches = engagement.counters()
        resumed_steps = len(resumed.timings["step"])
        log(f"train entry resumed: {resumed_steps} iterations to {resumed.data_handler.iterations}; launches "
            f"{resumed_launches}")
        if resumed_steps != ENTRY_RESUMED - ENTRY_STEPS or resumed.data_handler.iterations != ENTRY_RESUMED:
            failed.append(f"the run with --max-iters {ENTRY_RESUMED} took {resumed_steps} steps, expected a resume "
                          f"at iteration {ENTRY_STEPS}")
        for name in PER_STEP:
            if resumed_launches.get(name, 0) != PER_STEP[name] * (ENTRY_RESUMED - ENTRY_STEPS):
                failed.append(f"resumed {name}: {resumed_launches.get(name, 0)} launches")
        if native.counters().get("unfilter", {}).get("python", 0) or native.counters().get("crop_augment", {}).get(
                "numpy", 0):
            failed.append(f"the resumed run took a plain host route: {native.counters()}")
        resumed_ms = [1e3 * t for t in resumed.timings["step"]]
        resumed_wait = [1e3 * t for t in resumed.timings["get_batch"]]
        del resumed
        if failed:
            raise AssertionError("; ".join(failed))

        # The host routes' times (after the checks: the plain ones are taken here on purpose).
        dataset = DIV2K(str(data), size=64, scale=4, transform=True, to_tensor=True)
        loader = PrefetchLoader(dataset, TRAIN_BATCH, num_workers=1, seed=SEED, normalize=False)
        indices = np.arange(TRAIN_BATCH) % len(dataset)
        batch_native = host_ms(lambda: loader._make_batch(0, 0, indices), reps=5)
        batch_plain = plain_host_routes(lambda: host_ms(lambda: loader._make_batch(0, 0, indices), reps=2))
        pairs = [dataset.get_image_pair(int(i)) for i in indices]
        rng = np.random.default_rng(SEED)
        augment_native = host_ms(lambda: [native.paired_crop_augment(lq, gt, 64, 4, 3, 5, True, False, True)
                                          for lq, gt in pairs], reps=5)
        augment_numpy = host_ms(lambda: [dataset.to_tensor(*dataset.transform(lq, gt)) for lq, gt in pairs], reps=5)
        image = np.clip(128 + rng.normal(0, 30, (480, 480, 3)), 0, 255).astype(np.uint8)
        data_paeth = encode_png(image, 4)
        decode_native = host_ms(lambda: decode_png(data_paeth), reps=5)
        decode_python = plain_host_routes(lambda: host_ms(lambda: decode_png(data_paeth), reps=2))
        if not np.array_equal(decode_png(data_paeth), image):
            raise AssertionError("the 480² Paeth PNG does not decode to its pixels")
    log(f"train entry step (host clock, the step call; {TRAIN_BATCH} x 64² bf16 fused): profiled run "
        f"{[round(t, 1) for t in step_ms]} ms, median of iterations 2-{ENTRY_STEPS} "
        f"{float(np.median(step_ms[1:])):.1f} ms; resumed run without the profiler {[round(t, 1) for t in resumed_ms]} ms")
    log(f"train entry get_batch wait per step (host clock): profiled run mean {float(np.mean(wait_ms)):.2f} ms "
        f"(first {wait_ms[0]:.1f}, max of the rest {max(wait_ms[1:]):.2f}); resumed run "
        f"{[round(t, 2) for t in resumed_wait]} ms")
    log(f"loader, one batch of {TRAIN_BATCH} on one thread (decode two sub-image PNGs, crop 64² / 256², augment, "
        f"stack; host clock): native routes {batch_native:.1f} ms, plain routes (Python unfilter, numpy "
        f"crop-augment) {batch_plain:.1f} ms; the crop-augment of {TRAIN_BATCH} decoded pairs alone: native "
        f"{augment_native:.2f} ms, numpy {augment_numpy:.2f} ms")
    log(f"decode of a 480² RGB PNG, Paeth on every row (host clock): native unfilter {decode_native:.2f} ms, "
        f"Python unfilter {decode_python:.1f} ms")


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
    rows += phase_hat_train_f32(dev)
    torch.cuda.empty_cache()
    phase_ws16_f32_first_design(dev)
    b4_errors = phase_b4_kernels(dev)
    rows += phase_x2_x3(dev, b4_errors)
    resblock_errors = phase_resblock_kernels(dev)
    rows += phase_swinfir_serving(dev, resblock_errors)
    rows += phase_windows_serving(dev)
    phase_swinfir_grads(dev)
    rows += phase_swinfir_train(dev)
    rows += phase_maxsr(dev)
    models = maxsr_models(dev)
    maxsr_errors = phase_train_kernels(models, dev, maxsr_train_kernel_cases)
    phase_train_grads(dev, "maxsr")
    maxsr_trained, maxsr_launches, maxsr_steps = phase_maxsr_train(dev)
    rows += phase_maxsr_train_timing(maxsr_trained, models, dev, maxsr_errors, maxsr_launches, maxsr_steps)
    del maxsr_trained, models
    torch.cuda.empty_cache()
    phase_conv_serving(dev)
    phase_conv_train(dev)
    phase_trained(dev)
    phase_evaluator(dev)
    phase_cli(dev)
    phase_zoo(dev)
    rows += phase_maxsr_windows(dev)
    torch.cuda.empty_cache()
    rows += phase_large_windows(dev)
    torch.cuda.empty_cache()
    rows += phase_hat_windows(dev)
    torch.cuda.empty_cache()
    phase_mesh_serving(dev)
    phase_maxsr_decline(dev)
    phase_train_entry(dev)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
