#!/usr/bin/env python3
"""Time the port's attention kernels on one NVIDIA GPU.

    python3 scripts/torch_time_attn_kernels.py [--checkout DIR] [--large | --f32] [--bits FILE]

Times, in bf16 with seeded operands, by CUDA events over 20 launches after 3
warm-up launches:

* B15 (``window_attention``) at MaxSR x4's two serving shapes (adaptive: 256
  windows of 256 tokens, no bias; static: 1024 windows of 64 tokens, a (4,
  64, 64) bias; 4 heads of 32, q, k, v the slices of one projection) with
  ``F.scaled_dot_product_attention`` on the same operands as the library
  yardstick (the bias as its mask);
* the attention backward at the training shapes, batch 32 of 64 x 64 maps,
  180 channels, 6 heads, drop-path scales (0, 1/0.9, ...): B8
  (``attention_bwd`` at window 8, shift 4, SwinIR) and B9 (window 16, shift
  8, HAT), each beside its yardstick: the same half, y = x + d proj(WA(LN
  x)) and its backward, as a sequence of bf16 PyTorch calls (cuBLAS
  products, ``F.scaled_dot_product_attention`` with the rel-pos bias and the
  shift mask as a mask that takes a gradient, LayerNorm), timed forward and
  backward together as the kernels recompute the forward;
* B7 (``mlp_bwd``, hidden 360) at the same rows, beside its yardstick:
  ``torch.autograd.grad`` through LayerNorm, two linears and the exact GELU
  in bf16, forward and backward together as the kernel recomputes the
  forward;
* B5 (``fused_window_attention_block``) at the same shapes, window 8 shift 4
  (SwinIR's step) and window 16 shift 8 (HAT's step), and at HAT x4
  serving's (1 x 256 x 256, window 16, shift 8, no drop-path; the weights
  packed once as serving packs them, where the package has
  ``pack_window_attention``), each beside its yardstick: the same half as
  a sequence of bf16 PyTorch calls (LayerNorm, cuBLAS, SDPA with the bias
  and shift mask as its mask, the projection and the add);
* above window 16 (B5's and B9's large families, ``_large``): B5 and its
  backward at MaxSR x4's adaptive step on a 289 x 289 crop (window 17, C
  128, 4 heads, batch 1, no shift, drop-path scale 1) and at HAT x4's
  window-24 step (batch 32 of 72 x 72 maps, C 180, 6 heads, shift 12,
  drop-path scales, the bias in bf16), and B5 at SwinIR x4 serving at
  window 24 (one 264 x 264 map, C 180, shift 12, the weights packed once),
  each beside its yardstick; a checkout from before the family raises
  there, and its times are NaN;
* B5 and B6 at SwinFIR / SwinIR x4 serving at window 12 (one 264 x 264
  map, shift 6, no drop-path, the weights packed once as serving packs
  them), each beside the same yardstick;
* B6 (``fused_mlp_block``, hidden 360, drop-path scales (0, 1/0.9, ...))
  at the same rows, and B6 with HAT's CAB join (``extra`` / ``extra_scale``)
  at HAT x4 serving's 65,536 rows, the weights packed once as serving packs
  them where the package has ``pack_mlp_block``; each beside its yardstick:
  the same function as a sequence of bf16 PyTorch calls (``F.layer_norm``,
  ``F.linear``, the exact ``F.gelu``, ``F.linear``, the drop-path scale and
  the add; for ``extra`` the join first);
* B13 (``oca_core_bwd`` on 512 windows, 6 heads, 256 queries, 576 keys, d
  30, the OCAB's transposed views: HAT's training step) beside two
  yardsticks: ``F.scaled_dot_product_attention``'s backward with the bias
  as a mask that takes a gradient, as (forward + backward) - forward, and
  the explicit formulas of the backward as a sequence of bf16 PyTorch calls
  (cuBLAS products, the softmax and its backward in f32);
* B12 (``oca_core_fwd`` at B13's shapes) with the bias in f32 and in bf16
  (as HAT's bf16 step gathers it from its bf16 table), beside
  ``F.scaled_dot_product_attention`` with the bias as its mask;
* B10 (``fused_ocab_block`` at HAT x4 serving's 256 x 256 map, window 16,
  overlap 0.5: 24 x 24 key windows; the weights packed once and the bias
  in bf16, as serving prepares them, where the package has
  ``pack_ocab_block``), beside its yardstick: the same block as a sequence
  of bf16 PyTorch calls (``F.layer_norm``, ``F.linear``, the unfold of the
  zero-padded k | v map, SDPA with the bias as its mask, the projection and
  the residual, then the MLP half);
* HAT at other windows: B10 on a 264 x 264 map at windows 24 (36 x 36
  key windows) and 12 (144 queries in three 64-row tiles), on the blob
  where the checkout's H100 kernel takes the window and on dense weights
  through the older kernel where not (``nan`` where the checkout raises),
  beside its yardstick; B12 and B13 in their large family at HAT's
  window-24 step (288 windows, 6 heads, 576 | 1296, d 30, the bias in
  bf16; B12 also with it in f32), and B13 there again with the same bias values in bf16 and in f32,
  timed bf16, f32, f32, bf16 (each row the mean of its two runs, and its
  ``spread`` their difference);
* as controls: B5, B7, B8, B9 (above).

The kernels are built first, one ``nvcc`` a source, all started together.
The per-pass split of B5, B6, B7, B8, B9, B10, B12 and B13: ``torch.profiler`` over 10 calls
gives the device time of every kernel a call enqueues, by name in launch
order. ``--large`` times only what is above window 16 (the item before
last, and B10, B12, B13 at HAT's windows 24 and 12). Prints one
JSON line: {"package": path, "card": nvidia-smi's name and power limit,
"ms": {kernel: ms}, "passes": {kernel: [[kernel name, launches, ms], ...]},
"entries": {kernel: {C entry: launches}}}. The package is whichever
``studiosr_tpu_torch`` is first on the path. With ``--checkout DIR`` the
script instead runs itself four times, with ``PYTHONPATH`` set to DIR, this
checkout, this checkout and DIR (A, B, B, A on one card), prints each line
and then a table of the four.

``--f32`` times only B5, B6, B7 and B8 in f32 at SwinFIR's training step
(batch 32 of 64 x 64 maps, C 180, 6 heads, window 8 shift 4, hidden 360,
drop-path scales), and B5 and B6 at MaxSR's f32 geometry (C 128, 4 heads
of 32, hidden 512, unshifted, no drop-path; rows ending " maxsr"), each
with its per-pass split, its plain version's time,
its bounds ("bounds": GFLOP and MB of a launch, ms at 3xTF32 (164.9
TFLOP/s), on the FMA pipes (66.9) and at 3.35 TB/s) and its library
yardstick: the same function as a sequence of f32 PyTorch calls, TF32 off.

``--bits FILE`` times nothing: it writes to FILE (``torch.save``) every
output of the bf16 B6, B7 and B10 at the widths SwinIR's and HAT's paths
run them (C 180, hidden 360), seeded: B6 on 131,072 rows with drop-path
scales (the training step's) and with HAT's CAB join (``extra``) on 65,536
rows on weights packed as HAT serving packs them; B7 on 131,072 rows with
drop-path scales, dx and every f32 gradient; B10 at HAT x4 serving's 256 x
256 map, window 16, overlap 0.5, packed weights and a bf16 bias, and at
window 8 (a 64 x 96 map, 12 x 12 key windows); B12 (with the bias in f32
and in bf16) and B13 at the OCA geometries of windows 8 and 16 (64 windows
of 6 heads, 64 | 144 and 256 | 576 queries | keys, the OCAB's views). Then B5
and its backward (B8 at window 8, B9 at window 16) at both windows with the
shift and drop-path scales: in bf16 at C 180 (the kernels written for the
H100, batch 8 of 64 x 64 maps; MaxSR's C 128 with a bf16 bias too), at
head dim 48 (the older bf16 kernels) and in f32 (batch 2, C 64 and 180). Then the forward
above window 16 ("large forward ..."): B5 at window 24 (shift 12, drop-path,
a bf16 bias; and on the serving blob) and 17 (C 128, 4 heads), B12's large
entry at 576 | 1296 and 100 | 700 (d 12) with either bias, B10 at window 24. With
``--checkout DIR`` as well, it writes FILE.parent from DIR's package and
FILE.change from this checkout's on one card, names every output as the
same bits or not, and exits 1 if any bf16 output differs. The f32 outputs
("(f32)" in their names: B5-B8 at C 64 and at SwinFIR's C 180 (window 8
and 16, batch 2), B6 (with drop-path and with HAT's CAB join) and B7 on
two samples' rows at C 180) are listed as the same bits or with their
largest difference relative to their largest value: an f32 kernel's
outputs change with it (B5 and B6 at windows 2 to 8 since their f32
kernels written for the H100; B7 and B8 before), and no other's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS = 10
BATCH, CROP, C, HEADS = 32, 64, 180, 6


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

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


def pass_split(fn, calls: int = CALLS) -> list:
    """[[kernel name, launches a call, device ms a call], ...] of the
    kernels ``fn`` enqueues, by name in order of first launch, summed over
    ``calls`` profiled calls and divided by ``calls``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and not e.name.startswith(("Memcpy", "Memset"))), key=lambda e: e.time_range.start)
    split: dict = {}
    for k in kernels:
        n, us = split.get(k.name[:80], (0, 0.0))
        split[k.name[:80]] = (n + 1, us + k.time_range.elapsed_us())
    return [[name, n / calls, us / calls / 1e3] for name, (n, us) in split.items()]


def attention_half_sequence(x, g, ops, heads: int, ws: int, shift: int, dp, dtype=None):
    """The attention half and its backward as a sequence of bf16 (or
    ``dtype``) PyTorch calls: roll and partition, ``F.layer_norm``,
    ``F.linear`` (cuBLAS), SDPA with the rel-pos bias plus the shift mask as
    its mask (a leaf that takes the gradient), ``F.linear``, the drop-path
    scale and the residual; then ``torch.autograd.grad`` of every operand
    against ``g``. Returns a function of no arguments that runs both."""
    import torch
    import torch.nn.functional as F

    from studiosr_tpu_torch.ops.windows import calculate_mask, window_partition, window_reverse

    bsz, h, w, c = x.shape
    n, d = ws * ws, c // heads
    bf = dtype or torch.bfloat16
    region = torch.from_numpy(calculate_mask((h, w), ws, shift)).to(x.device, bf) if shift else None
    ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias = ops
    leaves = [t.detach().to(bf).requires_grad_() for t in (x, ln_w, ln_b, wqkv.t(), bqkv, wproj.t(), bproj, bias)]
    scale = dp.to(bf).reshape(-1, 1, 1, 1)

    def both():
        xx, lw, lb, wq, bq, wp, bp, bb = leaves
        xr = torch.roll(xx, (-shift, -shift), (1, 2)) if shift else xx
        xw = window_partition(xr, ws).reshape(-1, n, c)
        ln = F.layer_norm(xw, (c,), lw, lb, 1e-5)
        qkv = F.linear(ln, wq, bq).reshape(-1, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        if region is None:
            mask = bb[None].expand(xw.shape[0], -1, -1, -1)
        else:  # (1, nW, heads, N, N) over the images of the batch
            mask = (bb.reshape(1, 1, heads, n, n) + region[None, :, None]).expand(bsz, -1, -1, -1, -1)
            mask = mask.reshape(-1, heads, n, n)
        o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], attn_mask=mask)
        y = F.linear(o.transpose(1, 2).reshape(-1, n, c), wp, bp)
        y = window_reverse(y.reshape(-1, ws, ws, c), ws, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), (1, 2))
        torch.autograd.grad(xx + scale * y, leaves, g)

    return both


def attention_half_forward_sequence(x, ops, heads: int, ws: int, shift: int, dp, dtype=None):
    """B5's function as a sequence of bf16 (or ``dtype``) PyTorch calls: roll
    and partition, ``F.layer_norm``, ``F.linear`` (cuBLAS), SDPA with the
    rel-pos bias plus the shift mask as its mask, ``F.linear``, the drop-path
    scale and the residual, rolled back. Returns a function of no arguments."""
    import torch
    import torch.nn.functional as F

    from studiosr_tpu_torch.ops.windows import calculate_mask, window_partition, window_reverse

    bsz, h, w, c = x.shape
    n, d = ws * ws, c // heads
    bf = dtype or torch.bfloat16
    ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias = [t.detach().to(bf) for t in ops]
    wq, wp = wqkv.t().contiguous(), wproj.t().contiguous()
    if shift:  # (B nW, heads, N, N): the bias plus the region mask of each window
        region = torch.from_numpy(calculate_mask((h, w), ws, shift)).to(x.device, bf)
        mask = (bias.reshape(1, 1, heads, n, n) + region[None, :, None]).expand(bsz, -1, -1, -1, -1)
        mask = mask.reshape(-1, heads, n, n).contiguous()
    else:
        mask = bias[None]
    scale = None if dp is None else dp.to(bf).reshape(-1, 1, 1, 1)
    xx = x.to(bf)

    def forward():
        xr = torch.roll(xx, (-shift, -shift), (1, 2)) if shift else xx
        xw = window_partition(xr, ws).reshape(-1, n, c)
        qkv = F.linear(F.layer_norm(xw, (c,), ln_w, ln_b, 1e-5), wq, bqkv).reshape(-1, n, 3, heads, d)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], attn_mask=mask)
        y = window_reverse(F.linear(o.transpose(1, 2).reshape(-1, n, c), wp, bproj).reshape(-1, ws, ws, c), ws, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), (1, 2))
        return xx + (y if scale is None else scale * y)

    return forward


def mlp_half_backward_sequence(x, g, ops, dp, rows_per_sample: int, dtype=None):
    """B7's function as bf16 (or ``dtype``) PyTorch calls:
    ``torch.autograd.grad`` of x + d fc2(gelu(fc1(LN x))) (``F.layer_norm``,
    ``F.linear`` on cuBLAS, the exact ``F.gelu``) against ``g``, the forward
    run with it as the kernel recomputes it. Returns a function of no
    arguments."""
    import torch
    import torch.nn.functional as F

    bf = dtype or torch.bfloat16
    ln_w, ln_b, w1, b1, w2 = ops[:5]
    b2 = torch.zeros(w2.shape[-1], device=x.device)
    leaves = [t.detach().to(bf).requires_grad_() for t in (x, ln_w, ln_b, w1.t(), b1, w2.t(), b2)]
    d = None if dp is None else dp.to(bf).repeat_interleave(rows_per_sample)[:, None]
    gg = g.to(bf)

    def both():
        xx, lw, lb, wa, ba, wb, bb = leaves
        y = F.linear(F.gelu(F.linear(F.layer_norm(xx, (xx.shape[-1],), lw, lb, 1e-5), wa, ba)), wb, bb)
        torch.autograd.grad(xx + (y if d is None else d * y), leaves, gg)

    return both


def mlp_half_forward_sequence(x, ops, dp=None, rows_per_sample: int = 0, extra=None, extra_scale=None, dtype=None):
    """B6's function as bf16 (or ``dtype``) PyTorch calls: (for ``extra``)
    the join x' = x + extra * extra_scale, then x' + d fc2(gelu(fc1(LN x')))
    with ``F.layer_norm``, ``F.linear`` on cuBLAS and the exact ``F.gelu``.
    Returns a function of no arguments."""
    import torch
    import torch.nn.functional as F

    bf = dtype or torch.bfloat16
    ln_w, ln_b, w1, b1, w2, b2 = [t.detach().to(bf) for t in ops]
    wa, wb = w1.t().contiguous(), w2.t().contiguous()
    d = None if dp is None else dp.to(bf).repeat_interleave(rows_per_sample)[:, None]
    es = None if extra_scale is None else extra_scale.to(bf)
    xx = x.to(bf)

    def forward():
        xj = xx if extra is None else xx + extra * es
        y = F.linear(F.gelu(F.linear(F.layer_norm(xj, (xj.shape[-1],), ln_w, ln_b, 1e-5), wa, b1)), wb, b2)
        return xj + (y if d is None else d * y)

    return forward


def oca_backward_sequence(q, k, v, bias, g):
    """B13's function as bf16 PyTorch calls, the explicit formulas of the
    backward: s = q k^T (cuBLAS) + bias, p = softmax(s) in f32, dv = p^T g,
    dp = g v^T, ds = p (dp - sum(p dp)) in f32, dq = ds k, dk = ds^T q (the
    products on bf16 p and ds), d bias = sum of ds over the windows. Returns
    a function of no arguments."""
    import torch

    bf = torch.bfloat16
    qq, kk, vv, gg = (t.to(bf) for t in (q, k, v, g))
    b32 = bias.float()

    def backward():
        p = torch.softmax((qq @ kk.transpose(-1, -2)).float() + b32, dim=-1)
        pb = p.to(bf)
        dv = pb.transpose(-1, -2) @ gg
        dp = (gg @ vv.transpose(-1, -2)).float()
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dsb = ds.to(bf)
        return dsb @ kk, dsb.transpose(-1, -2) @ qq, dv, ds.sum(0)

    return backward


def ocab_forward_sequence(x, ops, heads: int, ws: int, overlap_ratio: float, dtype=None):
    """B10's function as bf16 (or ``dtype``) PyTorch calls: ``F.layer_norm``, ``F.linear``
    (cuBLAS) to q | k | v once a pixel, q's windows, the zero-padded k | v
    map unfolded into the owin x owin windows around them, SDPA with the
    rel-pos bias as its mask (zero keys outside the image keep their
    logits, as in the block), the projection and the residual, then
    y + fc2(gelu(fc1(LN2 y))). Returns a function of no arguments."""
    import torch
    import torch.nn.functional as F

    from studiosr_tpu_torch.ops.windows import window_partition, window_reverse

    bsz, h, w, c = x.shape
    owin = int(ws * overlap_ratio) + ws
    pad, nq, nk, d = (owin - ws) // 2, ws * ws, owin * owin, c // heads
    bf = dtype or torch.bfloat16
    ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2 = [t.detach().to(bf) for t in ops]
    wq, wp, wa, wb = (t.t().contiguous() for t in (wqkv, wproj, w1, w2))
    xx = x.to(bf)

    def forward():
        qkv = F.linear(F.layer_norm(xx, (c,), ln1_w, ln1_b, 1e-5), wq, bqkv)
        q = window_partition(qkv[..., :c], ws).reshape(-1, nq, heads, d).transpose(1, 2)
        kv = F.pad(qkv[..., c:], (0, 0, pad, pad, pad, pad)).unfold(1, owin, ws).unfold(2, owin, ws)
        kv = kv.permute(0, 1, 2, 4, 5, 3).reshape(-1, nk, 2, heads, d)
        o = F.scaled_dot_product_attention(q, kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2),
                                           attn_mask=bias)
        o = F.linear(o.transpose(1, 2).reshape(-1, nq, c), wp, bproj).reshape(-1, ws, ws, c)
        y = xx + window_reverse(o, ws, h, w)
        return y + F.linear(F.gelu(F.linear(F.layer_norm(y, (c,), ln2_w, ln2_b, 1e-5), wa, b1)), wb, b2)

    return forward


def measure(large_only: bool = False) -> dict:
    import torch
    import torch.nn.functional as F

    if "PYTHONPATH" not in os.environ:
        sys.path.insert(0, str(ROOT))
    import studiosr_tpu_torch
    from studiosr_tpu_torch import resolve_device
    from studiosr_tpu_torch.ops.cuda import _build, engagement
    from studiosr_tpu_torch.ops.cuda.attn_bwd import attention_bwd
    from studiosr_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
    from studiosr_tpu_torch.ops.cuda.mlp_bwd import mlp_bwd
    from studiosr_tpu_torch.ops.cuda.oca_core import oca_core_bwd, oca_core_fwd
    from studiosr_tpu_torch.ops.cuda.ocab import fused_ocab_block
    from studiosr_tpu_torch.ops.cuda.window_attention import fused_window_attention_block
    from studiosr_tpu_torch.ops.cuda.window_attn import window_attention

    dev = resolve_device("cuda")
    _build.build()
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    ms, passes, entries = {}, {}, {}
    if large_only:
        measure_large(dev, randn, ms, passes, entries)
        return {"package": studiosr_tpu_torch.__file__, "card": card_line(), "ms": ms, "passes": passes,
                "entries": entries}
    for mode, windows, n, with_bias in (("adaptive", 256, 256, False), ("static", 1024, 64, True)):
        qkv = randn(windows, n, 3, 4, 32).to(bf).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * 32**-0.5, qkv[1], qkv[2]
        bias = randn(4, n, n) if with_bias else None
        mask = None if bias is None else bias.to(bf)
        ms[f"window_attention {mode}"] = time_ms(lambda: window_attention(q, k, v, bias=bias))
        ms[f"window_attention {mode} library (SDPA)"] = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0))

    x, g = randn(BATCH, CROP, CROP, C).to(bf), randn(BATCH, CROP, CROP, C, scale=1e-3).to(bf)
    dp = torch.full((BATCH,), 1 / 0.9, device=dev)
    dp[0] = 0.0
    for name, ws, shift in (("attention_bwd", 8, 4), ("attention_bwd_ws16", 16, 8)):
        attn_ops = (1 + randn(C, scale=0.1), randn(C, scale=0.1), randn(C, 3 * C, scale=C**-0.5).to(bf),
                    randn(3 * C, scale=0.1), randn(C, C, scale=C**-0.5).to(bf), randn(C, scale=0.1),
                    randn(HEADS, ws * ws, ws * ws, scale=0.5).to(bf))  # the bf16 step's gathered bias
        kw = dict(heads=HEADS, window_size=ws, shift=shift, drop_path=dp)
        fwd = f"fused_window_attention_block{'_ws16' if ws == 16 else ''}"
        engagement.reset()
        ms[fwd] = time_ms(lambda: fused_window_attention_block(x, *attn_ops, **kw))
        entries[fwd] = engagement.entries().get(fwd)
        passes[fwd] = pass_split(lambda: fused_window_attention_block(x, *attn_ops, **kw))
        ms[f"{fwd} yardstick (bf16 PyTorch sequence)"] = time_ms(
            attention_half_forward_sequence(x, attn_ops, HEADS, ws, shift, dp), iters=10)
        engagement.reset()
        ms[name] = time_ms(lambda: attention_bwd(x, g, *attn_ops, **kw))
        entries[name] = engagement.entries().get(name)
        passes[name] = pass_split(lambda: attention_bwd(x, g, *attn_ops, **kw))
        sequence = attention_half_sequence(x, g, attn_ops, HEADS, ws, shift, dp)
        ms[f"{name} yardstick (bf16 PyTorch sequence)"] = time_ms(sequence, iters=5, warmup=2)
        del sequence
        torch.cuda.empty_cache()

    rows, rps = BATCH * CROP * CROP, CROP * CROP
    xr, gr = x.reshape(rows, C), g.reshape(rows, C)
    mlp_ops = (1 + randn(C, scale=0.1), randn(C, scale=0.1), randn(C, 2 * C, scale=C**-0.5).to(bf),
               randn(2 * C, scale=0.1), randn(2 * C, C, scale=(2 * C)**-0.5).to(bf))
    b2 = randn(C, scale=0.1)
    fwd_kw = dict(drop_path=dp, rows_per_sample=rps)
    engagement.reset()
    ms["fused_mlp_block"] = time_ms(lambda: fused_mlp_block(xr, *mlp_ops, b2, **fwd_kw))
    entries["fused_mlp_block"] = engagement.entries().get("fused_mlp_block")
    passes["fused_mlp_block"] = pass_split(lambda: fused_mlp_block(xr, *mlp_ops, b2, **fwd_kw))
    ms["fused_mlp_block yardstick (bf16 PyTorch sequence)"] = time_ms(
        mlp_half_forward_sequence(xr, (*mlp_ops, b2), dp, rps), iters=10)
    engagement.reset()
    ms["mlp_bwd"] = time_ms(lambda: mlp_bwd(xr, gr, *mlp_ops, drop_path=dp, rows_per_sample=rps))
    entries["mlp_bwd"] = engagement.entries().get("mlp_bwd")
    passes["mlp_bwd"] = pass_split(lambda: mlp_bwd(xr, gr, *mlp_ops, drop_path=dp, rows_per_sample=rps))
    ms["mlp_bwd yardstick (bf16 PyTorch sequence)"] = time_ms(
        mlp_half_backward_sequence(xr, gr, mlp_ops, dp, rps), iters=5, warmup=2)

    # B5 at HAT x4 serving's shapes: one 256 x 256 map, window 16, no drop-path
    name, ws = "fused_window_attention_block_ws16 serving", 16
    xs = randn(1, 256, 256, C).to(bf)
    dense = (1 + randn(C, scale=0.1), randn(C, scale=0.1), randn(C, 3 * C, scale=C**-0.5).to(bf),
             randn(3 * C, scale=0.1), randn(C, C, scale=C**-0.5).to(bf), randn(C, scale=0.1),
             randn(HEADS, ws * ws, ws * ws, scale=0.5))
    served = list(dense)
    try:  # serving packs the weights and the bias once, at load time
        from studiosr_tpu_torch.ops.cuda.window_attention import pack_window_attention

        served[2:7] = [pack_window_attention(dense[2], dense[4], dense[6], HEADS), dense[3], None, dense[5], None]
    except ImportError:
        pass
    kw = dict(heads=HEADS, window_size=ws, shift=8)
    ms[name] = time_ms(lambda: fused_window_attention_block(xs, *served, **kw))
    passes[name] = pass_split(lambda: fused_window_attention_block(xs, *served, **kw))
    ms[f"{name} yardstick (bf16 PyTorch sequence)"] = time_ms(
        attention_half_forward_sequence(xs, dense, HEADS, ws, 8, None), iters=10)

    # B5 and B6 at SwinFIR / SwinIR x4 serving at window 12: one 264 x 264 map (256 flip-padded to the
    # window's multiple), shift 6, the weights packed once as serving packs them
    ws, hp = 12, 264
    name = "fused_window_attention_block_ws16 serving ws12"
    x12 = randn(1, hp, hp, C).to(bf)
    dense = (1 + randn(C, scale=0.1), randn(C, scale=0.1), randn(C, 3 * C, scale=C**-0.5).to(bf),
             randn(3 * C, scale=0.1), randn(C, C, scale=C**-0.5).to(bf), randn(C, scale=0.1),
             randn(HEADS, ws * ws, ws * ws, scale=0.5))
    served = list(dense)
    try:
        from studiosr_tpu_torch.ops.cuda.window_attention import pack_window_attention

        served[2:7] = [pack_window_attention(dense[2], dense[4], dense[6], HEADS), dense[3], None, dense[5], None]
    except ImportError:
        pass
    kw = dict(heads=HEADS, window_size=ws, shift=ws // 2)
    ms[name] = time_ms(lambda: fused_window_attention_block(x12, *served, **kw))
    passes[name] = pass_split(lambda: fused_window_attention_block(x12, *served, **kw))
    ms[f"{name} yardstick (bf16 PyTorch sequence)"] = time_ms(
        attention_half_forward_sequence(x12, dense, HEADS, ws, ws // 2, None), iters=10)
    name = "fused_mlp_block serving ws12"
    r12 = x12.reshape(-1, C)
    dense = (*mlp_ops, b2)
    served = list(dense)
    try:
        from studiosr_tpu_torch.ops.cuda.mlp_block import pack_mlp_block

        served[2], served[4] = pack_mlp_block(dense[2], dense[4]), None
    except ImportError:
        pass
    engagement.reset()
    ms[name] = time_ms(lambda: fused_mlp_block(r12, *served))
    entries[name] = engagement.entries().get("fused_mlp_block")
    passes[name] = pass_split(lambda: fused_mlp_block(r12, *served))
    ms[f"{name} yardstick (bf16 PyTorch sequence)"] = time_ms(mlp_half_forward_sequence(r12, dense), iters=10)
    del x12, r12
    torch.cuda.empty_cache()

    # B10 at HAT x4 serving's shapes: 24 x 24 key windows around 16 x 16 queries, the MLP after
    ocab_ops = (1 + randn(C, scale=0.1), randn(C, scale=0.1), randn(C, 3 * C, scale=C**-0.5).to(bf),
                randn(3 * C, scale=0.1), randn(C, C, scale=C**-0.5).to(bf), randn(C, scale=0.1),
                randn(HEADS, 256, 576, scale=0.5), 1 + randn(C, scale=0.1), randn(C, scale=0.1),
                randn(C, 2 * C, scale=C**-0.5).to(bf), randn(2 * C, scale=0.1),
                randn(2 * C, C, scale=(2 * C)**-0.5).to(bf), randn(C, scale=0.1))
    name, kw = "fused_ocab_block serving", dict(heads=HEADS, window_size=16, overlap_ratio=0.5)
    served = list(ocab_ops)
    try:  # serving packs q|k|v, proj, fc1 and fc2 once, at load time, and hands the bias in bf16
        from studiosr_tpu_torch.ops.cuda.ocab import pack_ocab_block

        served[2] = pack_ocab_block(ocab_ops[2], ocab_ops[4], ocab_ops[9], ocab_ops[11], HEADS)
        served[4] = served[9] = served[11] = None
        served[6] = ocab_ops[6].to(bf)
    except ImportError:
        pass
    engagement.reset()
    ms[name] = time_ms(lambda: fused_ocab_block(xs, *served, **kw))
    entries[name] = engagement.entries().get("fused_ocab_block")
    passes[name] = pass_split(lambda: fused_ocab_block(xs, *served, **kw))
    ms[f"{name} yardstick (bf16 PyTorch sequence)"] = time_ms(
        ocab_forward_sequence(xs, ocab_ops, HEADS, 16, 0.5), iters=10)
    torch.cuda.empty_cache()

    # B6 with the CAB join at HAT x4 serving's shapes: 65,536 rows, the weights packed once
    name = "fused_mlp_block_extra serving"
    xe, extra = randn(256 * 256, C).to(bf), randn(256 * 256, C).to(bf)
    escale = randn(C, scale=0.01)
    dense = (*mlp_ops, b2)
    served = list(dense)
    try:  # serving packs fc1 and fc2 once, at load time
        from studiosr_tpu_torch.ops.cuda.mlp_block import pack_mlp_block

        served[2], served[4] = pack_mlp_block(dense[2], dense[4]), None
    except ImportError:
        pass
    engagement.reset()
    ms[name] = time_ms(lambda: fused_mlp_block(xe, *served, extra=extra, extra_scale=escale))
    entries[name] = engagement.entries().get("fused_mlp_block_extra")
    passes[name] = pass_split(lambda: fused_mlp_block(xe, *served, extra=extra, extra_scale=escale))
    ms[f"{name} yardstick (bf16 PyTorch sequence)"] = time_ms(
        mlp_half_forward_sequence(xe, dense, extra=extra, extra_scale=escale), iters=10)

    def view(n, scale):  # (512, 6, n, 30) over (512, n, 6, 30) storage, as the OCAB's views
        return randn(512, n, HEADS, 30, scale=scale).to(bf).transpose(1, 2)

    q, k, v, go = view(256, 2 * 30**-0.5), view(576, 1.0), view(576, 1.0), view(256, 1.0)
    bias = randn(HEADS, 256, 576, scale=2.0)
    bias16 = bias.to(bf)
    engagement.reset()
    ms["oca_core_fwd"] = time_ms(lambda: oca_core_fwd(q, k, v, bias))
    ms["oca_core_fwd bf16 bias"] = time_ms(lambda: oca_core_fwd(q, k, v, bias16))
    entries["oca_core_fwd"] = engagement.entries().get("oca_core_fwd")
    passes["oca_core_fwd"] = pass_split(lambda: oca_core_fwd(q, k, v, bias))
    passes["oca_core_fwd bf16 bias"] = pass_split(lambda: oca_core_fwd(q, k, v, bias16))
    engagement.reset()
    ms["oca_core_bwd"] = time_ms(lambda: oca_core_bwd(q, k, v, bias, go))
    entries["oca_core_bwd"] = engagement.entries().get("oca_core_bwd")
    passes["oca_core_bwd"] = pass_split(lambda: oca_core_bwd(q, k, v, bias, go))
    ms["oca_core_bwd yardstick (bf16 PyTorch sequence)"] = time_ms(oca_backward_sequence(q, k, v, bias, go), iters=5,
                                                                   warmup=2)
    torch.cuda.empty_cache()
    mask = bias.to(bf)
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0), iters=10)
    ms["oca_core_fwd library (SDPA)"] = sdpa_fwd
    leaves = [t.detach().requires_grad_() for t in (q, k, v, mask)]

    def sdpa_both():
        out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=1.0)
        torch.autograd.grad(out, leaves, go)

    ms["oca_core_bwd library (SDPA backward)"] = time_ms(sdpa_both, iters=5, warmup=2) - sdpa_fwd

    measure_large(dev, randn, ms, passes, entries)
    return {"package": studiosr_tpu_torch.__file__, "card": card_line(), "ms": ms, "passes": passes,
            "entries": entries}


# SwinFIR's f32 recipe: 3xTF32 on the TF32 tensor cores (494.7 TFLOP/s dense,
# three products a product) and the f32 FMA pipes' peak, TFLOP/s
TF32X3_TFLOPS, FMA_TFLOPS, HBM_TBS = 494.7 / 3, 66.9, 3.35
N_TOK = 64  # a window's tokens at window 8


def f32_bounds(name: str, tokens: int, nbytes: int, c: int = C, hidden: int = 2 * C) -> dict:
    """GFLOP of one launch of B5-B8 at width ``c``, window 8 and ``hidden``
    (PERF.md's count), its bytes (each input read once, each output
    written once), and the least ms at 3xTF32, on the FMA pipes and at the
    HBM rate."""
    t, hid, n = tokens, hidden, N_TOK
    flops = {"fused_window_attention_block": 2 * t * c * 4 * c + 4 * t * n * c,
             "fused_mlp_block": 4 * t * c * hid,
             "mlp_bwd": 10 * t * c * hid,
             "attention_bwd": 3 * 2 * t * c * 3 * c + 2 * 2 * t * c * c + 12 * t * n * c}[name]
    return {"gflop": flops / 1e9, "mb": nbytes / 1e6, "tf32x3_ms": flops / TF32X3_TFLOPS / 1e9,
            "fma_ms": flops / FMA_TFLOPS / 1e9, "bytes_ms": nbytes / HBM_TBS / 1e9}


def measure_f32() -> dict:
    """``--f32``: B5-B8 in f32 at SwinFIR's step shapes (batch 32 of 64 x 64
    maps, C 180, 6 heads, window 8 shift 4, hidden 360, drop-path scales
    (0, 1/0.9, ...)), then B5 and B6 at MaxSR's f32 geometry (the same maps,
    C 128, 4 heads of 32, window 8 unshifted, hidden 512, no drop-path: the
    rows ending " maxsr"), each with its per-pass split, its bound and its
    library yardstick: the same function as a sequence of f32 PyTorch calls
    (cuBLAS with TF32 off, as ``resolve_device`` sets it)."""
    import torch

    if "PYTHONPATH" not in os.environ:
        sys.path.insert(0, str(ROOT))
    import studiosr_tpu_torch
    from studiosr_tpu_torch import resolve_device
    from studiosr_tpu_torch.ops.cuda import _build, engagement
    from studiosr_tpu_torch.ops.cuda.attn_bwd import attention_bwd, attention_bwd_plain
    from studiosr_tpu_torch.ops.cuda.mlp_block import fused_mlp_block, mlp_block_plain
    from studiosr_tpu_torch.ops.cuda.mlp_bwd import mlp_bwd, mlp_bwd_plain
    from studiosr_tpu_torch.ops.cuda.window_attention import fused_window_attention_block, window_attention_plain

    dev = resolve_device("cuda")
    _build.build()
    gen = torch.Generator().manual_seed(0)
    f32, ws = torch.float32, 8

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    ms, passes, entries, bounds = {}, {}, {}, {}
    rows, rps = BATCH * CROP * CROP, CROP * CROP
    # (suffix, C, heads, hidden, shift, drop-path, the kernels timed)
    for suffix, c, heads, hidden, shift, drop, names in (
            ("", C, HEADS, 2 * C, 4, True, ("fused_window_attention_block", "fused_mlp_block", "mlp_bwd",
                                            "attention_bwd")),
            (" maxsr", 128, 4, 512, 0, False, ("fused_window_attention_block", "fused_mlp_block"))):
        x, g = randn(BATCH, CROP, CROP, c), randn(BATCH, CROP, CROP, c, scale=1e-3)
        dp = None
        if drop:
            dp = torch.full((BATCH,), 1 / 0.9, device=dev)
            dp[0] = 0.0
        attn_ops = (1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5),
                    randn(3 * c, scale=0.1), randn(c, c, scale=c**-0.5), randn(c, scale=0.1),
                    randn(heads, ws * ws, ws * ws, scale=0.5))
        xr, gr = x.reshape(rows, c), g.reshape(rows, c)
        mlp_ops = (1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, hidden, scale=c**-0.5),
                   randn(hidden, scale=0.1), randn(hidden, c, scale=hidden**-0.5))
        b2 = randn(c, scale=0.1)
        akw = dict(heads=heads, window_size=ws, shift=shift, drop_path=dp)
        mkw = dict(drop_path=dp, rows_per_sample=rps if drop else 0)
        weights = sum(t.numel() * 4 for t in attn_ops)
        cases = {
            "fused_window_attention_block": (
                lambda: fused_window_attention_block(x, *attn_ops, **akw),
                lambda: window_attention_plain(x, *attn_ops, **akw),
                lambda: attention_half_forward_sequence(x, attn_ops, heads, ws, shift, dp, dtype=f32),
                2 * x.numel() * 4 + weights),
            "fused_mlp_block": (lambda: fused_mlp_block(xr, *mlp_ops, b2, **mkw),
                                lambda: mlp_block_plain(xr, *mlp_ops, b2, **mkw),
                                lambda: mlp_half_forward_sequence(xr, (*mlp_ops, b2), dp, mkw["rows_per_sample"],
                                                                  dtype=f32),
                                2 * xr.numel() * 4),
            "mlp_bwd": (lambda: mlp_bwd(xr, gr, *mlp_ops, **mkw), lambda: mlp_bwd_plain(xr, gr, *mlp_ops, **mkw),
                        lambda: mlp_half_backward_sequence(xr, gr, mlp_ops, dp, rps, dtype=f32), 3 * xr.numel() * 4),
            "attention_bwd": (lambda: attention_bwd(x, g, *attn_ops, **akw),
                              lambda: attention_bwd_plain(x, g, *attn_ops, **akw),
                              lambda: attention_half_sequence(x, g, attn_ops, heads, ws, shift, dp, dtype=f32),
                              3 * x.numel() * 4 + weights),
        }
        for name in names:
            kernel, plain, sequence, moved = cases[name]
            label = f"{name} f32{suffix}"
            engagement.reset()
            ms[label] = time_ms(kernel)
            entries[label] = engagement.entries().get(name)
            passes[label] = pass_split(kernel)
            ms[f"{label} plain"] = time_ms(plain, iters=3, warmup=1)
            ms[f"{label} library (f32 PyTorch sequence)"] = time_ms(sequence(), iters=5, warmup=2)
            bounds[label] = f32_bounds(name, rows, moved, c, hidden)
            torch.cuda.empty_cache()
        del cases, x, g, xr, gr
        torch.cuda.empty_cache()
    return {"package": studiosr_tpu_torch.__file__, "card": card_line(), "ms": ms, "passes": passes,
            "entries": entries, "bounds": bounds}


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def measure_large(dev, randn, ms: dict, passes: dict, entries: dict) -> None:
    """Above window 16: B5 and B9 in their large families (MaxSR's step at a
    289² crop, SwinIR x4 serving at window 24, HAT's window-24 step) and B10,
    B12 and B13 at HAT's windows 24 and 12, each beside its yardstick."""
    import torch
    import torch.nn.functional as F  # noqa: F401

    from studiosr_tpu_torch.ops.cuda import engagement
    from studiosr_tpu_torch.ops.cuda.attn_bwd import attention_bwd
    from studiosr_tpu_torch.ops.cuda.oca_core import oca_core_bwd, oca_core_fwd
    from studiosr_tpu_torch.ops.cuda.ocab import fused_ocab_block
    from studiosr_tpu_torch.ops.cuda.window_attention import fused_window_attention_block

    bf = torch.bfloat16
    # above window 16: MaxSR's step at a 289² crop (window 17), SwinIR x4 serving at window 24 and HAT's
    # window-24 step (batch 32 of 72² maps, 288 windows, the bias in bf16 as the bf16 step gathers it)
    for label, ws, c, heads, batch, side, shift, train in (
            ("maxsr step 289", 17, 128, 4, 1, 289, 0, True), ("swinir serving", 24, 180, 6, 1, 264, 12, False),
            ("hat step ws24", 24, 180, 6, BATCH, 72, 12, True)):
        xl = randn(batch, side, side, c).to(bf)
        dense = (1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5).to(bf),
                 randn(3 * c, scale=0.1), randn(c, c, scale=c**-0.5).to(bf), randn(c, scale=0.1),
                 randn(heads, ws * ws, ws * ws, scale=0.5))
        if batch > 1:
            dense = (*dense[:6], dense[6].to(bf))
        dpl = torch.full((batch,), 1 / 0.9, device=dev) if batch > 1 else torch.ones(1, device=dev)
        kw = dict(heads=heads, window_size=ws, shift=shift, drop_path=dpl if train else None)
        served = list(dense)
        if not train:
            from studiosr_tpu_torch.ops.cuda.window_attention import pack_window_attention

            served[2:7] = [pack_window_attention(dense[2], dense[4], dense[6], heads), dense[3], None, dense[5], None]
        names = [(f"fused_window_attention_block_large {label}",
                  lambda: fused_window_attention_block(xl, *served, **kw))]
        if train:
            gl = randn(batch, side, side, c, scale=1e-3).to(bf)
            names.append((f"attention_bwd_large {label}", lambda: attention_bwd(xl, gl, *dense, **kw)))
        for name, fn in names:
            try:
                fn()
            except NotImplementedError:  # a checkout from before the streaming family
                ms[name] = float("nan")
                continue
            engagement.reset()
            ms[name] = time_ms(fn, iters=10)
            entries[name] = engagement.entries()
            passes[name] = pass_split(fn)
        ms[f"fused_window_attention_block_large {label} yardstick (bf16 PyTorch sequence)"] = time_ms(
            attention_half_forward_sequence(xl, dense, heads, ws, shift, kw["drop_path"]), iters=5)
        if train:
            sequence = attention_half_sequence(xl, gl, dense, heads, ws, shift, kw["drop_path"])
            ms[f"attention_bwd_large {label} yardstick (bf16 PyTorch sequence)"] = time_ms(sequence, iters=3, warmup=1)
            del sequence
        torch.cuda.empty_cache()
    # HAT at windows 24 and 12: B10 serving on a 264² map (the blob where the
    # checkout's H100 kernel takes the window, else dense weights on the
    # older kernel; a checkout from before every window raises at 12), and
    # B12 / B13 at the window-24 step (288 windows, 576 | 1296)
    from studiosr_tpu_torch.ops.cuda.ocab import ocab_mma_takes, pack_ocab_block

    for ws in (24, 12):
        nk = (3 * ws // 2) ** 2
        dense = [1 + randn(C, scale=0.1), randn(C, scale=0.1), randn(C, 3 * C, scale=C**-0.5).to(bf),
                 randn(3 * C, scale=0.1), randn(C, C, scale=C**-0.5).to(bf), randn(C, scale=0.1),
                 randn(HEADS, ws * ws, nk, scale=0.5).to(bf), 1 + randn(C, scale=0.1), randn(C, scale=0.1),
                 randn(C, 2 * C, scale=C**-0.5).to(bf), randn(2 * C, scale=0.1),
                 randn(2 * C, C, scale=(2 * C)**-0.5).to(bf), randn(C, scale=0.1)]
        served = list(dense)
        if ocab_mma_takes(C, HEADS, ws, 0.5, 2 * C):
            served[2], served[4], served[9], served[11] = pack_ocab_block(dense[2], dense[4], dense[9], dense[11],
                                                                          HEADS), None, None, None
        x264 = randn(1, 264, 264, C).to(bf)
        name, kw = f"fused_ocab_block serving ws{ws}", dict(heads=HEADS, window_size=ws, overlap_ratio=0.5)
        engagement.reset()
        try:
            fused_ocab_block(x264, *served, **kw)
        except (NotImplementedError, ValueError):  # a checkout from before every window
            ms[name] = float("nan")
        else:
            ms[name] = time_ms(lambda: fused_ocab_block(x264, *served, **kw))
            entries[name] = engagement.entries().get("fused_ocab_block")
            passes[name] = pass_split(lambda: fused_ocab_block(x264, *served, **kw))
        ms[f"{name} yardstick (bf16 PyTorch sequence)"] = time_ms(ocab_forward_sequence(x264, dense, HEADS, ws, 0.5),
                                                                 iters=5)
        torch.cuda.empty_cache()
    q, k, v, go = (randn(288, n, HEADS, 30, scale=sc).to(bf).transpose(1, 2)
                   for n, sc in ((576, 2 * 30**-0.5), (1296, 1.0), (1296, 1.0), (576, 1.0)))
    bias16 = randn(HEADS, 576, 1296, scale=2.0).to(bf)
    bias32 = bias16.float()
    for name, fn in (("oca_core_fwd_large hat step ws24", lambda: oca_core_fwd(q, k, v, bias16)),
                     ("oca_core_fwd_large hat step ws24 f32 bias", lambda: oca_core_fwd(q, k, v, bias32)),
                     ("oca_core_bwd_large hat step ws24", lambda: oca_core_bwd(q, k, v, bias16, go))):
        engagement.reset()
        try:
            fn()
        except NotImplementedError:  # a checkout from before the large family
            ms[name] = float("nan")
            continue
        ms[name] = time_ms(fn, iters=10)
        entries[name] = engagement.entries()
        passes[name] = pass_split(fn)
    # B13's backward with the same bias in bf16 and in f32 (the same values),
    # timed bf16, f32, f32, bf16: each row the mean of its two runs, with
    # their difference as its spread
    runs = {"bf16 bias": [], "f32 bias": []}
    for label in ("bf16 bias", "f32 bias", "f32 bias", "bf16 bias"):
        b = bias16 if label == "bf16 bias" else bias32
        try:
            runs[label].append(time_ms(lambda: oca_core_bwd(q, k, v, b, go), iters=10))
        except NotImplementedError:
            runs[label].append(float("nan"))
    for label, (t0, t1) in runs.items():
        ms[f"oca_core_bwd_large hat step ws24 {label}"] = (t0 + t1) / 2
        ms[f"oca_core_bwd_large hat step ws24 {label} spread"] = abs(t0 - t1)
    passes["oca_core_bwd_large hat step ws24 f32 bias"] = pass_split(lambda: oca_core_bwd(q, k, v, bias32, go))
    del q, k, v, go, bias16, bias32
    torch.cuda.empty_cache()


def kernel_bits() -> dict:
    """The ``--bits`` outputs, on the host."""
    import torch

    if "PYTHONPATH" not in os.environ:
        sys.path.insert(0, str(ROOT))
    from studiosr_tpu_torch import resolve_device
    from studiosr_tpu_torch.ops.cuda import _build
    from studiosr_tpu_torch.ops.cuda.mlp_block import fused_mlp_block, pack_mlp_block
    from studiosr_tpu_torch.ops.cuda.mlp_bwd import mlp_bwd
    from studiosr_tpu_torch.ops.cuda.ocab import fused_ocab_block, pack_ocab_block

    dev = resolve_device("cuda")
    _build.build(n for n in ("mlp_block_mma", "mlp_bwd_mma", "ocab_mma", "window_attention_mma", "attn_bwd_mma",
                             "window_attention", "window_attention16", "attn_bwd", "attn_bwd16", "oca_fwd_mma",
                             "oca_bwd_mma", "window_attention_f32", "mlp_block_f32", "attn_bwd_f32", "mlp_bwd_f32")
                 if n in _build.SOURCES)  # a checkout of its own era builds what it has
    gen = torch.Generator().manual_seed(0)
    bf, hidden = torch.bfloat16, 2 * C

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    rows, rps = BATCH * CROP * CROP, CROP * CROP
    mlp = [1 + randn(C, scale=0.1), randn(C, scale=0.1), randn(C, hidden, scale=C**-0.5, dtype=bf),
           randn(hidden, scale=0.1), randn(hidden, C, scale=hidden**-0.5, dtype=bf), randn(C, scale=0.1)]
    x, g = randn(rows, C, dtype=bf), randn(rows, C, scale=1e-3, dtype=bf)
    dp = torch.full((rows // rps,), 1 / 0.9, device=dev)
    dp[0] = 0.0
    out = {"B6 step": fused_mlp_block(x, *mlp, drop_path=dp, rows_per_sample=rps)}
    for i, t in enumerate(mlp_bwd(x, g, *mlp[:5], drop_path=dp, rows_per_sample=rps)):
        out[f"B7 step output {i}"] = t
    f32_rows = 2 * rps  # f32: two samples' rows, SwinFIR's widths
    mlp32 = [t.float() for t in mlp]
    x32, g32 = x[:f32_rows].float(), g[:f32_rows].float()
    out["(f32) B6 rows"] = fused_mlp_block(x32, *mlp32, drop_path=dp[:2], rows_per_sample=rps)
    out["(f32) B6 extra rows"] = fused_mlp_block(x32, *mlp32, extra=g32 * 1e3, extra_scale=mlp32[5])
    for i, t in enumerate(mlp_bwd(x32, g32, *mlp32[:5], drop_path=dp[:2], rows_per_sample=rps)):
        out[f"(f32) B7 rows output {i}"] = t
    xe, extra, escale = randn(65536, C, dtype=bf), randn(65536, C, dtype=bf), randn(C, scale=0.01)
    blob = pack_mlp_block(mlp[2], mlp[4])
    out["B6 extra serving"] = fused_mlp_block(xe, mlp[0], mlp[1], blob, mlp[3], None, mlp[5], extra=extra,
                                              extra_scale=escale)
    ocab = [1 + randn(C, scale=0.1), randn(C, scale=0.1), randn(C, 3 * C, scale=C**-0.5, dtype=bf),
            randn(3 * C, scale=0.1), randn(C, C, scale=C**-0.5, dtype=bf), randn(C, scale=0.1),
            randn(HEADS, 256, 576, scale=0.5, dtype=bf), 1 + randn(C, scale=0.1), randn(C, scale=0.1),
            randn(C, hidden, scale=C**-0.5, dtype=bf), randn(hidden, scale=0.1),
            randn(hidden, C, scale=hidden**-0.5, dtype=bf), randn(C, scale=0.1)]
    ocab[2] = pack_ocab_block(ocab[2], ocab[4], ocab[9], ocab[11], HEADS)
    ocab[4] = ocab[9] = ocab[11] = None
    xs = randn(1, 256, 256, C, dtype=bf)
    out["B10 serving"] = fused_ocab_block(xs, *ocab, heads=HEADS, window_size=16, overlap_ratio=0.5)
    ocab[6] = randn(HEADS, 64, 144, scale=0.5, dtype=bf)  # window 8: 12 x 12 key windows
    out["B10 serving window 8"] = fused_ocab_block(randn(1, 64, 96, C, dtype=bf), *ocab, heads=HEADS, window_size=8,
                                                   overlap_ratio=0.5)
    from studiosr_tpu_torch.ops.cuda.oca_core import oca_core_bwd, oca_core_fwd

    for ws in (8, 16):  # B12 / B13 at HAT's OCA geometry of windows 8 and 16, on the OCAB's transposed views
        nq, nk, d = ws * ws, (3 * ws // 2) ** 2, C // HEADS
        q, k, v, go = (randn(64, n, HEADS, d, scale=s, dtype=bf).transpose(1, 2)
                       for n, s in ((nq, 2 * d**-0.5), (nk, 1.0), (nk, 1.0), (nq, 1.0)))
        bias = randn(HEADS, nq, nk, scale=2.0)
        out[f"B12 window {ws} f32 bias"] = oca_core_fwd(q, k, v, bias)
        out[f"B12 window {ws} bf16 bias"] = oca_core_fwd(q, k, v, bias.to(bf))
        for i, t in enumerate(oca_core_bwd(q, k, v, bias, go)):
            out[f"B13 window {ws} output {i}"] = t
    from studiosr_tpu_torch.ops.cuda.attn_bwd import attention_bwd
    from studiosr_tpu_torch.ops.cuda.window_attention import fused_window_attention_block

    for dt, c, heads, batch in ((bf, C, HEADS, 8), (bf, 128, 4, 8), (bf, 96, 2, 2), (torch.float32, 64, 2, 2),
                                (torch.float32, C, HEADS, 2)):
        for ws in (8, 16):
            label = f"{'bf16' if dt == bf else '(f32)'} C {c} window {ws}"
            ops = [1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5, dtype=dt),
                   randn(3 * c, scale=0.1), randn(c, c, scale=c**-0.5, dtype=dt), randn(c, scale=0.1),
                   randn(heads, ws * ws, ws * ws, scale=0.5, dtype=bf if c == 128 else torch.float32)]
            xa, ga = randn(batch, CROP, CROP, c, dtype=dt), randn(batch, CROP, CROP, c, scale=1e-3, dtype=dt)
            dpa = torch.full((batch,), 1 / 0.9, device=dev)
            dpa[0] = 0.0
            kw = dict(heads=heads, window_size=ws, shift=ws // 2, drop_path=dpa)
            out[f"B5 {label}"] = fused_window_attention_block(xa, *ops, **kw)
            for i, t in enumerate(attention_bwd(xa, ga, *ops, **kw)):
                out[f"B8/B9 {label} output {i}"] = t
    # above window 16 (the streaming forward): B5 at window 24 (C 180, shift
    # 12, drop-path, a bf16 bias; the serving blob's f32 bias unshifted) and
    # MaxSR's window 17 (C 128, 289 tokens in five tiles), B12's large entry
    # (576 | 1296 with either bias, ragged 100 | 700 at d 12), B10 at window 24
    for label, ws, c, heads, shape, shift, served in (("window 24", 24, C, HEADS, (2, 48, 72), 12, False),
                                                      ("window 24 served", 24, C, HEADS, (1, 72, 72), 0, True),
                                                      ("window 17", 17, 128, 4, (1, 68, 68), 0, False)):
        ops = [1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5, dtype=bf),
               randn(3 * c, scale=0.1), randn(c, c, scale=c**-0.5, dtype=bf), randn(c, scale=0.1),
               randn(heads, ws * ws, ws * ws, scale=0.5, dtype=torch.float32 if served else bf)]
        xa = randn(*shape, c, dtype=bf)
        dpa = None if served else torch.full((shape[0],), 1 / 0.9, device=dev)
        kw = dict(heads=heads, window_size=ws, shift=shift, drop_path=dpa)
        if served:
            from studiosr_tpu_torch.ops.cuda.window_attention import pack_window_attention

            ops[2:7] = [pack_window_attention(ops[2], ops[4], ops[6], heads), ops[3], None, ops[5], None]
        out[f"large forward B5 {label}"] = fused_window_attention_block(xa, *ops, **kw)
    for nq, nk, d, bw in ((576, 1296, 30, 16), (100, 700, 12, 5)):
        q, k, v = (randn(bw, n, HEADS, d, scale=s, dtype=bf).transpose(1, 2)
                   for n, s in ((nq, 2 * d**-0.5), (nk, 1.0), (nk, 1.0)))
        bias = randn(HEADS, nq, nk, scale=2.0)
        out[f"large forward B12 {nq} | {nk} f32 bias"] = oca_core_fwd(q, k, v, bias)
        out[f"large forward B12 {nq} | {nk} bf16 bias"] = oca_core_fwd(q, k, v, bias.to(bf))
    ocab[6] = randn(HEADS, 576, 1296, scale=0.5, dtype=bf)
    out["large forward B10 window 24"] = fused_ocab_block(randn(1, 48, 72, C, dtype=bf), *ocab, heads=HEADS,
                                                          window_size=24, overlap_ratio=0.5)
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def ab_bits(checkout: Path, path: Path) -> int:
    """``--bits`` on ``checkout`` and on this tree; 1 if any output differs."""
    import torch

    files = []
    for label, tree in (("parent", checkout), ("change", ROOT)):
        files.append(path.with_name(f"{path.name}.{label}"))
        env = dict(os.environ, PYTHONPATH=str(tree))
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--bits", str(files[-1])], env=env, cwd=tree,
                       check=True, timeout=1800)
    a, b = (torch.load(f, weights_only=True) for f in files)
    differ = sorted(k for k in a.keys() | b.keys() if k not in a or k not in b or not torch.equal(a[k], b[k]))
    for k in sorted(a):
        note = "the same bits"
        if k in differ and k in b and a[k].shape == b[k].shape:
            rel = float((a[k].double() - b[k].double()).abs().max() / a[k].double().abs().max().clamp_min(1e-30))
            note = f"differs (max |change - parent| / max |parent| {rel:.3e})"
        elif k in differ:
            note = "differs"
        print(f"{k}: {tuple(a[k].shape)} {a[k].dtype} {note}")
    return 1 if any("(f32)" not in k for k in differ) else 0


def ab(checkout: Path, large: bool = False, f32: bool = False) -> None:
    """Run this script on ``checkout``, this tree, this tree, ``checkout``."""
    runs = []
    for label, tree in (("parent", checkout), ("change", ROOT), ("change", ROOT), ("parent", checkout)):
        env = dict(os.environ, PYTHONPATH=str(tree))
        cmd = [sys.executable, str(Path(__file__).resolve())] + (["--large"] if large else []) + (
            ["--f32"] if f32 else [])
        out = subprocess.run(cmd, env=env, cwd=tree, capture_output=True, text=True, check=True, timeout=1800).stdout
        line = json.loads(out.strip().splitlines()[-1])
        print(json.dumps({"run": label, **line}), flush=True)
        runs.append((label, line))
    print("ms, " + " / ".join(label for label, _ in runs))
    for name in runs[0][1]["ms"]:
        print(f"  {name}: " + " / ".join(f"{line['ms'].get(name, float('nan')):.4f}" for _, line in runs))
    for name in runs[0][1]["passes"]:
        for label, line in runs:
            print(f"  {name} passes [{label}]: " + "; ".join(
                f"{k} x{n:g} {t:.4f}" for k, n, t in line["passes"][name]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", type=Path, help="a second checkout to compare with: parent, this, this, parent")
    parser.add_argument("--large", action="store_true",
                        help="time only the kernels above window 16 (B5, B9, B10, B12, B13 in their large families)")
    parser.add_argument("--f32", action="store_true",
                        help="time only B5-B8 in f32 at SwinFIR's step shapes, beside f32 PyTorch sequences")
    parser.add_argument("--bits", type=Path, metavar="FILE",
                        help="write B5-B10's outputs at windows 8 and 16 and B12's and B13's at their OCA geometries")
    args = parser.parse_args()
    if args.bits and args.checkout:
        return ab_bits(args.checkout.resolve(), args.bits.resolve())
    if args.bits:
        import torch

        torch.save(kernel_bits(), args.bits)
    elif args.checkout:
        ab(args.checkout.resolve(), args.large, args.f32)
    elif args.f32:
        print(json.dumps(measure_f32()))
    else:
        print(json.dumps(measure(args.large)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
