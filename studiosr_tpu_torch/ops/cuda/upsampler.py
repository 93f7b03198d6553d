"""B3 and B4: the x4 and the x2 / x3 pixelshuffle tails (CUDA kernels ``csrc/upsampler.cu``).

Replaces ``studiosr_tpu/ops/pallas/upsampler.py::fused_upsample_x4``:
conv3x3 -> pixel_shuffle(2) -> conv3x3 -> pixel_shuffle(2) -> conv_last,
each conv zero-padding at its own resolution. One call launches the tail
(three conv passes, the shuffles folded into the stores); the
intermediates are allocated here and rounded to the map's dtype.

Weights are HWIO in the map's dtype: ``w0`` and ``w1`` (3, 3, Cin, 4 Cin),
``w2`` (3, 3, Cin, n_colors); biases f32.

B4 replaces ``studiosr_tpu/ops/pallas/upsampler.py::fused_upsample_s``:
conv3x3 (Cin -> s^2 Cin) -> pixel_shuffle(s) -> conv_last, s in {2, 3}, in
two conv passes; c0 is allocated here at sH x sW and rounded to the map's
dtype, and conv_last zero-pads at that resolution. ``w0`` is (3, 3, Cin,
s^2 Cin) and ``w2`` (3, 3, Cin, n_colors).
"""

from __future__ import annotations

import torch

from studiosr_tpu_torch.ops.cuda import _build
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, check, finish, stream
from studiosr_tpu_torch.ops.cuda.conv3x3 import conv3x3_plain
from studiosr_tpu_torch.ops.pixel_shuffle import pixel_shuffle

__all__ = ["fused_upsample_x4", "upsample_x4_plain", "fused_upsample_s", "upsample_s_plain", "SCALES_S"]

SCALES_S = (2, 3)
_ARGS = (P,) * 10 + (I,) * 5 + (P,)
_ARGS_S = (P,) * 7 + (I,) * 6 + (P,)
_SIGNATURES = {"upsample_x4_f32": _ARGS, "upsample_x4_bf16": _ARGS, "upsample_s_f32": _ARGS_S,
               "upsample_s_bf16": _ARGS_S}


def upsample_x4_plain(x, w0, b0, w1, b1, w2, b2):
    """Plain PyTorch version; each conv in f32, stages rounded to ``x.dtype``."""
    y = pixel_shuffle(conv3x3_plain(x, w0, b0), 2)
    y = pixel_shuffle(conv3x3_plain(y, w1, b1), 2)
    return conv3x3_plain(y, w2, b2)


def fused_upsample_x4(x, w0, b0, w1, b1, w2, b2):
    """(B, H, W, Cin) -> (B, 4H, 4W, n_colors). CPU tensors take the plain
    version; CUDA tensors launch the kernels or raise."""
    if x.device.type == "cpu":
        return upsample_x4_plain(x, w0, b0, w1, b1, w2, b2)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_upsample_x4: unsupported dtype {x.dtype}")
    bsz, h, w, cin = x.shape
    n_colors = w2.shape[-1]
    dev, dt, f32 = x.device, x.dtype, torch.float32
    ptrs = [
        check(x, "x", (bsz, h, w, cin), dt, dev),
        check(w0, "w0", (3, 3, cin, 4 * cin), dt, dev), check(b0, "b0", (4 * cin,), f32, dev),
        check(w1, "w1", (3, 3, cin, 4 * cin), dt, dev), check(b1, "b1", (4 * cin,), f32, dev),
        check(w2, "w2", (3, 3, cin, n_colors), dt, dev), check(b2, "b2", (n_colors,), f32, dev),
    ]
    t1 = torch.empty((bsz, 2 * h, 2 * w, cin), dtype=dt, device=dev)
    t2 = torch.empty((bsz, 4 * h, 4 * w, cin), dtype=dt, device=dev)
    out = torch.empty((bsz, 4 * h, 4 * w, n_colors), dtype=dt, device=dev)
    lib = _build.load("upsampler", _SIGNATURES)
    fn = lib.upsample_x4_bf16 if dt == torch.bfloat16 else lib.upsample_x4_f32
    status = fn(*ptrs, t1.data_ptr(), t2.data_ptr(), out.data_ptr(), bsz, h, w, cin, n_colors, stream(dev))
    finish("fused_upsample_x4", status)
    return out


def upsample_s_plain(x, w0, b0, w2, b2, s: int):
    """Plain PyTorch version of B4; each conv in f32, c0 rounded to ``x.dtype``."""
    return conv3x3_plain(pixel_shuffle(conv3x3_plain(x, w0, b0), s), w2, b2)


def fused_upsample_s(x, w0, b0, w2, b2, s: int):
    """(B, H, W, Cin) -> (B, sH, sW, n_colors) for s in :data:`SCALES_S`. CPU
    tensors take the plain version; CUDA tensors launch the kernels or raise."""
    if s not in SCALES_S:
        raise ValueError(f"fused_upsample_s: scale {s} is not one of {SCALES_S}")
    if x.device.type == "cpu":
        return upsample_s_plain(x, w0, b0, w2, b2, s)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_upsample_s: unsupported dtype {x.dtype}")
    bsz, h, w, cin = x.shape
    n_colors = w2.shape[-1]
    dev, dt, f32 = x.device, x.dtype, torch.float32
    ptrs = [
        check(x, "x", (bsz, h, w, cin), dt, dev),
        check(w0, "w0", (3, 3, cin, s * s * cin), dt, dev), check(b0, "b0", (s * s * cin,), f32, dev),
        check(w2, "w2", (3, 3, cin, n_colors), dt, dev), check(b2, "b2", (n_colors,), f32, dev),
    ]
    c0 = torch.empty((bsz, s * h, s * w, cin), dtype=dt, device=dev)
    out = torch.empty((bsz, s * h, s * w, n_colors), dtype=dt, device=dev)
    lib = _build.load("upsampler", _SIGNATURES)
    fn = lib.upsample_s_bf16 if dt == torch.bfloat16 else lib.upsample_s_f32
    status = fn(*ptrs, c0.data_ptr(), out.data_ptr(), bsz, h, w, cin, n_colors, s, stream(dev))
    finish("fused_upsample_s", status)
    return out
