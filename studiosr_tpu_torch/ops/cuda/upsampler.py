"""B3: the x4 pixelshuffle tail (CUDA kernels ``csrc/upsampler.cu``).

Replaces ``studiosr_tpu/ops/pallas/upsampler.py::fused_upsample_x4``:
conv3x3 -> pixel_shuffle(2) -> conv3x3 -> pixel_shuffle(2) -> conv_last,
each conv zero-padding at its own resolution. One call launches the tail
(three conv passes, the shuffles folded into the stores); the
intermediates are allocated here and rounded to the map's dtype.

Weights are HWIO in the map's dtype: ``w0`` and ``w1`` (3, 3, Cin, 4 Cin),
``w2`` (3, 3, Cin, n_colors); biases f32.
"""

from __future__ import annotations

import torch

from studiosr_tpu_torch.ops.cuda import _build
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, check, finish, stream
from studiosr_tpu_torch.ops.cuda.conv3x3 import conv3x3_plain
from studiosr_tpu_torch.ops.pixel_shuffle import pixel_shuffle

__all__ = ["fused_upsample_x4", "upsample_x4_plain"]

_ARGS = (P,) * 10 + (I,) * 5 + (P,)
_SIGNATURES = {"upsample_x4_f32": _ARGS, "upsample_x4_bf16": _ARGS}


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
