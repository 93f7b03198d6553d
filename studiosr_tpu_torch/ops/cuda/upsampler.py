"""B3 and B4: the x4 and the x2 / x3 pixelshuffle tails (CUDA kernels ``csrc/upsampler.cu``).

Replaces ``studiosr_tpu/ops/pallas/upsampler.py::fused_upsample_x4``:
conv3x3 -> pixel_shuffle(2) -> conv3x3 -> pixel_shuffle(2) -> conv_last,
each conv zero-padding at its own resolution. One call launches the tail
(three conv passes, the shuffles folded into the stores); the
intermediates are allocated here and rounded to the map's dtype.

B4 replaces ``studiosr_tpu/ops/pallas/upsampler.py::fused_upsample_s``:
conv3x3 (Cin -> s^2 Cin) -> pixel_shuffle(s) -> conv_last, s in {2, 3}, in
two conv passes; c0 is allocated here at sH x sW and rounded to the map's
dtype, and conv_last zero-pads at that resolution.

Weights are HWIO in the map's dtype: ``w0`` (and at x4 ``w1``) (3, 3, Cin,
s^2 Cin), ``w2`` (3, 3, Cin, n_colors); biases f32. They may also come
packed in the kernels' layouts (:func:`pack_tail`, what serving prepares
once at load time): in bf16 ``w0`` and ``w1`` by
:func:`pack_shuffle_conv_weights`, ``w2`` by :func:`pack_conv_last_weights`;
in f32 ``w0`` and ``w1`` by ``conv3x3.pack_conv3x3_f32_weights``;
HWIO weights are packed on every call. bf16 launches the kernels written
for the H100 (C entries ``upsample_x4_mma_bf16``, ``upsample_s_mma_bf16``:
Cin a multiple of 16 up to 64, n_colors up to 8; other geometries raise).
f32 with s^2 Cin > 16 (:func:`f32_mma_takes`) launches ``upsample_x4_mma_f32``
/ ``upsample_s_mma_f32``: the wide convs on B2's 3xTF32 kernel written for
the H100 (``csrc/conv3x3_f32.cuh``) on weights packed by
``conv3x3.pack_conv3x3_f32_weights`` (``pack_tail`` packs them at load time,
HWIO is packed per call), conv_last on HWIO; narrower f32 tails run the
simple version on HWIO weights (``upsample_x4_f32``, ``upsample_s_f32``).
``engagement.entries()`` tells them apart.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from studiosr_tpu_torch.ops.cuda import _build
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, check, finish, STREAM, call
from studiosr_tpu_torch.ops.cuda import conv3x3 as _conv
from studiosr_tpu_torch.ops.cuda.conv3x3 import conv3x3_plain
from studiosr_tpu_torch.ops.pixel_shuffle import pixel_shuffle

__all__ = [
    "fused_upsample_x4", "upsample_x4_plain", "fused_upsample_s", "upsample_s_plain", "SCALES_S",
    "pack_shuffle_conv_weights", "unpack_shuffle_conv_weights", "pack_conv_last_weights", "unpack_conv_last_weights",
    "pack_tail", "mma_geometry_error", "f32_mma_takes",
]

SCALES_S = (2, 3)
_ARGS = (P,) * 10 + (I,) * 5 + (P,)
_ARGS_S = (P,) * 7 + (I,) * 6 + (P,)
_SIGNATURES = {"upsample_x4_f32": _ARGS, "upsample_x4_mma_bf16": _ARGS, "upsample_x4_mma_f32": _ARGS,
               "upsample_s_f32": _ARGS_S, "upsample_s_mma_bf16": _ARGS_S, "upsample_s_mma_f32": _ARGS_S}
_CHUNK = {2: 128, 3: 96}  # csrc/upsampler.cu UpChunk: columns a ring slot
_K, _MAX_COLORS = 64, 8  # csrc/upsampler.cu UP_K (the most Cin), UL_MAX_COLORS


def mma_geometry_error(cin: int, n_colors: int) -> str:
    """Why the bf16 kernels do not take this geometry, or ''."""
    if cin % 16 or not 16 <= cin <= _K:
        return f"Cin {cin} is not a multiple of 16 from 16 to {_K}"
    if not 1 <= n_colors <= _MAX_COLORS:
        return f"n_colors {n_colors} is not from 1 to {_MAX_COLORS}"
    return ""


def packed_shuffle_conv_shape(cin: int, s: int) -> Tuple[int, ...]:
    """(chunks of NC columns, 9 taps, 8 groups of 8 input channels (K padded
    to 64), NC / 8, 8 columns, 8 input channels)."""
    nc = _CHUNK[s]
    return (-(-s * s * cin // nc), 9, _K // 8, nc // 8, 8, 8)


def pack_shuffle_conv_weights(w: torch.Tensor, s: int) -> torch.Tensor:
    """HWIO (3, 3, Cin, s^2 Cin) -> the bf16 layout of the kernel's weight
    ring: columns reordered from torch's pixel-shuffle order c s^2 + i s + j
    to (i s + j) Cin + c (a Cin-column stretch is one subpixel plane), cut
    into chunks of NC columns (zero past s^2 Cin), input channels zero-padded
    to 64, and each (chunk, tap) laid out as the image of a ring slot,
    wgmma's K-major operand: element (column n, input channel k) at [k / 8,
    n / 8, n % 8, k % 8]."""
    _, _, cin, cout = w.shape
    if cout != s * s * cin:
        raise ValueError(f"a pixel_shuffle({s}) conv needs Cout = {s * s} Cin, got {tuple(w.shape)}")
    if cin > _K:
        raise ValueError(f"Cin {cin} is more than {_K}")
    nchunk, _, ncg, nng, _, _ = packed_shuffle_conv_shape(cin, s)
    nc = 8 * nng
    wt = w.detach().to(torch.bfloat16).reshape(9, cin, cin, s * s).transpose(2, 3).reshape(9, cin, cout)
    wt = F.pad(wt, (0, nchunk * nc - cout, 0, _K - cin))
    wt = wt.reshape(9, ncg, 8, nchunk, nng, 8)  # tap, k / 8, k % 8, chunk, n / 8, n % 8
    return wt.permute(3, 0, 1, 4, 5, 2).contiguous()


def unpack_shuffle_conv_weights(packed: torch.Tensor, cin: int, s: int) -> torch.Tensor:
    """Inverse of :func:`pack_shuffle_conv_weights`: HWIO (3, 3, Cin, s^2 Cin)."""
    shape = packed_shuffle_conv_shape(cin, s)
    if tuple(packed.shape) != shape:
        raise ValueError(f"packed weights {tuple(packed.shape)} do not fit Cin {cin} at x{s}: expected {shape}")
    nchunk, _, _, nng, _, _ = shape
    wt = packed.permute(1, 2, 5, 0, 3, 4).reshape(9, _K, nchunk * nng * 8)[:, :cin, : s * s * cin]
    return wt.reshape(9, cin, s * s, cin).transpose(2, 3).reshape(3, 3, cin, s * s * cin)


def pack_conv_last_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Cin, n_colors) -> the bf16 layout conv_last's warps read
    into registers: for each tap and 16-channel k-step, mma.m16n8k16's B
    fragment of each lane 4 g + t, (9, Cin / 16, 8, 4, 4) with element [tap,
    ks, g, t, e] = w[tap, 16 ks + 2 t + 8 (e // 2) + e % 2, column g], zero
    past n_colors."""
    _, _, cin, n_colors = w.shape
    wt = F.pad(w.detach().to(torch.bfloat16).reshape(9, cin, n_colors), (0, _MAX_COLORS - n_colors))
    wt = wt.reshape(9, cin // 16, 2, 4, 2, _MAX_COLORS)  # tap, ks, k % 16 // 8, t, k % 2, column
    return wt.permute(0, 1, 5, 3, 2, 4).reshape(9, cin // 16, _MAX_COLORS, 4, 4).contiguous()


def unpack_conv_last_weights(packed: torch.Tensor, n_colors: int) -> torch.Tensor:
    """Inverse of :func:`pack_conv_last_weights`: HWIO (3, 3, Cin, n_colors)."""
    cin = 16 * packed.shape[1]
    if tuple(packed.shape) != (9, cin // 16, _MAX_COLORS, 4, 4):
        raise ValueError(f"packed conv_last weights {tuple(packed.shape)} are not (9, Cin / 16, 8, 4, 4)")
    wt = packed.reshape(9, cin // 16, _MAX_COLORS, 4, 2, 2).permute(0, 1, 4, 3, 5, 2)
    return wt.reshape(3, 3, cin, _MAX_COLORS)[..., :n_colors]


def f32_mma_takes(cin: int, s: int) -> bool:
    """Whether an f32 tail of ``cin`` channels at shuffle ``s`` runs its
    wide convs on the 3xTF32 kernel written for the H100: s^2 Cin > 16."""
    return _conv.f32_mma_takes(s * s * cin)


def pack_tail(tail: Sequence[torch.Tensor], scale: int) -> tuple:
    """The tail's operands (w0, b0, [w1, b1,] w2, b2), HWIO, with the
    weights packed as the kernels of their dtype read them (biases as they
    are): bf16 every conv where the bf16 kernels take the geometry
    (:func:`mma_geometry_error`); f32 the wide convs by
    ``conv3x3.pack_conv3x3_f32_weights`` where :func:`f32_mma_takes` the
    tail (conv_last stays HWIO). Any other tail comes back as it is.
    ``scale`` 4 for B3, 2 or 3 for B4."""
    s = 2 if scale == 4 else scale
    *convs, w2, b2 = tail
    cin = convs[0].shape[2]
    if convs[0].dtype == torch.float32:
        if not f32_mma_takes(cin, s):
            return tuple(tail)
        return (*[_conv.pack_conv3x3_f32_weights(t) if i % 2 == 0 else t for i, t in enumerate(convs)], w2, b2)
    if mma_geometry_error(cin, b2.shape[0]):
        return tuple(tail)
    packed = [pack_shuffle_conv_weights(t, s) if i % 2 == 0 else t for i, t in enumerate(convs)]
    return (*packed, pack_conv_last_weights(w2), b2)


def _hwio_shuffle(w: torch.Tensor, cin: int, s: int) -> torch.Tensor:
    if w.dim() == 6:
        return unpack_shuffle_conv_weights(w, cin, s)
    return _conv.unpack_conv3x3_f32_weights(w, cin, s * s * cin) if w.dim() == 5 else w


def _hwio_last(w: torch.Tensor, n_colors: int) -> torch.Tensor:
    return unpack_conv_last_weights(w, n_colors) if w.dim() == 5 else w


def _mma_weights(w, name: str, cin: int, s: int, dev: torch.device) -> torch.Tensor:
    """A pixel_shuffle(s) conv's weights as the bf16 kernel reads them,
    HWIO packed on the way; raises on anything else."""
    if w.dim() == 4:
        check(w, name, (3, 3, cin, s * s * cin), torch.bfloat16, dev)
        w = pack_shuffle_conv_weights(w, s)
    check(w, name, packed_shuffle_conv_shape(cin, s), torch.bfloat16, dev)
    return w


def _f32_weights(w, name: str, cin: int, s: int, dev: torch.device) -> torch.Tensor:
    """A wide f32 conv's weights as the 3xTF32 kernel reads them, HWIO
    packed on the way; raises on anything else."""
    if w.dim() == 4:
        check(w, name, (3, 3, cin, s * s * cin), torch.float32, dev)
        w = _conv.pack_conv3x3_f32_weights(w)
    check(w, name, _conv.packed_conv3x3_f32_shape(cin, s * s * cin), torch.float32, dev)
    return w


def _mma_last_weights(w, name: str, cin: int, n_colors: int, dev: torch.device) -> torch.Tensor:
    """conv_last's weights as the bf16 kernel reads them, HWIO packed on
    the way; raises on anything else."""
    if w.dim() == 4:
        check(w, name, (3, 3, cin, n_colors), torch.bfloat16, dev)
        w = pack_conv_last_weights(w)
    check(w, name, (9, cin // 16, _MAX_COLORS, 4, 4), torch.bfloat16, dev)
    return w


def _geometry(x: torch.Tensor, b2: torch.Tensor, name: str):
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    bsz, h, w, cin = x.shape
    n_colors = b2.shape[0]
    if x.dtype == torch.bfloat16:
        error = mma_geometry_error(cin, n_colors)
        if error:
            raise ValueError(f"{name}: the bf16 kernel does not take this geometry: {error}")
    return bsz, h, w, cin, n_colors


def upsample_x4_plain(x, w0, b0, w1, b1, w2, b2):
    """Plain PyTorch version; each conv in f32, stages rounded to ``x.dtype``;
    weights HWIO or packed."""
    cin, n_colors = x.shape[-1], b2.shape[0]
    w0, w1, w2 = _hwio_shuffle(w0, cin, 2), _hwio_shuffle(w1, cin, 2), _hwio_last(w2, n_colors)
    y = pixel_shuffle(conv3x3_plain(x, w0, b0), 2)
    y = pixel_shuffle(conv3x3_plain(y, w1, b1), 2)
    return conv3x3_plain(y, w2, b2)


def fused_upsample_x4(x, w0, b0, w1, b1, w2, b2):
    """(B, H, W, Cin) -> (B, 4H, 4W, n_colors). CPU tensors take the plain
    version; CUDA tensors launch the kernels or raise."""
    if x.device.type == "cpu":
        return upsample_x4_plain(x, w0, b0, w1, b1, w2, b2)
    bsz, h, w, cin, n_colors = _geometry(x, b2, "fused_upsample_x4")
    dev, dt, f32 = x.device, x.dtype, torch.float32
    tc32 = dt == torch.float32 and f32_mma_takes(cin, 2)
    if dt == torch.bfloat16:  # kept alive until the launch is enqueued
        w0, w1 = _mma_weights(w0, "w0", cin, 2, dev), _mma_weights(w1, "w1", cin, 2, dev)
        w2 = _mma_last_weights(w2, "w2", cin, n_colors, dev)
        pw = [w0.data_ptr(), w1.data_ptr(), w2.data_ptr()]
    elif tc32:
        w0, w1 = _f32_weights(w0, "w0", cin, 2, dev), _f32_weights(w1, "w1", cin, 2, dev)
        pw = [w0.data_ptr(), w1.data_ptr(), check(w2, "w2", (3, 3, cin, n_colors), dt, dev)]
    else:
        pw = [check(w0, "w0", (3, 3, cin, 4 * cin), dt, dev), check(w1, "w1", (3, 3, cin, 4 * cin), dt, dev),
              check(w2, "w2", (3, 3, cin, n_colors), dt, dev)]
    ptrs = [check(x, "x", (bsz, h, w, cin), dt, dev), pw[0], check(b0, "b0", (4 * cin,), f32, dev),
            pw[1], check(b1, "b1", (4 * cin,), f32, dev), pw[2], check(b2, "b2", (n_colors,), f32, dev)]
    t1 = torch.empty((bsz, 2 * h, 2 * w, cin), dtype=dt, device=dev)
    t2 = torch.empty((bsz, 4 * h, 4 * w, cin), dtype=dt, device=dev)
    out = torch.empty((bsz, 4 * h, 4 * w, n_colors), dtype=dt, device=dev)
    lib = _build.load("upsampler", _SIGNATURES)
    entry = "upsample_x4_mma_bf16" if dt == torch.bfloat16 else "upsample_x4_mma_f32" if tc32 else "upsample_x4_f32"
    status = call(dev, getattr(lib, entry), *ptrs, t1.data_ptr(), t2.data_ptr(), out.data_ptr(), bsz, h, w, cin,
                  n_colors, STREAM)
    finish("fused_upsample_x4", status, entry)
    return out


def upsample_s_plain(x, w0, b0, w2, b2, s: int):
    """Plain PyTorch version of B4; each conv in f32, c0 rounded to
    ``x.dtype``; weights HWIO or packed."""
    w0, w2 = _hwio_shuffle(w0, x.shape[-1], s), _hwio_last(w2, b2.shape[0])
    return conv3x3_plain(pixel_shuffle(conv3x3_plain(x, w0, b0), s), w2, b2)


def fused_upsample_s(x, w0, b0, w2, b2, s: int):
    """(B, H, W, Cin) -> (B, sH, sW, n_colors) for s in :data:`SCALES_S`. CPU
    tensors take the plain version; CUDA tensors launch the kernels or raise."""
    if s not in SCALES_S:
        raise ValueError(f"fused_upsample_s: scale {s} is not one of {SCALES_S}")
    if x.device.type == "cpu":
        return upsample_s_plain(x, w0, b0, w2, b2, s)
    bsz, h, w, cin, n_colors = _geometry(x, b2, "fused_upsample_s")
    dev, dt, f32 = x.device, x.dtype, torch.float32
    tc32 = dt == torch.float32 and f32_mma_takes(cin, s)
    if dt == torch.bfloat16:  # kept alive until the launch is enqueued
        w0, w2 = _mma_weights(w0, "w0", cin, s, dev), _mma_last_weights(w2, "w2", cin, n_colors, dev)
        pw = [w0.data_ptr(), w2.data_ptr()]
    elif tc32:
        w0 = _f32_weights(w0, "w0", cin, s, dev)
        pw = [w0.data_ptr(), check(w2, "w2", (3, 3, cin, n_colors), dt, dev)]
    else:
        pw = [check(w0, "w0", (3, 3, cin, s * s * cin), dt, dev), check(w2, "w2", (3, 3, cin, n_colors), dt, dev)]
    ptrs = [check(x, "x", (bsz, h, w, cin), dt, dev), pw[0], check(b0, "b0", (s * s * cin,), f32, dev),
            pw[1], check(b2, "b2", (n_colors,), f32, dev)]
    c0 = torch.empty((bsz, s * h, s * w, cin), dtype=dt, device=dev)
    out = torch.empty((bsz, s * h, s * w, n_colors), dtype=dt, device=dev)
    lib = _build.load("upsampler", _SIGNATURES)
    entry = "upsample_s_mma_bf16" if dt == torch.bfloat16 else "upsample_s_mma_f32" if tc32 else "upsample_s_f32"
    status = call(dev, getattr(lib, entry), *ptrs, c0.data_ptr(), out.data_ptr(), bsz, h, w, cin, n_colors, s, STREAM)
    finish("fused_upsample_s", status, entry)
    return out
