"""B5: the attention half of a Swin block (CUDA kernel ``csrc/window_attention.cu``).

Replaces ``studiosr_tpu/ops/pallas/swin_block.py::fused_window_attention_block``
with ``drop_path``: y = x + d_b * proj(WA(LN x)) on (B, H, W, C) maps, where
WA is window attention over ws x ws windows with the relative-position bias
and ``d_b`` the per-sample drop-path scale (``drop_path`` (B,), already
divided by keep; None means 1). ``shift > 0`` computes the shifted half,
roll(+shift) . half . roll(-shift) with the shifted-window mask of
``ops/windows.py::calculate_mask`` of the rolled map, and returns the output
aligned with the input: the map-level function of ``attention_map_vjp``.

Window size 8 runs ``csrc/window_attention.cu`` (one 64-token window per
thread block). Window size 16 (HAT) runs ``csrc/window_attention16.cu``:
an LN + q|k|v projection pass into a scratch, then an attention + proj
pass per (window, 64-query chunk) with an online softmax over 64-key
chunks; its launches count as ``fused_window_attention_block_ws16``.

Operands: ``wqkv`` (C, 3C) with q | k | v column blocks, unscaled (the
kernel applies 1/sqrt(d) to q) and ``wproj`` (C, C), (in, out) layout, cast
to the map's dtype; LayerNorm weights, biases, the gathered (heads, N, N)
rel-pos ``bias`` and ``drop_path`` in bf16 or f32, handed to the kernel in
f32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from studiosr_tpu_torch.ops.attention import attention_core
from studiosr_tpu_torch.ops.cuda import _build
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, check, finish, operand, stream
from studiosr_tpu_torch.ops.windows import calculate_mask, window_partition, window_reverse

__all__ = [
    "fused_window_attention_block", "window_attention_plain", "check_window_map", "KERNEL_WINDOW", "KERNEL_WINDOW16",
    "MAX_HEAD_DIM",
]

KERNEL_WINDOW = 8  # csrc/swin_common.cuh SB_WS: one 64-token window per thread block
KERNEL_WINDOW16 = 16  # csrc/window_attention16.cu: 64-query chunks of a 256-token window
MAX_HEAD_DIM = 64  # csrc/qkv_attention.cuh: one head's q|k|v columns, padded to 16, fit a 64-wide tile
_ARGS = (P, P, I, I, I, I, I, I) + (P,) * 8 + (P, ctypes.c_longlong, P)
_SIGNATURES = {
    "window_attention_f32": _ARGS,
    "window_attention_bf16": _ARGS,
    "window_attention_pack_elems": (I, I),
}
_RESTYPES = {"window_attention_pack_elems": ctypes.c_longlong}
_ARGS16 = (P, P, I, I, I, I, I, I, I) + (P,) * 8 + (P, P, ctypes.c_longlong, P)
_SIGNATURES16 = {
    "window_attention16_f32": _ARGS16,
    "window_attention16_bf16": _ARGS16,
    "qkv_attention_pack_elems": (I, I),
    "qkv_attention_scratch_elems": (I, I, I),
}
_RESTYPES16 = {"qkv_attention_pack_elems": ctypes.c_longlong, "qkv_attention_scratch_elems": ctypes.c_longlong}


def window_attention_plain(
    x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, *, heads: int, window_size: int, shift: int = 0, drop_path=None
):
    """Plain PyTorch version, computed in f32 and returned in ``x.dtype``."""
    b, h, w, c = x.shape
    ws = window_size
    n = ws * ws
    d = c // heads
    xf = x.float()
    z = torch.roll(xf, (-shift, -shift), dims=(1, 2)) if shift else xf
    ln = F.layer_norm(z, (c,), ln_w.float(), ln_b.float(), 1e-5)
    qkv = window_partition(ln, ws).reshape(-1, n, c) @ wqkv.float() + bqkv.float()
    qkv = qkv.reshape(-1, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    mask = torch.from_numpy(calculate_mask((h, w), ws, shift)).to(x.device) if shift else None
    attn = attention_core(qkv[0] * d**-0.5, qkv[1], qkv[2], bias=bias.float(), mask=mask)
    attn = attn.transpose(1, 2).reshape(-1, n, c) @ wproj.float() + bproj.float()
    delta = window_reverse(attn.reshape(-1, ws, ws, c), ws, h, w)
    if shift:
        delta = torch.roll(delta, (shift, shift), dims=(1, 2))
    if drop_path is not None:
        delta = delta * drop_path.float().reshape(-1, 1, 1, 1)
    return (xf + delta).to(x.dtype)


def check_window_map(
    name: str, x: torch.Tensor, heads: int, window_size: int, shift: int, windows=(KERNEL_WINDOW,)
) -> None:
    """Raise unless the window kernels (B5 at ``windows``, B8) take this map."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if window_size not in windows:
        raise NotImplementedError(f"{name}: the CUDA kernels take window sizes {windows}, not {window_size}")
    _, h, w, c = x.shape
    if h % window_size or w % window_size or c % heads or not 0 <= shift < window_size:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, heads {heads}, shift {shift} do not fit")
    if window_size != KERNEL_WINDOW and c // heads > MAX_HEAD_DIM:
        raise NotImplementedError(f"{name}: head dim {c // heads} > {MAX_HEAD_DIM}")


def fused_window_attention_block(
    x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, *, heads: int, window_size: int, shift: int = 0, drop_path=None
):
    """(B, H, W, C) -> (B, H, W, C). CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    kw = dict(heads=heads, window_size=window_size, shift=shift, drop_path=drop_path)
    if x.device.type == "cpu":
        return window_attention_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, **kw)
    check_window_map("fused_window_attention_block", x, heads, window_size, shift, (KERNEL_WINDOW, KERNEL_WINDOW16))
    bsz, h, w, c = x.shape
    n = window_size * window_size
    dev, dt = x.device, x.dtype
    # the kernel reads every operand during the launch; keep each converted copy alive until then
    ops = [
        operand(ln_w, "ln_w", (c,), torch.float32, dev), operand(ln_b, "ln_b", (c,), torch.float32, dev),
        operand(wqkv, "wqkv", (c, 3 * c), dt, dev), operand(bqkv, "bqkv", (3 * c,), torch.float32, dev),
        operand(wproj, "wproj", (c, c), dt, dev), operand(bproj, "bproj", (c,), torch.float32, dev),
        operand(bias, "bias", (heads, n, n), torch.float32, dev),
        None if drop_path is None else operand(drop_path, "drop_path", (bsz,), torch.float32, dev),
    ]
    ptrs = [None if t is None else t.data_ptr() for t in ops]
    px = check(x, "x", (bsz, h, w, c), dt, dev)
    out = torch.empty_like(x)
    bf16 = dt == torch.bfloat16
    if window_size == KERNEL_WINDOW:
        lib = _build.load("window_attention", _SIGNATURES, _RESTYPES)
        pack = lib.window_attention_pack_elems(c, heads)
        packed = torch.empty(pack, dtype=dt, device=dev)
        fn = lib.window_attention_bf16 if bf16 else lib.window_attention_f32
        status = fn(px, out.data_ptr(), bsz, h, w, c, heads, shift, *ptrs, packed.data_ptr(), pack, stream(dev))
        finish("fused_window_attention_block", status)
    else:
        lib = _build.load("window_attention16", _SIGNATURES16, _RESTYPES16)
        pack = lib.qkv_attention_pack_elems(c, heads)
        packed = torch.empty(pack, dtype=dt, device=dev)
        qkv = torch.empty(lib.qkv_attention_scratch_elems(bsz * h * w, c, heads), dtype=dt, device=dev)
        fn = lib.window_attention16_bf16 if bf16 else lib.window_attention16_f32
        status = fn(px, out.data_ptr(), bsz, h, w, c, heads, window_size, shift, *ptrs, qkv.data_ptr(),
                    packed.data_ptr(), pack, stream(dev))
        finish("fused_window_attention_block_ws16", status)
    return out
