"""B5: the attention half of a Swin block (CUDA kernel ``csrc/window_attention.cu``).

Replaces ``studiosr_tpu/ops/pallas/swin_block.py::fused_window_attention_block``
with ``drop_path``: y = x + d_b * proj(WA(LN x)) on (B, H, W, C) maps, where
WA is window attention over ws x ws windows with the relative-position bias
and ``d_b`` the per-sample drop-path scale (``drop_path`` (B,), already
divided by keep; None means 1). ``shift > 0`` computes the shifted half,
roll(+shift) . half . roll(-shift) with the shifted-window mask of
``ops/windows.py::calculate_mask`` of the rolled map, and returns the output
aligned with the input: the map-level function of ``attention_map_vjp``.

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

__all__ = ["fused_window_attention_block", "window_attention_plain", "check_window_map", "KERNEL_WINDOW"]

KERNEL_WINDOW = 8  # csrc/swin_common.cuh SB_WS: one 64-token window per thread block
_ARGS = (P, P, I, I, I, I, I, I) + (P,) * 8 + (P, ctypes.c_longlong, P)
_SIGNATURES = {
    "window_attention_f32": _ARGS,
    "window_attention_bf16": _ARGS,
    "window_attention_pack_elems": (I, I),
}
_RESTYPES = {"window_attention_pack_elems": ctypes.c_longlong}


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


def check_window_map(name: str, x: torch.Tensor, heads: int, window_size: int, shift: int) -> None:
    """Raise unless the window kernels (B5, B8) take this map."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if window_size != KERNEL_WINDOW:
        raise NotImplementedError(f"{name}: the CUDA kernel takes window size {KERNEL_WINDOW}, not {window_size}")
    _, h, w, c = x.shape
    if h % window_size or w % window_size or c % heads or not 0 <= shift < window_size:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, heads {heads}, shift {shift} do not fit")


def fused_window_attention_block(
    x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, *, heads: int, window_size: int, shift: int = 0, drop_path=None
):
    """(B, H, W, C) -> (B, H, W, C). CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    kw = dict(heads=heads, window_size=window_size, shift=shift, drop_path=drop_path)
    if x.device.type == "cpu":
        return window_attention_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, **kw)
    check_window_map("fused_window_attention_block", x, heads, window_size, shift)
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
    px = check(x, "x", (bsz, h, w, c), dt, dev)
    out = torch.empty_like(x)
    lib = _build.load("window_attention", _SIGNATURES, _RESTYPES)
    pack = lib.window_attention_pack_elems(c, heads)
    packed = torch.empty(pack, dtype=dt, device=dev)
    fn = lib.window_attention_bf16 if dt == torch.bfloat16 else lib.window_attention_f32
    ln_w_, ln_b_, wqkv_, bqkv_, wproj_, bproj_, bias_, dp_ = ops
    status = fn(
        px, out.data_ptr(), bsz, h, w, c, heads, shift, ln_w_.data_ptr(), ln_b_.data_ptr(), wqkv_.data_ptr(),
        bqkv_.data_ptr(), wproj_.data_ptr(), bproj_.data_ptr(), bias_.data_ptr(),
        None if dp_ is None else dp_.data_ptr(), packed.data_ptr(), pack, stream(dev),
    )
    finish("fused_window_attention_block", status)
    return out
