"""B1: the whole Swin block in one pass (CUDA kernel ``csrc/swin_block.cu``).

Replaces ``studiosr_tpu/ops/pallas/swin_block.py::fused_swin_block``:
z = x + proj(WA(LN1 x)), y = z + fc2(gelu(fc1(LN2 z))) over ws x ws windows
with the relative-position bias. ``shift > 0`` computes the shifted block,
roll(+shift) . block . roll(-shift) with the shifted-window mask of
``ops/windows.py::calculate_mask``, and returns the output aligned with the
input (the JAX kernel's ``read_shift`` leaves it in the rolled space).

Operands: ``x`` (B, H, W, C); LayerNorm weights and every bias f32; dense
weights in (in, out) layout in the map's dtype (``wqkv`` (C, 3C) with
q | k | v column blocks, unscaled: the kernel applies 1/sqrt(d) to q);
``bias`` the gathered (heads, N, N) f32 rel-pos bias. The HAT/training
operands of the TPU kernel (``extra``, ``extra_scale``, ``drop_path``) are
not part of this port.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from studiosr_tpu_torch.ops.attention import attention_core
from studiosr_tpu_torch.ops.cuda import _build
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, check, finish, stream
from studiosr_tpu_torch.ops.windows import calculate_mask, window_partition, window_reverse

__all__ = ["fused_swin_block", "swin_block_plain", "packed_elements", "KERNEL_WINDOW"]

KERNEL_WINDOW = 8  # csrc/swin_block.cu SB_WS: one 64-token window per thread block
_ARGS = (P, P, I, I, I, I, I, I, I) + (P,) * 13 + (P, ctypes.c_longlong, P)
_SIGNATURES = {"swin_block_f32": _ARGS, "swin_block_bf16": _ARGS}


def packed_elements(c: int, heads: int, hidden: int) -> int:
    """Elements of the scratch the kernel packs its weights into: the
    ``SwinPack`` layout of ``csrc/swin_block.cu`` (the kernel checks it)."""

    def pad(v: int, m: int) -> int:
        return -(-v // m) * m

    kc, kh = pad(c, 32), pad(hidden, 32)
    nq, nc, nh = pad(3 * pad(c // heads, 16), 64), pad(c, 64), pad(hidden, 64)
    return heads * kc * nq + kc * nc + kc * nh + kh * nc


def swin_block_plain(
    x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2,
    *, heads: int, window_size: int, shift: int = 0,
):
    """Plain PyTorch version, computed in f32 and returned in ``x.dtype``."""
    b, h, w, c = x.shape
    ws = window_size
    n = ws * ws
    d = c // heads
    xf = x.float()
    if shift:
        xf = torch.roll(xf, (-shift, -shift), dims=(1, 2))
    ln = F.layer_norm(xf, (c,), ln1_w.float(), ln1_b.float(), 1e-5)
    qkv = window_partition(ln, ws).reshape(-1, n, c) @ wqkv.float() + bqkv.float()
    qkv = qkv.reshape(-1, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    mask = torch.from_numpy(calculate_mask((h, w), ws, shift)).to(x.device) if shift else None
    attn = attention_core(qkv[0] * d**-0.5, qkv[1], qkv[2], bias=bias.float(), mask=mask)
    attn = attn.transpose(1, 2).reshape(-1, n, c) @ wproj.float() + bproj.float()
    z = xf + window_reverse(attn.reshape(-1, ws, ws, c), ws, h, w)
    hidden = F.gelu(F.layer_norm(z, (c,), ln2_w.float(), ln2_b.float(), 1e-5) @ w1.float() + b1.float())
    y = z + (hidden @ w2.float() + b2.float())
    if shift:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    return y.to(x.dtype)


def fused_swin_block(
    x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2,
    *, heads: int, window_size: int, shift: int = 0,
):
    """(B, H, W, C) -> (B, H, W, C). CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    args = (x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return swin_block_plain(*args, heads=heads, window_size=window_size, shift=shift)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_swin_block: unsupported dtype {x.dtype}")
    bsz, h, w, c = x.shape
    ws = window_size
    if ws != KERNEL_WINDOW:
        raise NotImplementedError(f"fused_swin_block: the CUDA kernel takes window size {KERNEL_WINDOW}, not {ws}")
    if h % ws or w % ws or c % heads or not 0 <= shift < ws:
        raise ValueError(f"fused_swin_block: shape {tuple(x.shape)}, heads {heads}, shift {shift} do not fit")
    hidden = w1.shape[-1]
    n = ws * ws
    dev, dt, f32 = x.device, x.dtype, torch.float32
    ptrs = [
        check(ln1_w, "ln1_w", (c,), f32, dev), check(ln1_b, "ln1_b", (c,), f32, dev),
        check(wqkv, "wqkv", (c, 3 * c), dt, dev), check(bqkv, "bqkv", (3 * c,), f32, dev),
        check(wproj, "wproj", (c, c), dt, dev), check(bproj, "bproj", (c,), f32, dev),
        check(bias, "bias", (heads, n, n), f32, dev),
        check(ln2_w, "ln2_w", (c,), f32, dev), check(ln2_b, "ln2_b", (c,), f32, dev),
        check(w1, "w1", (c, hidden), dt, dev), check(b1, "b1", (hidden,), f32, dev),
        check(w2, "w2", (hidden, c), dt, dev), check(b2, "b2", (c,), f32, dev),
    ]
    px = check(x, "x", (bsz, h, w, c), dt, dev)
    out = torch.empty_like(x)
    pack = packed_elements(c, heads, hidden)
    packed = torch.empty(pack, dtype=dt, device=dev)
    lib = _build.load("swin_block", _SIGNATURES)
    fn = lib.swin_block_bf16 if dt == torch.bfloat16 else lib.swin_block_f32
    status = fn(px, out.data_ptr(), bsz, h, w, c, heads, hidden, shift, *ptrs, packed.data_ptr(), pack, stream(dev))
    finish("fused_swin_block", status)
    return out
