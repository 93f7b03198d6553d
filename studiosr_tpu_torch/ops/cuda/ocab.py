"""B10: HAT's overlapping cross-attention block (CUDA kernels ``csrc/ocab.cu``).

Replaces ``studiosr_tpu/ops/pallas/ocab.py::fused_ocab_block``. On (B, H, W,
C) maps:

    u = LN1 x;  q from each ws x ws window of u Wq, k and v from the
    (ws + 2 pad)^2 window around it of the zero-padded map u Wk, u Wv
    (pad = (int(ws * overlap_ratio) + ws - ws) / 2);
    y = x + proj(softmax(q k^T / sqrt(d) + bias) v);
    out = y + fc2(gelu(fc1(LN2 y))).

Keys and values outside the image are zero after the projection, as the
reference's zero-padded unfold makes them: their logits are the bias alone
and they take softmax mass. They are not masked.

Operands: ``wqkv`` (C, 3C) with q | k | v column blocks, unscaled, ``wproj``
(C, C), ``w1`` (C, hidden), ``w2`` (hidden, C), (in, out) layout, in the
map's dtype; LayerNorm weights, biases and the gathered (heads, ws^2,
owin^2) rel-pos ``bias`` in bf16 or f32, handed to the kernels in f32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from studiosr_tpu_torch.ops.attention import attention_core
from studiosr_tpu_torch.ops.cuda import _build
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, check, finish, operand, stream
from studiosr_tpu_torch.ops.cuda.window_attention import MAX_HEAD_DIM
from studiosr_tpu_torch.ops.windows import window_partition, window_reverse

__all__ = ["fused_ocab_block", "ocab_plain", "overlap_window"]

_LL = ctypes.c_longlong
_ARGS = (P, P, I, I, I, I, I, I, I, I) + (P,) * 13 + (P, P, P, _LL, P)
_SIGNATURES = {
    "ocab_f32": _ARGS,
    "ocab_bf16": _ARGS,
    "ocab_pack_elems": (I, I, I),
    "qkv_attention_scratch_elems": (I, I, I),
}
_RESTYPES = {"ocab_pack_elems": _LL, "qkv_attention_scratch_elems": _LL}


def overlap_window(window_size: int, overlap_ratio: float):
    """(owin, pad): the key window's side and its margin around the query window."""
    owin = int(window_size * overlap_ratio) + window_size
    return owin, (owin - window_size) // 2


def ocab_plain(
    x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2,
    *, heads: int, window_size: int, overlap_ratio: float,
):
    """Plain PyTorch version, computed in f32 and returned in ``x.dtype``."""
    b, h, w, c = x.shape
    ws = window_size
    owin, pad = overlap_window(ws, overlap_ratio)
    d = c // heads
    xf = x.float()
    qkv = F.layer_norm(xf, (c,), ln1_w.float(), ln1_b.float(), 1e-5) @ wqkv.float() + bqkv.float()
    q, kv = qkv[..., :c], qkv[..., c:]
    q = window_partition(q, ws).reshape(-1, ws * ws, heads, d).transpose(1, 2) * d**-0.5
    kv = F.pad(kv, (0, 0, pad, pad, pad, pad)).unfold(1, owin, ws).unfold(2, owin, ws)
    kv = kv.permute(0, 1, 2, 4, 5, 3).reshape(-1, owin * owin, 2, heads, d)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    out = attention_core(q, k, v, bias=bias.float()).transpose(1, 2).reshape(-1, ws, ws, c)
    y = xf + window_reverse(out, ws, h, w) @ wproj.float() + bproj.float()
    hid = F.gelu(F.layer_norm(y, (c,), ln2_w.float(), ln2_b.float(), 1e-5) @ w1.float() + b1.float())
    return (y + hid @ w2.float() + b2.float()).to(x.dtype)


def fused_ocab_block(
    x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2,
    *, heads: int, window_size: int, overlap_ratio: float,
):
    """(B, H, W, C) -> (B, H, W, C). CPU tensors take the plain version;
    CUDA tensors launch the kernels or raise."""
    kw = dict(heads=heads, window_size=window_size, overlap_ratio=overlap_ratio)
    if x.device.type == "cpu":
        return ocab_plain(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2, **kw)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_ocab_block: unsupported dtype {x.dtype}")
    bsz, h, w, c = x.shape
    ws = window_size
    owin, pad = overlap_window(ws, overlap_ratio)
    if h % ws or w % ws or (ws * ws) % 64 or c % heads:
        raise ValueError(f"fused_ocab_block: shape {tuple(x.shape)}, heads {heads}, window {ws} do not fit")
    if c // heads > MAX_HEAD_DIM:
        raise NotImplementedError(f"fused_ocab_block: head dim {c // heads} > {MAX_HEAD_DIM}")
    hidden = w1.shape[-1]
    dev, dt, f32 = x.device, x.dtype, torch.float32
    ops = [
        operand(ln1_w, "ln1_w", (c,), f32, dev), operand(ln1_b, "ln1_b", (c,), f32, dev),
        operand(wqkv, "wqkv", (c, 3 * c), dt, dev), operand(bqkv, "bqkv", (3 * c,), f32, dev),
        operand(wproj, "wproj", (c, c), dt, dev), operand(bproj, "bproj", (c,), f32, dev),
        operand(bias, "bias", (heads, ws * ws, owin * owin), f32, dev),
        operand(ln2_w, "ln2_w", (c,), f32, dev), operand(ln2_b, "ln2_b", (c,), f32, dev),
        operand(w1, "w1", (c, hidden), dt, dev), operand(b1, "b1", (hidden,), f32, dev),
        operand(w2, "w2", (hidden, c), dt, dev), operand(b2, "b2", (c,), f32, dev),
    ]
    px = check(x, "x", (bsz, h, w, c), dt, dev)
    out = torch.empty_like(x)
    y = torch.empty_like(x)
    lib = _build.load("ocab", _SIGNATURES, _RESTYPES)
    pack = lib.ocab_pack_elems(c, heads, hidden)
    packed = torch.empty(pack, dtype=dt, device=dev)
    qkv = torch.empty(lib.qkv_attention_scratch_elems(bsz * h * w, c, heads), dtype=dt, device=dev)
    fn = lib.ocab_bf16 if dt == torch.bfloat16 else lib.ocab_f32
    status = fn(px, out.data_ptr(), bsz, h, w, c, heads, ws, pad, hidden, *[t.data_ptr() for t in ops],
                qkv.data_ptr(), y.data_ptr(), packed.data_ptr(), pack, stream(dev))
    finish("fused_ocab_block", status)
    return out
