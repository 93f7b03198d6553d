"""B10: HAT's overlapping cross-attention block (CUDA kernels ``csrc/ocab_mma.cu`` in bf16,
``csrc/ocab_f32.cu`` in f32, ``csrc/ocab.cu`` at other geometries).

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
map's dtype; LayerNorm weights and biases in bf16 or f32, handed to the
kernels in f32; the gathered (heads, ws^2, owin^2) rel-pos ``bias``.

The map's sides are multiples of the window and the key window's margin
is even (owin = ws + 2 pad): anything else raises ``ValueError``. Every
such window from 2 is taken; a window whose ws^2 tokens are not a multiple
of 64 is padded to whole 64-token tiles inside the kernels (rows that are
never stored).

Routing, by dtype and geometry, never by a failure: bf16 where
:func:`ocab_mma_takes` the geometry (a head dim up to 32, C a multiple of 4
up to 184, a hidden width up to 384, any window) launches the kernels
written for the H100, ``csrc/ocab_mma.cu`` (C entry ``ocab_mma_bf16``;
above 576 keys a window its attention pass streams the keys). They read q|k|v, proj, fc1 and fc2 as one packed
blob (:func:`pack_ocab_block`: HAT serving packs it once, at load time, and
the blob takes ``wqkv``'s place, ``wproj``, ``w1`` and ``w2`` None; dense
weights are packed on every call) and the bias in bf16, rounded as the JAX
package's kernel rounds it to the map's dtype. f32 where
:func:`ocab_f32_mma_takes` the geometry (a head dim up to 32, C a multiple
of 4 up to 256, up to 256 queries and 576 keys a window, a hidden width up
to 512: HAT's windows up to 16) launches the 3xTF32 kernels written for the
H100, ``csrc/ocab_f32.cu`` (C entry ``ocab_mma_f32``), on dense weights the
entry packs per call and the bias in f32. Other bf16 and f32 geometries
launch ``ocab_bf16`` / ``ocab_f32`` (``csrc/ocab.cu``) on dense weights with
the bias in f32. Each launch is counted under its C entry
(``engagement.entries()``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from studiosr_tpu_torch.ops.attention import attention_core
from studiosr_tpu_torch.ops.cuda import _build
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, aligned, check, finish, operand, STREAM, call
from studiosr_tpu_torch.ops.cuda.mlp_block import (
    _device_pack_index as _mlp_device_pack_index, _mma_pack_index, f32_mma_takes as mlp_f32_mma_takes,
    mma_takes as mlp_mma_takes, pack_mlp_block, unpack_mlp_block,
)
from studiosr_tpu_torch.ops.cuda.oca_core import _kmajor_tiles
from studiosr_tpu_torch.ops.cuda.window_attention import (
    MAX_HEAD_DIM, _device_pack_index as _attn_device_pack_index, _fwd_pack_index, mma_takes,
)
from studiosr_tpu_torch.ops.windows import window_partition, window_reverse

__all__ = [
    "fused_ocab_block", "ocab_plain", "overlap_window", "ocab_mma_takes", "pack_ocab_block", "unpack_ocab_block",
    "packed_ocab_elems", "pack_key_images", "ocab_f32_mma_takes", "ocab_f32_partition",
]

_LL = ctypes.c_longlong
_ARGS = (P, P, I, I, I, I, I, I, I, I) + (P,) * 13 + (P, P, P, _LL, P)
_SIGNATURES = {
    "ocab_f32": _ARGS,
    "ocab_bf16": _ARGS,
    "ocab_pack_elems": (I, I, I),
    "qkv_attention_scratch_elems": (I, I, I),
}
_RESTYPES = {"ocab_pack_elems": _LL, "qkv_attention_scratch_elems": _LL}
_SIGNATURES_MMA = {
    "ocab_mma_bf16": (P, P) + (I,) * 8 + (P,) * 10 + (_LL, P, _LL, P),
    "ocab_mma_pack_elems": (I, I, I),
    "ocab_mma_scratch": (I,) * 8 + (ctypes.POINTER(_LL),),
}
_RESTYPES_MMA = {"ocab_mma_pack_elems": _LL}
_SIGNATURES_F32 = {
    "ocab_mma_f32": (P, P) + (I,) * 8 + (P,) * 13 + (P, _LL, P, _LL, P, _LL, P),
    "ocab_mma_f32_pack_elems": (I,) * 5,
    "ocab_mma_f32_scratch": (I,) * 8,
}
_RESTYPES_F32 = {"ocab_mma_f32_pack_elems": _LL, "ocab_mma_f32_scratch": _LL}
# csrc/ocab_f32.cu: queries a slab (a block), keys a chunk, the most queries and keys a window
_F32_SLAB, _F32_TOK, _F32_MAX_NQ, _F32_MAX_NK = 128, 64, 256, 576


def overlap_window(window_size: int, overlap_ratio: float):
    """(owin, pad): the key window's side and its margin around the query window."""
    owin = int(window_size * overlap_ratio) + window_size
    return owin, (owin - window_size) // 2


def ocab_mma_takes(c: int, heads: int, window_size: int, overlap_ratio: float, hidden: int) -> bool:
    """Whether the bf16 kernels written for the H100 take this geometry: a
    head dim up to 32 and C a multiple of 4 up to 184 (B5's q|k|v and
    projection), a window from 2 with an even key margin (B12's attention
    pass, streaming above 576 keys), a hidden width up to 384 (B6's MLP)."""
    owin, pad = overlap_window(window_size, overlap_ratio)
    return (window_size >= 2 and owin == window_size + 2 * pad and mma_takes(c, heads)
            and mlp_mma_takes(c, hidden))


def ocab_f32_mma_takes(c: int, heads: int, window_size: int, overlap_ratio: float, hidden: int) -> bool:
    """Whether the f32 kernels written for the H100 (``ocab_mma_f32``) take
    this geometry: a window from 2 with an even key margin, up to 256
    queries and 576 keys (HAT's windows up to 16 at overlap 0.5), a head dim
    up to 32 and C a multiple of 4 up to 256 (the attention pass's DP 16 or
    32, the row passes), a hidden width up to 512 (B6 f32's MLP)."""
    owin, pad = overlap_window(window_size, overlap_ratio)
    return (window_size >= 2 and owin == window_size + 2 * pad and window_size ** 2 <= _F32_MAX_NQ
            and owin ** 2 <= _F32_MAX_NK and heads >= 1 and c % heads == 0 and c // heads <= 32
            and mlp_f32_mma_takes(c, hidden))


def ocab_f32_partition(windows: int, heads: int, window_size: int, overlap_ratio: float):
    """The f32 attention pass's blocks in launch order: block i owns (window
    i // (heads SL), head i // SL % heads, queries 128 s .. 128 s + 127 of
    the window, s = i % SL), SL = ceil(ws^2 / 128), and walks the owin^2
    keys in ceil(owin^2 / 64) chunks. Returns [(window, head, q0, q1,
    chunks)], q1 clipped to ws^2."""
    owin, _ = overlap_window(window_size, overlap_ratio)
    nq, nk = window_size ** 2, owin ** 2
    sl, kt = -(-nq // _F32_SLAB), -(-nk // _F32_TOK)
    return [(i // (heads * sl), i // sl % heads, i % sl * _F32_SLAB, min(i % sl * _F32_SLAB + _F32_SLAB, nq), kt)
            for i in range(windows * heads * sl)]


def packed_ocab_elems(c: int, heads: int, hidden: int) -> int:
    """Elements of :func:`pack_ocab_block`'s blob."""
    return _fwd_pack_index(c, heads).size + _mma_pack_index(c, hidden).size


def pack_ocab_block(wqkv: torch.Tensor, wproj: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """Dense B10 weights -> the bf16 blob the H100 kernels stream (what
    serving prepares once, at load time): q|k|v and Wproj packed by
    ``window_attention._fwd_pack_index``'s rule (B5's layout), then fc1 and
    fc2 by ``mlp_block._mma_pack_index``'s (B6's)."""
    c, hidden = wqkv.shape[0], w1.shape[-1]
    if (tuple(wqkv.shape) != (c, 3 * c) or tuple(wproj.shape) != (c, c) or tuple(w1.shape) != (c, hidden)
            or tuple(w2.shape) != (hidden, c)):
        raise ValueError(f"pack_ocab_block: wqkv {tuple(wqkv.shape)}, wproj {tuple(wproj.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)} do not fit")
    bf = torch.bfloat16
    src = torch.cat([wqkv.detach().to(bf).reshape(-1), wproj.detach().to(bf).reshape(-1), wqkv.new_zeros(1, dtype=bf)])
    attn = src[torch.from_numpy(_fwd_pack_index(c, heads)).to(src.device)]
    return torch.cat([attn, pack_mlp_block(w1.detach().to(bf), w2.detach().to(bf))])


def unpack_ocab_block(blob: torch.Tensor, c: int, heads: int, hidden: int):
    """(wqkv, wproj, w1, w2) back from :func:`pack_ocab_block`'s blob."""
    index = _fwd_pack_index(c, heads)
    if blob.dim() != 1 or blob.dtype != torch.bfloat16 or blob.numel() != packed_ocab_elems(c, heads, hidden):
        raise ValueError(f"packed B10 weights {tuple(blob.shape)} {blob.dtype} do not fit C {c}, {heads} heads, "
                         f"hidden {hidden}")
    flat = blob.new_zeros(4 * c * c + 1)
    flat[torch.from_numpy(index).to(blob.device)] = blob[: index.size]
    w1, w2 = unpack_mlp_block(blob[index.size:], c, hidden)
    return flat[: 3 * c * c].reshape(c, 3 * c), flat[3 * c * c : 4 * c * c].reshape(c, c), w1, w2


def pack_key_images(k, v, window_size: int, overlap_ratio: float) -> torch.Tensor:
    """Plain version of the H100 kernels' pass 2 (``oc_gather_kernel``): k
    and v, (B, H, W, heads, d) maps after the projection, -> per (window,
    head) unit, windows in row-major order over the batch, the owin x owin
    keys around the window in ceil(owin^2 / 64) chunks of 64, k's then v's,
    laid out as B12's key images (``oca_core.pack_fwd_images``: k K-major in
    d, v K-major in the keys, position p of a chunk holding its key 16 ((p %
    8) // 2) + 2 (p // 8) + p % 2, DP 16 at d <= 16, else 32), zero where a
    key lies outside the image, past owin^2 and past d. Returns (windows *
    heads, elements) in k's dtype."""
    b, h, w, heads, d = k.shape
    ws = window_size
    owin, pad = overlap_window(ws, overlap_ratio)
    nk, dp = owin * owin, 16 if d <= 16 else 32

    def key_windows(t):  # (windows, heads, nk, d), zero outside the image
        t = F.pad(t.reshape(b, h, w, heads * d), (0, 0, pad, pad, pad, pad)).unfold(1, owin, ws).unfold(2, owin, ws)
        return t.permute(0, 1, 2, 4, 5, 3).reshape(-1, nk, heads, d).transpose(1, 2)

    return torch.cat([_kmajor_tiles(key_windows(k), nk, dp, permuted=True),
                      _kmajor_tiles(key_windows(v), nk, dp, token_major=True, permuted=True)], 1)


def ocab_plain(
    x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2,
    *, heads: int, window_size: int, overlap_ratio: float, mm=torch.matmul,
):
    """Plain PyTorch version, computed in f32 and returned in ``x.dtype``;
    the weights dense, or packed (``wqkv`` the blob, ``wproj``, ``w1`` and
    ``w2`` None). ``mm`` takes each product (``tf32x3.matmul`` repeats the
    f32 kernels' 3xTF32 arithmetic)."""
    b, h, w, c = x.shape
    if wproj is None:
        wqkv, wproj, w1, w2 = unpack_ocab_block(wqkv, c, heads, b1.numel())
    ws = window_size
    owin, pad = overlap_window(ws, overlap_ratio)
    d = c // heads
    xf = x.float()
    qkv = mm(F.layer_norm(xf, (c,), ln1_w.float(), ln1_b.float(), 1e-5), wqkv.float()) + bqkv.float()
    q, kv = qkv[..., :c], qkv[..., c:]
    q = window_partition(q, ws).reshape(-1, ws * ws, heads, d).transpose(1, 2) * d**-0.5
    kv = F.pad(kv, (0, 0, pad, pad, pad, pad)).unfold(1, owin, ws).unfold(2, owin, ws)
    kv = kv.permute(0, 1, 2, 4, 5, 3).reshape(-1, owin * owin, 2, heads, d)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    out = attention_core(q, k, v, bias=bias.float(), mm=mm).transpose(1, 2).reshape(-1, ws, ws, c)
    y = xf + mm(window_reverse(out, ws, h, w), wproj.float()) + bproj.float()
    hid = F.gelu(mm(F.layer_norm(y, (c,), ln2_w.float(), ln2_b.float(), 1e-5), w1.float()) + b1.float())
    return (y + mm(hid, w2.float()) + b2.float()).to(x.dtype)


def fused_ocab_block(
    x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2,
    *, heads: int, window_size: int, overlap_ratio: float,
):
    """(B, H, W, C) -> (B, H, W, C); weights dense, or packed in bf16
    (:func:`pack_ocab_block`). CPU tensors take the plain version; CUDA
    tensors launch the kernels or raise."""
    kw = dict(heads=heads, window_size=window_size, overlap_ratio=overlap_ratio)
    if x.device.type == "cpu":
        return ocab_plain(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2, **kw)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_ocab_block: unsupported dtype {x.dtype}")
    bsz, h, w, c = x.shape
    ws = window_size
    owin, pad = overlap_window(ws, overlap_ratio)
    if h % ws or w % ws or c % heads or owin != ws + 2 * pad:
        raise ValueError(f"fused_ocab_block: shape {tuple(x.shape)}, heads {heads}, window {ws}, key window {owin} "
                         "do not fit")
    hidden = b1.numel()
    if x.dtype == torch.bfloat16 and ocab_mma_takes(c, heads, ws, overlap_ratio, hidden):
        return _ocab_mma(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2, heads, ws, pad)
    if wproj is None:
        raise ValueError(f"fused_ocab_block: packed weights need bf16 and a geometry ocab_mma_takes, not {x.dtype}, "
                         f"C {c}, {heads} heads, window {ws}, key window {owin}, hidden {hidden}")
    if x.dtype == torch.float32 and ocab_f32_mma_takes(c, heads, ws, overlap_ratio, hidden):
        return _ocab_f32(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2, heads, ws, pad)
    if c // heads > MAX_HEAD_DIM:
        raise NotImplementedError(f"fused_ocab_block: head dim {c // heads} > {MAX_HEAD_DIM}")
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
    pack = call(dev, lib.ocab_pack_elems, c, heads, hidden)
    packed = torch.empty(pack, dtype=dt, device=dev)
    qkv = torch.empty(call(dev, lib.qkv_attention_scratch_elems, bsz * h * w, c, heads), dtype=dt, device=dev)
    entry = "ocab_bf16" if dt == torch.bfloat16 else "ocab_f32"
    status = call(dev, getattr(lib, entry), px, out.data_ptr(), bsz, h, w, c, heads, ws, pad, hidden,
                  *[t.data_ptr() for t in ops], qkv.data_ptr(), y.data_ptr(), packed.data_ptr(), pack, STREAM)
    finish("fused_ocab_block", status, entry)
    return out


def _ocab_mma(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2, heads, ws, pad):
    """The launch of ``csrc/ocab_mma.cu`` (bf16, :func:`ocab_mma_takes`) on
    the serving blob or on dense weights, packed here."""
    bsz, h, w, c = x.shape
    hidden = b1.numel()
    owin = ws + 2 * pad
    dev, f32, bf = x.device, torch.float32, torch.bfloat16
    lib = _build.load("ocab_mma", _SIGNATURES_MMA, _RESTYPES_MMA)
    pack = packed_ocab_elems(c, heads, hidden)
    if call(dev, lib.ocab_mma_pack_elems, c, heads, hidden) != pack:
        raise RuntimeError(f"fused_ocab_block: the packed weights of C {c}, {heads} heads, hidden {hidden} disagree "
                           "with the kernel's layout")
    if wproj is None:  # the serving blob
        if w1 is not None or w2 is not None:
            raise ValueError("fused_ocab_block: with packed weights wproj, w1 and w2 are None")
        blob = wqkv
    else:
        blob = pack_ocab_block(wqkv, wproj, w1, w2, heads)
    pblob = check(blob, "packed weights", (pack,), bf, dev)
    if pblob % 16:
        raise ValueError("fused_ocab_block: the packed weights must lie on a 16-byte boundary")
    # the kernel reads every operand during the launch; keep each converted copy alive until then
    ops = [operand(t, name, (n,), f32, dev) for t, name, n in (
        (ln1_w, "ln1_w", c), (ln1_b, "ln1_b", c), (bqkv, "bqkv", 3 * c), (bproj, "bproj", c))]
    ops.append(operand(bias, "bias", (heads, ws * ws, owin * owin), bf, dev))
    ops += [operand(t, name, (n,), f32, dev) for t, name, n in (
        (ln2_w, "ln2_w", c), (ln2_b, "ln2_b", c), (b1, "b1", hidden), (b2, "b2", c))]
    px = check(x, "x", (bsz, h, w, c), bf, dev)
    t_elems = _LL()
    status = call(dev, lib.ocab_mma_scratch, bsz, h, w, c, heads, ws, pad, hidden, ctypes.byref(t_elems))
    if status != 0:
        raise RuntimeError(f"fused_ocab_block: CUDA error {status} while sizing the scratch")
    tscratch = torch.empty(t_elems.value, dtype=bf, device=dev)
    out = torch.empty_like(x)
    status = call(dev, lib.ocab_mma_bf16, px, out.data_ptr(), bsz, h, w, c, heads, ws, pad, hidden,
                  *[t.data_ptr() for t in ops], pblob, pack, tscratch.data_ptr(), t_elems.value, STREAM)
    finish("fused_ocab_block", status, "ocab_mma_bf16")
    return out


def _ocab_f32(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2, heads, ws, pad):
    """The launch of ``csrc/ocab_f32.cu`` (f32, :func:`ocab_f32_mma_takes`) on
    dense weights, packed and split by the entry (B5 f32's and B6 f32's
    index tables)."""
    bsz, h, w, c = x.shape
    hidden = b1.numel()
    owin = ws + 2 * pad
    dev, f32 = x.device, torch.float32
    lib = _build.load("ocab_f32", _SIGNATURES_F32, _RESTYPES_F32)
    attn_index = _attn_device_pack_index(c, heads, dev, True)
    mlp_index = _mlp_device_pack_index(c, hidden, dev, True)
    if call(dev, lib.ocab_mma_f32_pack_elems, c, heads, ws, pad, hidden) != attn_index.numel():
        raise RuntimeError(f"fused_ocab_block: the f32 packed weights of C {c}, {heads} heads disagree with the "
                           "kernel's layout")
    # the kernels read x and the LayerNorm weights four values at a time: 16-byte aligned copies
    vec = lambda t, name, n: aligned(operand(t, name, (n,), f32, dev))  # noqa: E731
    ops = [vec(ln1_w, "ln1_w", c), vec(ln1_b, "ln1_b", c), vec(bqkv, "bqkv", 3 * c), vec(bproj, "bproj", c),
           aligned(operand(bias, "bias", (heads, ws * ws, owin * owin), f32, dev)),
           vec(ln2_w, "ln2_w", c), vec(ln2_b, "ln2_b", c), vec(b1, "b1", hidden), vec(b2, "b2", c),
           operand(wqkv, "wqkv", (c, 3 * c), f32, dev), operand(wproj, "wproj", (c, c), f32, dev),
           operand(w1, "w1", (c, hidden), f32, dev), operand(w2, "w2", (hidden, c), f32, dev)]
    check(x, "x", (bsz, h, w, c), f32, dev)
    xa = aligned(x)
    f_elems = call(dev, lib.ocab_mma_f32_scratch, bsz, h, w, c, heads, ws, pad, hidden)
    fscratch = torch.empty(f_elems, dtype=f32, device=dev)
    out = torch.empty_like(xa)
    status = call(dev, lib.ocab_mma_f32, xa.data_ptr(), out.data_ptr(), bsz, h, w, c, heads, ws, pad, hidden,
                  *[t.data_ptr() for t in ops], attn_index.data_ptr(), attn_index.numel(), mlp_index.data_ptr(),
                  mlp_index.numel(), fscratch.data_ptr(), f_elems, STREAM)
    finish("fused_ocab_block", status, "ocab_mma_f32")
    return out
