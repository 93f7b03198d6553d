"""B5: the attention half of a Swin block (CUDA kernels ``csrc/window_attention_mma.cu``
in bf16 at windows 2 to 16; ``csrc/window_attention.cu`` and ``csrc/window_attention16.cu``
in f32 and at wider heads).

Replaces ``studiosr_tpu/ops/pallas/swin_block.py::fused_window_attention_block``
with ``drop_path``: y = x + d_b * proj(WA(LN x)) on (B, H, W, C) maps, where
WA is window attention over ws x ws windows with the relative-position bias
and ``d_b`` the per-sample drop-path scale (``drop_path`` (B,), already
divided by keep; None means 1). ``shift > 0`` computes the shifted half,
roll(+shift) . half . roll(-shift) with the shifted-window mask of
``ops/windows.py::calculate_mask`` of the rolled map, and returns the output
aligned with the input: the map-level function of ``attention_map_vjp``.

The kernels take square windows of 2 to 16 in two families, split where the
JAX package splits its layouts (the window pair at 2 ws^2 <= 128): windows
2 to 8 (N = ws^2 <= 64 tokens, one 64-row tile a window; SwinIR's 8) count
as ``fused_window_attention_block``, windows 9 to 16 (two to four 64-row
chunks; HAT's 16) as ``fused_window_attention_block_ws16``. A window's
tokens past N pad its last tile: their keys score -inf and their rows are
never stored. Outside the bf16 route below, the small windows run
``csrc/window_attention.cu`` (one window per thread block) and the large
ones ``csrc/window_attention16.cu``: an LN + q|k|v projection pass into a
scratch, then an attention + proj pass per (window, 64-query chunk) with an
online softmax over 64-key chunks. Above 16 (N > 256) no kernel takes the
window and the wrappers raise ``NotImplementedError``.

Operands: ``wqkv`` (C, 3C) with q | k | v column blocks, unscaled (the
kernel applies 1/sqrt(d) to q) and ``wproj`` (C, C), (in, out) layout, cast
to the map's dtype; LayerNorm weights, biases, the gathered (heads, N, N)
rel-pos ``bias`` and ``drop_path`` in bf16 or f32, handed to the kernel in
f32.

Routing, by dtype and geometry, never by a failure: bf16 with a head dim up
to 32 and C a multiple of 4 up to 184 (:func:`mma_takes`) at any window
launches the kernels written for the H100, ``csrc/window_attention_mma.cu``
(C entries ``window_attention_mma_bf16`` for windows 2 to 8,
``window_attention16_mma_bf16`` for 9 to 16); other bf16 geometries and f32
launch ``window_attention_bf16`` / ``window_attention16_bf16`` and the
``_f32`` entries, by the same split. Each launch is counted under its C entry
(``engagement.entries()``). The H100 kernels read the weights packed: dense
weights are gathered on every call by :func:`_fwd_pack_index`'s rule (the
entry gathers them on the card) and a bf16 bias is read as it is, any other
in f32; serving packs once, at load time (:func:`pack_window_attention`:
the blob takes ``wqkv``'s place, ``wproj`` and ``bias`` are None).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from studiosr_tpu_torch.ops.attention import attention_core
from studiosr_tpu_torch.ops.cuda import _build
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, check, finish, operand, stream
from studiosr_tpu_torch.ops.windows import calculate_mask, window_partition, window_reverse

__all__ = [
    "fused_window_attention_block", "window_attention_plain", "check_window_map", "mma_takes", "pack_window_attention",
    "unpack_window_attention", "large_window", "padded_tokens", "KERNEL_WINDOW", "KERNEL_WINDOW16", "KERNEL_WINDOWS",
    "MAX_HEAD_DIM",
]

KERNEL_WINDOW = 8  # csrc/swin_common.cuh SB_WS: one 64-token tile a window, the largest of the small family
KERNEL_WINDOW16 = 16  # csrc/window_attention16.cu: 64-query chunks of a window, the largest of the large family
KERNEL_WINDOWS = tuple(range(2, KERNEL_WINDOW16 + 1))  # the square windows the kernels take
MAX_HEAD_DIM = 64  # csrc/qkv_attention.cuh: one head's q|k|v columns, padded to 16, fit a 64-wide tile
_ARGS = (P, P, I, I, I, I, I, I, I) + (P,) * 8 + (P, ctypes.c_longlong, P)
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
_LL = ctypes.c_longlong
_ARGS_MMA = (P, P) + (I,) * 8 + (P,) * 10 + (_LL, P, _LL, P)
_SIGNATURES_MMA = {
    "window_attention_mma_bf16": _ARGS_MMA,
    "window_attention16_mma_bf16": _ARGS_MMA,
    "window_attention_mma_pack_elems": (I, I),
    "window_attention_mma_scratch": (I,) * 6 + (ctypes.POINTER(_LL),),
}
_RESTYPES_MMA = {"window_attention_mma_pack_elems": _LL}
MMA_MAX_C, MMA_MAX_HEAD_DIM = 184, 32
_NP_WIDTHS = (16, 32, 48, 64, 96, 128, 184)  # csrc/am_common.cuh am_np: the products' widths
_KROWS, _KSTAGE, _TOK = 96, 64, 64  # K rows of a q|k|v stage and of a Wproj stage (AM_KROWS, AM_KSTAGE); a tile


def large_window(window_size: int) -> bool:
    """Whether a window takes the large family (9 to 16: N = ws^2 > 64
    tokens, the JAX package's one-window-a-program layout) rather than the
    small one (2 to 8: the window-pair layout, 2 ws^2 <= 128)."""
    return window_size * window_size > _TOK


def padded_tokens(window_size: int) -> int:
    """A window's tokens padded to whole 64-row tiles, as the H100 kernels lay
    it out (``AmGeom::N`` in csrc/am_window.cuh)."""
    return -(-window_size * window_size // _TOK) * _TOK


def mma_takes(c: int, heads: int) -> bool:
    """Whether the bf16 window-attention kernels written for the H100 (B5 and
    its backward B8 / B9) take this geometry: a head dim up to 32 and C a
    multiple of 4 up to 184."""
    return heads >= 1 and c % heads == 0 and c // heads <= MMA_MAX_HEAD_DIM and c % 4 == 0 and 4 <= c <= MMA_MAX_C


def _pad16(v: int) -> int:
    return (v + 15) // 16 * 16


def _k_major(k, n, rows: int):
    """Element (k, n) of a K-major wgmma operand image with ``rows`` K rows:
    core matrices of 8 n x 8 k (``am_kmajor`` in csrc/am_common.cuh)."""
    return (n // 8) * rows * 8 + (k // 8) * 64 + (n % 8) * 8 + k % 8


def _image(k, n, rows: int, src) -> np.ndarray:
    out = np.empty(k.size, np.int64)
    out[_k_major(k, n, rows).ravel()] = src.ravel()
    return out


@functools.lru_cache(maxsize=None)
def _fwd_pack_index(c: int, heads: int) -> np.ndarray:
    """For each element of the forward's packed weights, its flat index into
    ``cat(wqkv.flatten(), wproj.flatten())`` (wqkv (C, 3C), wproj (C, C)), or
    4 C^2 for a zero. Per head h (d = C / heads, DP = pad16(d), KC =
    pad16(C)), in stages of 96 K rows: its q|k|v columns as B of LN @ Wqkv,
    a K-major image of the stage's rows x 3 DP, column p DP + j =
    wqkv[:, p C + h d + j] (zero for j >= d). Then Wproj as B of attn @
    Wproj (K = heads DP, the attention's columns with each head padded to DP;
    N = the product width NP >= C) in stages of 64 K rows, each a K-major
    image: row h DP + j, column n = wproj[h d + j, n]."""
    d, dp, kc = c // heads, _pad16(c // heads), _pad16(c)
    hd = heads * dp
    npw = next(w for w in _NP_WIDTHS if c <= w)
    zero = 4 * c * c
    parts = []
    for h in range(heads):
        for k0 in range(0, kc, _KROWS):
            rows = min(_KROWS, kc - k0)
            k, n = np.meshgrid(np.arange(rows), np.arange(3 * dp), indexing="ij")
            p, j, r = n // dp, n % dp, k0 + k
            parts.append(_image(k, n, rows, np.where((r < c) & (j < d), r * 3 * c + p * c + h * d + j, zero)))
    for s0 in range(0, hd, _KSTAGE):
        rows = min(_KSTAGE, hd - s0)
        k, n = np.meshgrid(np.arange(rows), np.arange(npw), indexing="ij")
        h, j = (s0 + k) // dp, (s0 + k) % dp
        parts.append(_image(k, n, rows, np.where((j < d) & (n < c), 3 * c * c + (h * d + j) * c + n, zero)))
    return np.concatenate(parts)


@functools.lru_cache(maxsize=None)
def _bias_order(heads: int, ws: int) -> np.ndarray:
    """For each element of the rel-pos bias in the order the attention pass
    reads it, its flat index into the gathered (heads, N, N) bias, N = ws^2,
    followed by a 0 and a -inf (``am_bias_kernel``): the window padded to NP
    = NCH 64 tokens, group ((h NCH + r) NCH + c) 1024 + 128 nt + wt holds the
    score fragment of thread wt of query chunk r, key chunk c, 8-column tile
    nt: (q, col), (q, col + 1), (q + 8, col), (q + 8, col + 1) with q = 64 r
    + 16 (wt / 32) + (wt % 32) / 4 and col = 64 c + 8 nt + 2 (wt % 4); a
    padding key's column (col >= N) is the -inf (index heads N^2 + 1), a
    padding query's row at a real key the 0 (heads N^2)."""
    n, npad = ws * ws, padded_tokens(ws)
    nch = npad // _TOK
    gi = np.arange(heads * npad * npad // 4)
    wt, nt, cc = gi % 128, gi // 128 % 8, gi // 1024 % nch
    r, h = gi // (1024 * nch) % nch, gi // (1024 * nch * nch)
    q, col = _TOK * r + 16 * (wt >> 5) + ((wt & 31) >> 2), _TOK * cc + 8 * nt + 2 * (wt & 3)

    def at(qq, kk):
        return np.where(kk >= n, heads * n * n + 1, np.where(qq >= n, heads * n * n, (h * n + qq) * n + kk))

    return np.stack([at(q, col), at(q, col + 1), at(q + 8, col), at(q + 8, col + 1)], axis=1).ravel()


def pack_window_attention(wqkv: torch.Tensor, wproj: torch.Tensor, bias: torch.Tensor, heads: int) -> torch.Tensor:
    """Dense B5 weights and the gathered (heads, N, N) bias -> the bf16 blob
    the H100 kernels read (what serving prepares once, at load time): the
    weights packed by :func:`_fwd_pack_index`'s rule, then the bias in f32 in
    the attention pass's fragment order (:func:`_bias_order`: -inf at the
    padding keys, 0 at the padding queries), stored bit for bit (two bf16
    elements a value)."""
    c, n = wqkv.shape[0], bias.shape[-1]
    bf = torch.bfloat16
    src = torch.cat([wqkv.detach().to(bf).reshape(-1), wproj.detach().to(bf).reshape(-1), wqkv.new_zeros(1, dtype=bf)])
    weights = src[torch.from_numpy(_fwd_pack_index(c, heads)).to(src.device)]
    order = torch.from_numpy(_bias_order(heads, int(round(n**0.5)))).to(bias.device)
    flat = torch.cat([bias.detach().float().reshape(-1), torch.tensor([0.0, -math.inf], device=bias.device)])
    return torch.cat([weights, flat[order].contiguous().view(bf)])


def unpack_window_attention(blob: torch.Tensor, c: int, heads: int, window_size: int):
    """Inverse of :func:`pack_window_attention`: (wqkv, wproj, bias), the
    weights bf16 and the bias f32."""
    n, npad = window_size * window_size, padded_tokens(window_size)
    index = torch.from_numpy(_fwd_pack_index(c, heads)).to(blob.device)
    if blob.dim() != 1 or blob.dtype != torch.bfloat16 or blob.numel() != index.numel() + 2 * heads * npad * npad:
        raise ValueError(f"packed B5 weights {tuple(blob.shape)} {blob.dtype} do not fit C {c}, {heads} heads, "
                         f"window {window_size}")
    flat = blob.new_zeros(4 * c * c + 1)
    flat[index] = blob[: index.numel()]
    order = torch.from_numpy(_bias_order(heads, window_size)).to(blob.device)
    real = order < heads * n * n  # the padding tokens' 0 and -inf are dropped
    bias = torch.empty(heads * n * n, dtype=torch.float32, device=blob.device)
    bias[order[real]] = blob[index.numel():].view(torch.float32)[real]
    return flat[: 3 * c * c].reshape(c, 3 * c), flat[3 * c * c : 4 * c * c].reshape(c, c), bias.reshape(heads, n, n)


@functools.lru_cache(maxsize=None)
def _device_pack_index(c: int, heads: int, dev: torch.device) -> torch.Tensor:
    """:func:`_fwd_pack_index` as an int32 tensor on ``dev``, for the entry's gather."""
    return torch.from_numpy(_fwd_pack_index(c, heads).astype(np.int32)).to(dev)


def window_attention_plain(
    x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, *, heads: int, window_size: int, shift: int = 0, drop_path=None
):
    """Plain PyTorch version, computed in f32 and returned in ``x.dtype``;
    the weights dense, or packed (``wqkv`` the blob, ``wproj`` and ``bias``
    None)."""
    b, h, w, c = x.shape
    if wproj is None:
        wqkv, wproj, bias = unpack_window_attention(wqkv, c, heads, window_size)
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
    """Raise unless the window kernels (B5, B8 / B9) take this map: a square
    window of 2 to 16 (above 16, N > 256 tokens outgrows the large family's
    shared memory), and at the large windows a head dim up to 64."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if window_size not in KERNEL_WINDOWS:
        raise NotImplementedError(
            f"{name}: the CUDA kernels take window sizes {KERNEL_WINDOWS[0]}-{KERNEL_WINDOWS[-1]}, not {window_size}")
    _, h, w, c = x.shape
    if h % window_size or w % window_size or c % heads or not 0 <= shift < window_size:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, heads {heads}, shift {shift} do not fit")
    if large_window(window_size) and c // heads > MAX_HEAD_DIM:
        raise NotImplementedError(f"{name}: head dim {c // heads} > {MAX_HEAD_DIM}")


def fused_window_attention_block(
    x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, *, heads: int, window_size: int, shift: int = 0, drop_path=None
):
    """(B, H, W, C) -> (B, H, W, C); weights dense, or packed in bf16
    (:func:`pack_window_attention`). CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise. A launch counts under
    ``fused_window_attention_block`` at windows 2 to 8 and under
    ``fused_window_attention_block_ws16`` at 9 to 16 (:func:`large_window`)."""
    kw = dict(heads=heads, window_size=window_size, shift=shift, drop_path=drop_path)
    if x.device.type == "cpu":
        return window_attention_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, **kw)
    check_window_map("fused_window_attention_block", x, heads, window_size, shift)
    bsz, h, w, c = x.shape
    n = window_size * window_size
    dev, dt = x.device, x.dtype
    large = large_window(window_size)
    name = "fused_window_attention_block" + ("_ws16" if large else "")
    if dt == torch.bfloat16 and mma_takes(c, heads):
        return _window_attention_mma(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, heads, window_size, shift,
                                     drop_path, name)
    if wproj is None:
        raise ValueError(f"{name}: packed weights need bf16 and a geometry mma_takes, not {dt}, C {c}, {heads} heads")
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
    suffix = "_bf16" if dt == torch.bfloat16 else "_f32"
    if not large:
        lib = _build.load("window_attention", _SIGNATURES, _RESTYPES)
        pack = lib.window_attention_pack_elems(c, heads)
        packed = torch.empty(pack, dtype=dt, device=dev)
        entry = "window_attention" + suffix
        status = getattr(lib, entry)(px, out.data_ptr(), bsz, h, w, c, heads, window_size, shift, *ptrs,
                                     packed.data_ptr(), pack, stream(dev))
    else:
        lib = _build.load("window_attention16", _SIGNATURES16, _RESTYPES16)
        pack = lib.qkv_attention_pack_elems(c, heads)
        packed = torch.empty(pack, dtype=dt, device=dev)
        qkv = torch.empty(lib.qkv_attention_scratch_elems(bsz * h * w, c, heads), dtype=dt, device=dev)
        entry = "window_attention16" + suffix
        status = getattr(lib, entry)(px, out.data_ptr(), bsz, h, w, c, heads, window_size, shift, *ptrs,
                                     qkv.data_ptr(), packed.data_ptr(), pack, stream(dev))
    finish(name, status, entry)
    return out


def _window_attention_mma(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, heads, window_size, shift, drop_path, name):
    """The launch of ``csrc/window_attention_mma.cu`` (bf16, :func:`mma_takes`)
    on dense weights (gathered by the entry) or on the serving blob."""
    bsz, h, w, c = x.shape
    n, npad = window_size * window_size, padded_tokens(window_size)
    dev, f32 = x.device, torch.float32
    lib = _build.load("window_attention_mma", _SIGNATURES_MMA, _RESTYPES_MMA)
    index = _device_pack_index(c, heads, dev)
    if lib.window_attention_mma_pack_elems(c, heads) != index.numel():
        raise RuntimeError(f"{name}: the packed weights of C {c}, {heads} heads disagree with the kernel's layout")
    dp = None if drop_path is None else operand(drop_path, "drop_path", (bsz,), f32, dev)
    vectors = [operand(t, k, (m * c,), f32, dev) for t, k, m in ((ln_w, "ln_w", 1), (ln_b, "ln_b", 1),
                                                                  (bqkv, "bqkv", 3), (bproj, "bproj", 1))]
    if wproj is None:  # the serving blob: the weights, then the bias in fragment order
        if bias is not None:
            raise ValueError(f"{name}: with packed weights wproj and bias are None")
        blob = check(wqkv, "packed weights", (index.numel() + 2 * heads * npad * npad,), torch.bfloat16, dev)
        dense, bias16 = [None, None, None, None], 0
    else:
        blob = None
        # a bf16 bias (the bf16 step's) is read as it is
        bias_dt = torch.bfloat16 if getattr(bias, "dtype", None) == torch.bfloat16 else f32
        dense = [operand(bias, "bias", (heads, n, n), bias_dt, dev), operand(wqkv, "wqkv", (c, 3 * c), x.dtype, dev),
                 operand(wproj, "wproj", (c, c), x.dtype, dev), index]
        bias16 = int(bias_dt == torch.bfloat16)
    px = check(x, "x", (bsz, h, w, c), x.dtype, dev)
    t_elems = _LL()
    status = lib.window_attention_mma_scratch(bsz, h, w, c, heads, window_size, ctypes.byref(t_elems))
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} while sizing the scratch")
    tscratch = torch.empty(t_elems.value, dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(x)
    entry = "window_attention16_mma_bf16" if large_window(window_size) else "window_attention_mma_bf16"
    # the entry's order: ln_w, ln_b, bqkv, bproj, bias, drop_path, wqkv, wproj, the pack index
    ptrs = [None if t is None else t.data_ptr() for t in (*vectors, dense[0], dp, *dense[1:])]
    status = getattr(lib, entry)(px, out.data_ptr(), bsz, h, w, c, heads, window_size, shift, bias16, *ptrs, blob,
                                 index.numel(), tscratch.data_ptr(), t_elems.value, stream(dev))
    finish(name, status, entry)
    return out
