"""B5: the attention half of a Swin block (CUDA kernels ``csrc/window_attention_mma.cu``
in bf16 at every window; ``csrc/window_attention_f32.cu`` in f32 at windows 2 to 16;
``csrc/window_attention.cu`` and ``csrc/window_attention16.cu`` at wider heads and in
f32 from window 17).

Replaces ``studiosr_tpu/ops/pallas/swin_block.py::fused_window_attention_block``
with ``drop_path``: y = x + d_b * proj(WA(LN x)) on (B, H, W, C) maps, where
WA is window attention over ws x ws windows with the relative-position bias
and ``d_b`` the per-sample drop-path scale (``drop_path`` (B,), already
divided by keep; None means 1). ``shift > 0`` computes the shifted half,
roll(+shift) . half . roll(-shift) with the shifted-window mask of
``ops/windows.py::calculate_mask`` of the rolled map, and returns the output
aligned with the input: the map-level function of ``attention_map_vjp``.

The kernels take square windows from 2 up in three families
(:func:`window_family`): windows 2 to 8 (N = ws^2 <= 64 tokens, one 64-row
tile a window; SwinIR's 8; the JAX package's window pair at 2 ws^2 <= 128)
count as ``fused_window_attention_block``, windows 9 to 16 (two to four
64-row chunks; HAT's 16) as ``fused_window_attention_block_ws16``, and
windows from 17 (five chunks and more, the key chunks streamed; SwinIR at
24, MaxSR adaptive above a 256 x 256 crop) as
``fused_window_attention_block_large``. A window's tokens past N pad its
last tile: their keys score -inf and their rows are never stored. Outside
the bf16 route below, the small windows run ``csrc/window_attention.cu``
(one window per thread block) and the others ``csrc/window_attention16.cu``:
an LN + q|k|v projection pass into a scratch, then an attention + proj pass
per (window, 64-query chunk) with an online softmax over 64-key chunks.
Above :data:`KERNEL_WINDOW_MAX` the gathered (heads, N, N) f32 bias alone
outgrows the card (16 GiB a head at 256) and the wrappers raise
``NotImplementedError`` before any launch.

Operands: ``wqkv`` (C, 3C) with q | k | v column blocks, unscaled (the
kernel applies 1/sqrt(d) to q) and ``wproj`` (C, C), (in, out) layout, cast
to the map's dtype; LayerNorm weights, biases, the gathered (heads, N, N)
rel-pos ``bias`` and ``drop_path`` in bf16 or f32, handed to the kernel in
f32.

Routing, by dtype and geometry, never by a failure: bf16 with a head dim up
to 32 and C a multiple of 4 up to 184 (:func:`mma_takes`) at any window
launches the kernels written for the H100, ``csrc/window_attention_mma.cu``
(C entries ``window_attention_mma_bf16`` for windows 2 to 8,
``window_attention16_mma_bf16`` for 9 to 16, ``window_attention_large_mma_bf16``
from 17); f32 at windows 2 to 16 with a head dim up to 32 and C a multiple
of 4 up to 256 (:func:`f32_mma_takes`: SwinFIR's recipe, HAT's f32 step and
forward at window 16, and every f32 width the paths train) launches
``csrc/window_attention_f32.cu`` (``window_attention_mma_f32`` at windows 2
to 8, ``window_attention16_mma_f32`` at 9 to 16 with the attention pass of
``csrc/tf_window16.cuh``: every product in 3xTF32 on the tensor cores, the
row products on wgmma, the weights packed and split per call by
:func:`_f32_fwd_pack_index`'s rule); other bf16 geometries and f32 launch
``window_attention_bf16`` / ``window_attention16_bf16`` /
``window_attention_large_bf16`` and the ``_f32`` entries, by the same split.
Each launch is counted under its C entry (``engagement.entries()``). The
bf16 H100 kernels read the weights packed: dense weights are gathered on
every call by :func:`_fwd_pack_index`'s rule (the entry gathers them on the
card) and a bf16 bias is read as it is, any other in f32; serving packs
once, at load time (:func:`pack_window_attention`: the blob takes
``wqkv``'s place, ``wproj`` and ``bias`` are None).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from studiosr_tpu_torch.ops.attention import attention_core
from studiosr_tpu_torch.ops.cuda import _build, tf32x3
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, aligned, check, finish, operand, STREAM, call
from studiosr_tpu_torch.ops.windows import calculate_mask, window_partition, window_reverse

__all__ = [
    "fused_window_attention_block", "window_attention_plain", "check_window_map", "mma_takes", "pack_window_attention",
    "unpack_window_attention", "large_window", "window_family", "padded_tokens", "f32_mma_takes",
    "pack_window_attention_f32_weights", "KERNEL_WINDOW", "KERNEL_WINDOW16", "KERNEL_WINDOW_MAX", "KERNEL_WINDOWS",
    "MAX_HEAD_DIM", "F32_FIRST_MAX_C", "FIRST_MAX_C", "FAMILY_STEM", "first_design_max_c",
]

KERNEL_WINDOW = 8  # csrc/swin_common.cuh SB_WS: one 64-token tile a window, the largest of the small family
KERNEL_WINDOW16 = 16  # csrc/window_attention16.cu: 64-query chunks of a window, the largest of the 9-16 family
KERNEL_WINDOW_MAX = 256  # N = 65,536: the gathered (heads, N, N) f32 bias is 16 GiB a head
KERNEL_WINDOWS = range(2, KERNEL_WINDOW_MAX + 1)  # the square windows the kernels take
# a family's C entries: window_attention{stem}_..., attn_bwd{stem}_...
FAMILY_STEM = {"": "", "_ws16": "16", "_large": "_large"}
MAX_HEAD_DIM = 64  # csrc/qkv_attention.cuh: one head's q|k|v columns, padded to 16, fit a 64-wide tile
SMEM_LIMIT = 232_448  # bytes of shared memory a block may hold on the H100 (227 KB)


def _first_design_smem(c: int, dp: int, dtype: torch.dtype) -> int:
    """Bytes of shared memory of the largest pass of the older kernels from
    window 9 (B5: ``window_attention16.cu``, B9: ``attn_bwd16.cu``) at C
    ``c`` and heads padded to ``dp`` columns, mirroring their layout
    functions: ``ln_qkv_smem_layout``, ``qa_smem_layout`` (f32) /
    ``qa_mma_smem_layout`` (bf16) in csrc/qkv_attention.cuh,
    ``ab16_gb_smem`` and ``ab16_ln_smem_layout`` in csrc/attn_bwd16.cu."""
    tsz = 4 if dtype == torch.float32 else 2
    a32 = lambda v: (v + 31) // 32 * 32  # noqa: E731
    tok, ldc, staging = 64, (c + 31) // 32 * 32 + 8, 2 * 32 * 72 * tsz  # SB_TOK, pad32(C) + SB_SKEW, staging_bytes
    rows = a32(tok * ldc * tsz) + staging  # ln_qkv and ab16_gb: 64 rows of C and the weights' two stages
    if dtype == torch.float32:
        lq, o = dp + 16 // tsz, 0
        for n in (tok * lq * tsz, 2 * tok * lq * tsz, 2 * tok * lq * tsz, tok * 68 * 4, tok * (dp + 4) * 4,
                  tok * 4, tok * 4, tok * 4, tok * 4, tok * ldc * tsz):  # q, k, v, scores, o, m, l, cr, rid, attn
            o = a32(o + n)
        attn = max(o, staging)  # proj's staging lies over q, k and v
    else:
        o = a32(8 * tok * (dp + 8) * 2)  # k and v: two buffers x two head groups
        attn = a32(a32(o + tok * 4) + tok * ldc * 2) + staging
    ln_bwd = a32(a32(a32(a32(tok * c * 4) + tok * 4) + tok * 4) + 2 * tok * 40 * tsz) + staging  # dln, mean, rstd, A
    return max(rows, attn, ln_bwd)


def first_design_max_c(dtype: torch.dtype) -> int:
    """The widest C whose every first-design pass at windows from 9 fits a
    block's shared memory at every head dim up to :data:`MAX_HEAD_DIM`."""
    return max(c for c in range(4, 4096, 4) if _first_design_smem(c, _pad16(MAX_HEAD_DIM), dtype) <= SMEM_LIMIT)


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
    "window_attention_large_f32": _ARGS16,
    "window_attention_large_bf16": _ARGS16,
    "qkv_attention_pack_elems": (I, I),
    "qkv_attention_scratch_elems": (I, I, I),
}
_RESTYPES16 = {"qkv_attention_pack_elems": ctypes.c_longlong, "qkv_attention_scratch_elems": ctypes.c_longlong}
_LL = ctypes.c_longlong
_ARGS_MMA = (P, P) + (I,) * 8 + (P,) * 10 + (_LL, P, _LL, P)
_SIGNATURES_MMA = {
    "window_attention_mma_bf16": _ARGS_MMA,
    "window_attention16_mma_bf16": _ARGS_MMA,
    "window_attention_large_mma_bf16": _ARGS_MMA,
    "window_attention_mma_pack_elems": (I, I),
    "window_attention_mma_scratch": (I,) * 6 + (ctypes.POINTER(_LL),),
}
_RESTYPES_MMA = {"window_attention_mma_pack_elems": _LL}
_ARGS_F32 = (P, P) + (I,) * 7 + (P,) * 9 + (_LL, P, _LL, P)
_SIGNATURES_F32 = {
    "window_attention_mma_f32": _ARGS_F32,
    "window_attention16_mma_f32": _ARGS_F32,
    "window_attention_mma_f32_scratch": (I,) * 6 + (ctypes.POINTER(_LL),),
    "window_attention_mma_f32_pack_elems": (I, I),
}
_RESTYPES_F32 = {"window_attention_mma_f32_pack_elems": _LL}
MMA_MAX_C, MMA_MAX_HEAD_DIM = 184, 32
F32_MAX_C = 256  # csrc/tf32x3.cuh TF_MAX_C
_NP_WIDTHS = (16, 32, 48, 64, 96, 128, 184)  # csrc/am_common.cuh am_np: the products' widths
_KROWS, _KSTAGE, _TOK = 96, 64, 64  # K rows of a q|k|v stage and of a Wproj stage (AM_KROWS, AM_KSTAGE); a tile


def large_window(window_size: int) -> bool:
    """Whether a window spans more than one 64-token tile (from 9: N = ws^2
    > 64, the JAX package's one-window-a-program layout) rather than one
    (2 to 8: the window-pair layout, 2 ws^2 <= 128)."""
    return window_size * window_size > _TOK


def window_family(window_size: int) -> str:
    """The suffix the launches of a window count under: "" at 2 to 8 (one
    tile), "_ws16" at 9 to 16 (two to four tiles), "_large" from 17 (five
    tiles and more, the key and query chunks streamed)."""
    return "_large" if window_size > KERNEL_WINDOW16 else "_ws16" if large_window(window_size) else ""


def padded_tokens(window_size: int) -> int:
    """A window's tokens padded to whole 64-row tiles, as the H100 kernels lay
    it out (``AmGeom::N`` in csrc/am_window.cuh)."""
    return -(-window_size * window_size // _TOK) * _TOK


def mma_takes(c: int, heads: int) -> bool:
    """Whether the bf16 window-attention kernels written for the H100 (B5 and
    its backward B8 / B9) take this geometry: a head dim up to 32 and C a
    multiple of 4 up to 184."""
    return heads >= 1 and c % heads == 0 and c // heads <= MMA_MAX_HEAD_DIM and c % 4 == 0 and 4 <= c <= MMA_MAX_C


def f32_mma_takes(c: int, heads: int, window_size: int) -> bool:
    """Whether the f32 kernels written for the H100 (B5 in f32 and its
    backward B8 / B9) take this geometry: windows 2 to 16 (one to four
    64-token tiles; the entries ``_mma_f32`` at 2 to 8 and ``16_mma_f32`` at
    9 to 16), C a multiple of 4 up to 256, a head dim up to 32
    (``tf_window_ok`` and ``tf_window16_ok`` in csrc/tf32x3.cuh)."""
    return (2 <= window_size <= KERNEL_WINDOW16 and c % 4 == 0 and 4 <= c <= F32_MAX_C and heads >= 1
            and c % heads == 0 and c // heads <= 32)


def _pad16(v: int) -> int:
    return (v + 15) // 16 * 16


# the first design's widest C at windows from 9, a dtype: 416 in f32, where
# the attention pass's 64 attn rows and one head's q, k, v, scores and output
# (at head dim 64) bound it
FIRST_MAX_C = {dt: first_design_max_c(dt) for dt in KERNEL_DTYPES}
F32_FIRST_MAX_C = FIRST_MAX_C[torch.float32]


def f32_wqkv_index(c: int, heads: int) -> np.ndarray:
    """Wqkv of the f32 kernels' q|k|v product (C x 3 HD, each head padded
    from d = C / heads to DP = pad16(d) columns, HD = heads DP): element [r,
    p HD + h DP + j] is the flat index of wqkv[r, p C + h d + j] into
    ``cat(wqkv.flatten(), wproj.flatten())``, or 4 C^2 (a zero) for j >= d."""
    d, dp = c // heads, _pad16(c // heads)
    hd = heads * dp
    col = np.arange(3 * hd)
    p, h, j = col // hd, (col % hd) // dp, col % dp
    src = np.where(j < d, p * c + h * d + j, -1)  # wqkv's column of each padded column
    return np.where(src[None] >= 0, np.arange(c)[:, None] * 3 * c + src[None], 4 * c * c)


def _f32_products(c: int, heads: int) -> list:
    """(K, N) of B5 f32's row products: q|k|v = LN Wqkv (C x 3 HD) and y =
    attn Wproj (HD x C), HD = heads pad16(d)."""
    hd = heads * _pad16(c // heads)
    return [(c, 3 * hd), (hd, c)]


@functools.lru_cache(maxsize=None)
def _f32_fwd_pack_index(c: int, heads: int) -> np.ndarray:
    """For each hi value of B5 f32's packed weights, its flat index into
    ``cat(wqkv.flatten(), wproj.flatten())`` (wqkv (C, 3C), wproj (C, C)), or
    4 C^2 for a zero: :func:`f32_wqkv_index`'s Wqkv, then Wproj (HD x C, [h
    DP + j, n] = wproj[h d + j, n], zero for j >= d), each in ``tfw_pack``'s
    image order (``tf32x3.tfw_image_index``)."""
    d, dp = c // heads, _pad16(c // heads)
    zero = 4 * c * c
    row = np.arange(heads * dp)
    h, j = row // dp, row % dp
    wp = np.where((j < d)[:, None], 3 * c * c + (h * d + j)[:, None] * c + np.arange(c)[None], zero)
    return np.concatenate([tf32x3.tfw_image_index(m, zero) for m in (f32_wqkv_index(c, heads), wp)])


def pack_window_attention_f32_weights(wqkv: torch.Tensor, wproj: torch.Tensor, heads: int) -> torch.Tensor:
    """B5 f32's packed weights (f32): the values :func:`_f32_fwd_pack_index`
    gathers, each stage block as its hi then its lo image
    (``tf32x3.pack_images``); the entry packs the same on the card on every
    call, this is its plain version."""
    c = wqkv.shape[0]
    src = torch.cat([wqkv.reshape(-1), wproj.to(wqkv.dtype).reshape(-1), wqkv.new_zeros(1)]).float()
    return tf32x3.pack_images(src[torch.from_numpy(_f32_fwd_pack_index(c, heads)).to(src.device)],
                              _f32_products(c, heads))


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
def _device_pack_index(c: int, heads: int, dev: torch.device, f32: bool = False) -> torch.Tensor:
    """:func:`_fwd_pack_index` (``f32``: :func:`_f32_fwd_pack_index`) as an
    int32 tensor on ``dev``, for the entry's gather."""
    index = _f32_fwd_pack_index(c, heads) if f32 else _fwd_pack_index(c, heads)
    return torch.from_numpy(index.astype(np.int32)).to(dev)


def window_attention_plain(
    x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, *, heads: int, window_size: int, shift: int = 0, drop_path=None,
    mm=torch.matmul,
):
    """Plain PyTorch version, computed in f32 and returned in ``x.dtype``;
    the weights dense, or packed (``wqkv`` the blob, ``wproj`` and ``bias``
    None). ``mm`` takes each product (``tf32x3.matmul`` repeats the f32
    kernel's arithmetic)."""
    b, h, w, c = x.shape
    if wproj is None:
        wqkv, wproj, bias = unpack_window_attention(wqkv, c, heads, window_size)
    ws = window_size
    n = ws * ws
    d = c // heads
    xf = x.float()
    z = torch.roll(xf, (-shift, -shift), dims=(1, 2)) if shift else xf
    ln = F.layer_norm(z, (c,), ln_w.float(), ln_b.float(), 1e-5)
    qkv = mm(window_partition(ln, ws).reshape(-1, n, c), wqkv.float()) + bqkv.float()
    qkv = qkv.reshape(-1, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    mask = torch.from_numpy(calculate_mask((h, w), ws, shift)).to(x.device) if shift else None
    attn = attention_core(qkv[0] * d**-0.5, qkv[1], qkv[2], bias=bias.float(), mask=mask, mm=mm)
    attn = mm(attn.transpose(1, 2).reshape(-1, n, c), wproj.float()) + bproj.float()
    delta = window_reverse(attn.reshape(-1, ws, ws, c), ws, h, w)
    if shift:
        delta = torch.roll(delta, (shift, shift), dims=(1, 2))
    if drop_path is not None:
        delta = delta * drop_path.float().reshape(-1, 1, 1, 1)
    return (xf + delta).to(x.dtype)


def check_window_map(name: str, x: torch.Tensor, heads: int, window_size: int, shift: int) -> None:
    """Raise unless the window kernels (B5, B8 / B9) take this map: a square
    window of 2 to :data:`KERNEL_WINDOW_MAX` (above it the gathered f32 bias
    alone outgrows the card's memory), and above window 8 a head dim up to
    64 and, where the kernels written for the H100 decline, C up to
    :data:`FIRST_MAX_C` of the dtype (:func:`first_design_max_c`)."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if window_size not in KERNEL_WINDOWS:
        raise NotImplementedError(
            f"{name}: the CUDA kernels take window sizes {KERNEL_WINDOWS[0]}-{KERNEL_WINDOWS[-1]}, not {window_size} "
            f"(the (heads, N, N) f32 bias of a larger window outgrows device memory)")
    _, h, w, c = x.shape
    if h % window_size or w % window_size or c % heads or not 0 <= shift < window_size:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, heads {heads}, shift {shift} do not fit")
    if large_window(window_size) and c // heads > MAX_HEAD_DIM:
        raise NotImplementedError(f"{name}: head dim {c // heads} > {MAX_HEAD_DIM}")
    takes = mma_takes(c, heads) if x.dtype == torch.bfloat16 else f32_mma_takes(c, heads, window_size)
    limit = F32_FIRST_MAX_C if x.dtype == torch.float32 else FIRST_MAX_C[x.dtype]
    if large_window(window_size) and not takes and c > limit:
        kernels = (f"the bf16 kernels take head dims up to {MMA_MAX_HEAD_DIM} at C up to {MMA_MAX_C}" if x.dtype == torch.bfloat16 else
                   f"the 3xTF32 kernels take head dims up to 32 at C up to {F32_MAX_C} and windows up to "
                   f"{KERNEL_WINDOW16}")
        raise NotImplementedError(
            f"{name}: {str(x.dtype)[6:]} at window {window_size}, C {c}, {heads} heads: {kernels}, the older kernels "
            f"C up to {limit} (the shared memory of their passes, first_design_max_c)")


def fused_window_attention_block(
    x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, *, heads: int, window_size: int, shift: int = 0, drop_path=None
):
    """(B, H, W, C) -> (B, H, W, C); weights dense, or packed in bf16
    (:func:`pack_window_attention`). CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise. A launch counts under
    ``fused_window_attention_block`` at windows 2 to 8, under
    ``fused_window_attention_block_ws16`` at 9 to 16 and under
    ``fused_window_attention_block_large`` from 17 (:func:`window_family`)."""
    kw = dict(heads=heads, window_size=window_size, shift=shift, drop_path=drop_path)
    if x.device.type == "cpu":
        return window_attention_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, **kw)
    check_window_map("fused_window_attention_block", x, heads, window_size, shift)
    bsz, h, w, c = x.shape
    n = window_size * window_size
    dev, dt = x.device, x.dtype
    large, family = large_window(window_size), window_family(window_size)
    name = "fused_window_attention_block" + family
    if dt == torch.bfloat16 and mma_takes(c, heads):
        return _window_attention_mma(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, heads, window_size, shift,
                                     drop_path, name)
    if wproj is None:
        raise ValueError(f"{name}: packed weights need bf16 and a geometry mma_takes, not {dt}, C {c}, {heads} heads")
    if dt == torch.float32 and f32_mma_takes(c, heads, window_size):
        return _window_attention_f32(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, heads, window_size, shift,
                                     drop_path, name)
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
    entry = "window_attention" + FAMILY_STEM[family] + ("_bf16" if dt == torch.bfloat16 else "_f32")
    if not large:
        lib = _build.load("window_attention", _SIGNATURES, _RESTYPES)
        pack = call(dev, lib.window_attention_pack_elems, c, heads)
        packed = torch.empty(pack, dtype=dt, device=dev)
        status = call(dev, getattr(lib, entry), px, out.data_ptr(), bsz, h, w, c, heads, window_size, shift, *ptrs,
                      packed.data_ptr(), pack, STREAM)
    else:
        lib = _build.load("window_attention16", _SIGNATURES16, _RESTYPES16)
        pack = call(dev, lib.qkv_attention_pack_elems, c, heads)
        packed = torch.empty(pack, dtype=dt, device=dev)
        qkv = torch.empty(call(dev, lib.qkv_attention_scratch_elems, bsz * h * w, c, heads), dtype=dt, device=dev)
        status = call(dev, getattr(lib, entry), px, out.data_ptr(), bsz, h, w, c, heads, window_size, shift, *ptrs,
                      qkv.data_ptr(), packed.data_ptr(), pack, STREAM)
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
    if call(dev, lib.window_attention_mma_pack_elems, c, heads) != index.numel():
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
    status = call(dev, lib.window_attention_mma_scratch, bsz, h, w, c, heads, window_size, ctypes.byref(t_elems))
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} while sizing the scratch")
    tscratch = torch.empty(t_elems.value, dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(x)
    entry = "window_attention" + FAMILY_STEM[window_family(window_size)] + "_mma_bf16"
    # the entry's order: ln_w, ln_b, bqkv, bproj, bias, drop_path, wqkv, wproj, the pack index
    ptrs = [None if t is None else t.data_ptr() for t in (*vectors, dense[0], dp, *dense[1:])]
    status = call(dev, getattr(lib, entry), px, out.data_ptr(), bsz, h, w, c, heads, window_size, shift, bias16, *ptrs,
                  blob, index.numel(), tscratch.data_ptr(), t_elems.value, STREAM)
    finish(name, status, entry)
    return out


def _window_attention_f32(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, heads, window_size, shift, drop_path,
                          name):
    """The launch of ``csrc/window_attention_f32.cu`` (f32,
    :func:`f32_mma_takes`; ``window_attention_mma_f32`` at windows 2 to 8,
    ``window_attention16_mma_f32`` at 9 to 16) on dense weights, packed and
    split by the entry."""
    bsz, h, w, c = x.shape
    n, dev, f32 = window_size * window_size, x.device, torch.float32
    lib = _build.load("window_attention_f32", _SIGNATURES_F32, _RESTYPES_F32)
    index = _device_pack_index(c, heads, dev, True)
    if call(dev, lib.window_attention_mma_f32_pack_elems, c, heads) != index.numel():
        raise RuntimeError(f"{name}: the f32 packed weights of C {c}, {heads} heads disagree with the kernel's layout")
    # the entry reads ln_w and ln_b four values at a time: 16-byte aligned copies
    ops = [aligned(operand(ln_w, "ln_w", (c,), f32, dev)), aligned(operand(ln_b, "ln_b", (c,), f32, dev)),
           operand(bqkv, "bqkv", (3 * c,), f32, dev), operand(bproj, "bproj", (c,), f32, dev),
           operand(bias, "bias", (heads, n, n), f32, dev),
           None if drop_path is None else operand(drop_path, "drop_path", (bsz,), f32, dev),
           operand(wqkv, "wqkv", (c, 3 * c), f32, dev), operand(wproj, "wproj", (c, c), f32, dev), index]
    check(x, "x", (bsz, h, w, c), f32, dev)
    xa = aligned(x)
    f_elems = _LL()
    status = call(dev, lib.window_attention_mma_f32_scratch, bsz, h, w, c, heads, window_size, ctypes.byref(f_elems))
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} while sizing the scratch")
    fscratch = torch.empty(f_elems.value, dtype=f32, device=dev)
    out = torch.empty_like(xa)
    entry = "window_attention" + FAMILY_STEM[window_family(window_size)] + "_mma_f32"
    status = call(dev, getattr(lib, entry), xa.data_ptr(), out.data_ptr(), bsz, h, w, c, heads, window_size, shift,
                  *[None if t is None else t.data_ptr() for t in ops], index.numel(), fscratch.data_ptr(),
                  f_elems.value, STREAM)
    finish(name, status, entry)
    return out
