"""B12 and B13: the OCAB cross-attention core, forward and backward (CUDA kernels ``csrc/oca_core.cu``;
B13 in bf16 ``csrc/oca_bwd_mma.cu``).

Replaces ``studiosr_tpu/ops/pallas/oca_core.py::oca_core_fwd`` (B12) and
``::oca_core_bwd`` (B13). On q (bw, heads, nq, d), already scaled by
1/sqrt(d), k and v (bw, heads, nk, d) and the (heads, nq, nk) logit bias:

    out = softmax(q k^T + bias) v;
    (dq, dk, dv, d bias) for the cotangent g of out, d bias summed over the
    bw windows, in f32.

q, k, v (and g) are f32 or bf16, one dtype, any strided view whose last
dimension is contiguous (the OCAB's transposed views reach the kernel
without a copy); the bias is handed to the kernel in f32. Outputs come back
as transposed views of (bw, tokens, heads, d) tensors, the layout the OCAB
reads them in. The kernels take head dims up to 64 and at most 256 queries
a window (the backward keeps a (nq, 64) f32 d bias tile in shared memory).

Routing of B13, by dtype and geometry, never by a failure: bf16 with a head
dim up to 32, at most 256 queries and 576 keys (:func:`mma_takes`) launches
the kernel written for the H100, ``csrc/oca_bwd_mma.cu`` (C entry
``oca_core_bwd_mma_bf16``): a pass that packs q, g, k and v into wgmma's
K-major 64-token tiles (:func:`pack_images` is its plain version), the row
statistics, then p, dscores and the sums per (head, key chunk, group of
windows) (:func:`main_partition` mirrors the blocks' partition). Other bf16
geometries and f32 launch ``oca_core_bwd_bf16`` / ``_f32``. Each launch is
counted under its C entry (``engagement.entries()``).
"""

from __future__ import annotations

import ctypes

import torch

from studiosr_tpu_torch.ops.cuda import _build
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, finish, operand, stream
from studiosr_tpu_torch.ops.cuda.window_attention import MAX_HEAD_DIM

__all__ = [
    "oca_core_fwd", "oca_core_bwd", "oca_core_plain", "oca_core_bwd_plain", "MAX_QUERIES", "mma_takes", "pack_images",
    "main_partition",
]

MAX_QUERIES = 256  # csrc/attn_core.cuh AC_MAX_NQ
_LL = ctypes.c_longlong
_STRIDES = ctypes.POINTER(_LL)
_FWD = (P, P, P, P, P, _STRIDES, I, I, I, I, I, P)
_BWD = (P,) * 9 + (_STRIDES, I, I, I, I, I, P, _LL, P)
_SIGNATURES = {
    "oca_core_fwd_f32": _FWD,
    "oca_core_fwd_bf16": _FWD,
    "oca_core_bwd_f32": _BWD,
    "oca_core_bwd_bf16": _BWD,
    "oca_core_bwd_scratch": (I, I, I, I),
}
_RESTYPES = {"oca_core_bwd_scratch": _LL}
_SIGNATURES_MMA = {
    "oca_core_bwd_mma_bf16": (P,) * 9 + (_STRIDES, I, I, I, I, I, P, _LL, P, _LL, P),
    "oca_core_bwd_mma_scratch": (I,) * 5 + (ctypes.POINTER(_LL), ctypes.POINTER(_LL)),
}
MMA_MAX_QUERIES, MMA_MAX_KEYS, MMA_MAX_HEAD_DIM = 256, 576, 32  # csrc/oca_bwd_mma.cu OB_MAX_NQ, OB_MAX_NK
_TOK = 64  # tokens a tile (AM_TOK)


def mma_takes(heads: int, nq: int, nk: int, d: int) -> bool:
    """Whether the bf16 backward written for the H100 takes this geometry: a
    head dim up to 32, at most 256 queries and 576 keys a window."""
    return heads >= 1 and 1 <= d <= MMA_MAX_HEAD_DIM and 1 <= nq <= MMA_MAX_QUERIES and 1 <= nk <= MMA_MAX_KEYS


def _tiles(n: int) -> int:
    return -(-n // _TOK)


def pack_images(q, k, v, g) -> torch.Tensor:
    """Plain version of the H100 backward's pass 0 (``ob_pack_kernel``): per
    (window, head) unit, q and g in ceil(nq / 64) tiles, then k and v in
    ceil(nk / 64) chunks, each 64 tokens x DP (16 at d <= 16, else 32) in
    wgmma's K-major core-matrix image: token t, column j at (t // 8) DP 8 +
    (j // 8) 64 + (t % 8) 8 + j % 8, zero past the tokens and past d.
    Returns (bw * heads, unit elements) in q's dtype."""
    bw, heads, nq, d = q.shape
    nk = k.shape[2]
    dp = 16 if d <= 16 else 32
    parts = []
    for t, n in ((q, nq), (g, nq), (k, nk), (v, nk)):
        tiles = _tiles(n)
        padded = t.new_zeros(bw, heads, tiles * _TOK, dp)
        padded[:, :, :n, :d] = t
        # (unit, tile, token group, token in group, column group, column in group)
        x = padded.reshape(bw * heads, tiles, _TOK // 8, 8, dp // 8, 8)
        parts.append(x.permute(0, 1, 2, 4, 3, 5).reshape(bw * heads, -1))
    return torch.cat(parts, 1)


def _groups(bw: int, heads: int, kt: int, sms: int) -> int:
    """The main pass's count of window groups (``ob_groups``): the count, up
    to 64 and to bw, whose waves of heads x kt blocks (one an SM) take the
    fewest window steps, the smallest on a tie."""
    best, best_cost = 1, None
    for groups in range(1, min(bw, 64) + 1):
        waves = -(-(groups * heads * kt) // sms)
        cost = waves * -(-bw // groups)
        if best_cost is None or cost < best_cost:
            best, best_cost = groups, cost
    return best


def main_partition(bw: int, heads: int, nq: int, nk: int, sms: int = 132):
    """The H100 backward's main pass as its blocks take it: for each block
    (in launch order) the (window, head, query tile, key chunk) units of work
    it computes, in order: block b is (group b // (heads KT), head (b // KT) %
    heads, key chunk b % KT), its warpgroup w takes query tiles w, w + 2, and
    it walks the windows g, g + groups, .... Each (window, head, tile, chunk)
    must appear exactly once."""
    qt, kt = _tiles(nq), _tiles(nk)
    groups = _groups(bw, heads, kt, sms)
    blocks = []
    for b in range(groups * heads * kt):
        c, h, grp = b % kt, (b // kt) % heads, b // (kt * heads)
        blocks.append([(w, h, i, c) for w in range(grp, bw, groups) for wg in range(2) for i in range(wg, qt, 2)])
    return blocks


def oca_core_plain(q, k, v, bias):
    """``studiosr_tpu/ops/oca_vjp.py::_core_math`` in f32, returned in ``q.dtype``."""
    p = torch.softmax(q.float() @ k.float().transpose(-1, -2) + bias.float()[None], dim=-1)
    return (p @ v.float()).to(q.dtype)


def oca_core_bwd_plain(q, k, v, bias, g):
    """The explicit formulas of ``oca_core.py::_bwd_kernel`` in f32: (dq, dk,
    dv) in ``q.dtype`` and d bias (heads, nq, nk) in f32."""
    q32, k32, v32, g32 = q.float(), k.float(), v.float(), g.float()
    p = torch.softmax(q32 @ k32.transpose(-1, -2) + bias.float()[None], dim=-1)
    dv = p.transpose(-1, -2) @ g32
    dp = g32 @ v32.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq, dk = ds @ k32, ds.transpose(-1, -2) @ q32
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), ds.sum(0)


def _geometry(name: str, q, k, v):
    """(bw, heads, nq, nk, d) after checking what the kernels take."""
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share one dtype of {KERNEL_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)} do not fit")
    bw, heads, nq, d = q.shape
    nk = k.shape[2]
    if k.shape[0] != bw or k.shape[1] != heads or k.shape[3] != d or min(bw, heads, nq, nk, d) < 1:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} do not fit")
    if d > MAX_HEAD_DIM or nq > MAX_QUERIES:
        raise NotImplementedError(f"{name}: the kernels take d <= {MAX_HEAD_DIM} and nq <= {MAX_QUERIES}, "
                                  f"not d {d}, nq {nq}")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"{name}: operands on {q.device} and {t.device}")
    return bw, heads, nq, nk, d


def _rows(t):
    """``t`` with its last dimension contiguous (a view when it already is)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _out(bw: int, heads: int, n: int, d: int, like):
    """An output (bw, heads, n, d), laid out as (bw, n, heads, d)."""
    return torch.empty(bw, n, heads, d, dtype=like.dtype, device=like.device).transpose(1, 2)


def _strides(*tensors):
    flat = []
    for t in tensors:
        flat += [0, 0, 0] if t is None else list(t.stride()[:3])
    return (_LL * len(flat))(*flat)


def oca_core_fwd(q, k, v, bias):
    """softmax(q k^T + bias) v (B12). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return oca_core_plain(q, k, v, bias)
    bw, heads, nq, nk, d = _geometry("oca_core_fwd", q, k, v)
    q, k, v = _rows(q), _rows(k), _rows(v)
    b32 = operand(bias, "bias", (heads, nq, nk), torch.float32, q.device)
    out = _out(bw, heads, nq, d, q)
    lib = _build.load("oca_core", _SIGNATURES, _RESTYPES)
    fn = lib.oca_core_fwd_bf16 if q.dtype == torch.bfloat16 else lib.oca_core_fwd_f32
    strides = _strides(q, k, v, None, out, None, None, None)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), b32.data_ptr(), out.data_ptr(), strides, bw, heads, nq, nk,
                d, stream(q.device))
    finish("oca_core_fwd", status)
    return out


def oca_core_bwd(q, k, v, bias, g):
    """(dq, dk, dv, d bias) of :func:`oca_core_fwd` for the cotangent ``g``
    (B13); d bias in f32. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if q.device.type == "cpu":
        return oca_core_bwd_plain(q, k, v, bias, g)
    bw, heads, nq, nk, d = _geometry("oca_core_bwd", q, k, v)
    if tuple(g.shape) != tuple(q.shape) or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"oca_core_bwd: g {tuple(g.shape)} {g.dtype} does not match q {tuple(q.shape)} {q.dtype}")
    q, k, v, g = _rows(q), _rows(k), _rows(v), _rows(g)
    dev = q.device
    b32 = operand(bias, "bias", (heads, nq, nk), torch.float32, dev)
    dq, dk, dv = _out(bw, heads, nq, d, q), _out(bw, heads, nk, d, q), _out(bw, heads, nk, d, q)
    dbias = torch.empty(heads, nq, nk, dtype=torch.float32, device=dev)
    strides = _strides(q, k, v, g, None, dq, dk, dv)
    ptrs = [t.data_ptr() for t in (q, k, v, b32, g, dq, dk, dv, dbias)]
    if q.dtype == torch.bfloat16 and mma_takes(heads, nq, nk, d):
        lib = _build.load("oca_bwd_mma", _SIGNATURES_MMA)
        t_elems, f_elems = _LL(), _LL()
        status = lib.oca_core_bwd_mma_scratch(bw, heads, nq, nk, d, ctypes.byref(t_elems), ctypes.byref(f_elems))
        if status != 0:
            raise RuntimeError(f"oca_core_bwd: CUDA error {status} while sizing the scratch")
        tscratch = torch.empty(t_elems.value, dtype=q.dtype, device=dev)
        fscratch = torch.empty(f_elems.value, dtype=torch.float32, device=dev)
        entry = "oca_core_bwd_mma_bf16"
        status = lib.oca_core_bwd_mma_bf16(*ptrs, strides, bw, heads, nq, nk, d, tscratch.data_ptr(), t_elems.value,
                                           fscratch.data_ptr(), f_elems.value, stream(dev))
    else:
        lib = _build.load("oca_core", _SIGNATURES, _RESTYPES)
        f_elems = lib.oca_core_bwd_scratch(bw, heads, nq, nk)
        fscratch = torch.empty(f_elems, dtype=torch.float32, device=dev)
        entry = "oca_core_bwd_bf16" if q.dtype == torch.bfloat16 else "oca_core_bwd_f32"
        status = getattr(lib, entry)(*ptrs, strides, bw, heads, nq, nk, d, fscratch.data_ptr(), f_elems, stream(dev))
    finish("oca_core_bwd", status, entry)
    return dq, dk, dv, dbias
