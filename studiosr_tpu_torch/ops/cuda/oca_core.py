"""B12 and B13: the OCAB cross-attention core, forward and backward (CUDA kernels ``csrc/oca_core.cu``).

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
"""

from __future__ import annotations

import ctypes

import torch

from studiosr_tpu_torch.ops.cuda import _build
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, finish, operand, stream
from studiosr_tpu_torch.ops.cuda.window_attention import MAX_HEAD_DIM

__all__ = ["oca_core_fwd", "oca_core_bwd", "oca_core_plain", "oca_core_bwd_plain", "MAX_QUERIES"]

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
    lib = _build.load("oca_core", _SIGNATURES, _RESTYPES)
    f_elems = lib.oca_core_bwd_scratch(bw, heads, nq, nk)
    fscratch = torch.empty(f_elems, dtype=torch.float32, device=dev)
    fn = lib.oca_core_bwd_bf16 if q.dtype == torch.bfloat16 else lib.oca_core_bwd_f32
    strides = _strides(q, k, v, g, None, dq, dk, dv)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), b32.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), dbias.data_ptr(), strides, bw, heads, nq, nk, d, fscratch.data_ptr(), f_elems,
                stream(dev))
    finish("oca_core_bwd", status)
    return dq, dk, dv, dbias
