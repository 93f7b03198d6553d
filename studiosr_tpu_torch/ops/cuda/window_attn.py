"""B15: the window-attention core (CUDA kernel ``csrc/window_attn.cu``).

Replaces ``studiosr_tpu/ops/pallas/window_attn.py::window_attention_pallas``:

    out = softmax(q k^T + bias + mask) v

on q (B', heads, N, d), already scaled by 1/sqrt(d), and k, v (B', heads, M,
d), with ``attention_core``'s contract (``ops/attention.py``): ``bias``
(heads, N, M) or None (a zero bias, MaxSR's adaptive mode, never
materialised), ``mask`` (nW, N, M) or None, broadcast over B' = images x nW
windows in row-major order (not only the Pallas wrapper's batch 1). The
softmax is max-subtracted in f32 and the probabilities are rounded to v's
dtype before the product with v.

q, k, v are f32 or bf16, one dtype, any strided view whose last dimension is
contiguous (the q / k / v slices of a fused qkv projection reach the kernel
without a copy); bias and mask are handed to the kernel in f32. The output
comes back as a transposed view of a (B', N, heads, d) tensor, the layout
the output projection reads. The kernel takes N, M <= 1024 (as the JAX
wrapper) and d <= 64 (``takes``); other shapes raise
``NotImplementedError``. Callers that route around it (MaxSR's fused
attention, ``attention_core``'s "pallas" backend) ask ``takes`` first and,
where it says no, record the structural decline (``decline``, as the JAX
wrapper's ``engagement.fallback``) and take the plain route.

bf16 launches the kernel written for the H100 (C entry
``window_attn_flash_bf16``), every shape; f32, the checks' dtype, the
shared-memory row pass of ``csrc/attn_core.cuh`` (``window_attn_f32``).
Both count under ``window_attention_pallas``; ``engagement.entries()``
tells them apart.
"""

from __future__ import annotations

import ctypes

import torch

from studiosr_tpu_torch.ops.attention import attention_plain
from studiosr_tpu_torch.ops.cuda import _build, engagement
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, finish, operand, STREAM, call
from studiosr_tpu_torch.ops.cuda.window_attention import MAX_HEAD_DIM

__all__ = ["window_attention", "takes", "decline", "MAX_TOKENS"]

MAX_TOKENS = 1024  # csrc/window_attn.cu WA_MAX_TOKENS
_LL = ctypes.c_longlong
_ARGS = (P, P, P, P, P, P, ctypes.POINTER(_LL), _LL, I, I, I, I, I, P)
_SIGNATURES = {"window_attn_f32": _ARGS, "window_attn_flash_bf16": _ARGS}


def takes(n: int, m: int, d: int) -> bool:
    """Whether B15 takes N query and M key tokens a window at head dim d."""
    return n <= MAX_TOKENS and m <= MAX_TOKENS and d <= MAX_HEAD_DIM


def decline(n: int, m: int, d: int) -> None:
    """Record B15's structural decline of (N, M, d), which ``takes`` refused."""
    engagement.structural_decline(
        "window_attention_pallas", f"N {n}, M {m}, d {d}: the kernel takes N, M <= {MAX_TOKENS} and d <= "
        f"{MAX_HEAD_DIM} (plain attention_core)")


def _rows(t):
    """``t`` with its last dimension contiguous (a view when it already is)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def window_attention(q, k, v, bias=None, mask=None):
    """softmax(q k^T + bias + mask) v (B15). CPU tensors take the plain
    version (``attention_core``'s); CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, mask)
    name = "window_attention"
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share one dtype of {KERNEL_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)} do not fit")
    bw, heads, n, d = q.shape
    m = k.shape[2]
    if k.shape[0] != bw or k.shape[1] != heads or k.shape[3] != d or min(bw, heads, n, m, d) < 1:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} do not fit")
    if not takes(n, m, d):
        raise NotImplementedError(f"{name}: the kernel takes N, M <= {MAX_TOKENS} and d <= {MAX_HEAD_DIM}, "
                                  f"not N {n}, M {m}, d {d}")
    dev = q.device
    for t in (k, v):
        if t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
    b32 = None if bias is None else operand(bias, "bias", (heads, n, m), torch.float32, dev)
    nw = 1
    m32 = None
    if mask is not None:
        nw = mask.shape[0]
        if mask.dim() != 3 or bw % nw:
            raise ValueError(f"{name}: mask {tuple(mask.shape)} does not tile {bw} windows")
        m32 = operand(mask, "mask", (nw, n, m), torch.float32, dev)
    q, k, v = _rows(q), _rows(k), _rows(v)
    out = torch.empty(bw, n, heads, d, dtype=q.dtype, device=dev).transpose(1, 2)
    flat = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    strides = (_LL * len(flat))(*flat)
    lib = _build.load("window_attn", _SIGNATURES)
    entry = "window_attn_flash_bf16" if q.dtype == torch.bfloat16 else "window_attn_f32"
    status = call(dev, getattr(lib, entry), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if b32 is None else b32.data_ptr(), None if m32 is None else m32.data_ptr(), out.data_ptr(),
                  strides, bw, heads, n, m, d, nw, STREAM)
    finish("window_attention_pallas", status, entry)
    return out
