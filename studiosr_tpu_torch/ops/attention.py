"""Windowed multi-head attention core.

Port of ``studiosr_tpu/ops/attention.py``. Operands are (B, heads, N, d);
``bias`` is (heads, N, M) and ``mask`` is (nW, N, M) broadcast as
``mask[None, :, None]`` over B = batch * nW windows in row-major order.

Two backends, as in the JAX package: ``"xla"`` (the default) computes the
plain PyTorch version here; ``"pallas"`` (the JAX package's opt-in name)
routes every call that B15 takes (``window_attn.takes``) through
``ops/cuda/window_attn.py::window_attention``, which launches its CUDA
kernel on a CUDA tensor and takes this plain version on a CPU one; a call
it does not take (above 1024 tokens a window) is recorded as B15's
structural decline and computed here, as the JAX backend falls through.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_core", "attention_plain", "set_attention_backend", "get_attention_backend"]

_BACKEND = "xla"


def set_attention_backend(name: str) -> None:
    if name not in ("xla", "pallas"):
        raise ValueError(f"unknown attention backend {name!r}; 'xla' (plain) or 'pallas' (the B15 kernel)")
    global _BACKEND
    _BACKEND = name


def get_attention_backend() -> str:
    return _BACKEND


def attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    mm=torch.matmul,
) -> torch.Tensor:
    """softmax(q @ k^T + bias + mask) @ v; ``q`` already carries 1/sqrt(d).
    Scores and softmax in f32, or f64 for f64 operands. ``mm`` takes both
    products of the plain version (``ops/cuda/tf32x3.py`` ``matmul`` repeats
    the f32 kernels' 3xTF32 arithmetic); another ``mm`` than the default
    always takes the plain version."""
    if _BACKEND == "pallas" and mm is torch.matmul:
        from studiosr_tpu_torch.ops.cuda import window_attn

        if window_attn.takes(q.shape[2], k.shape[2], q.shape[3]):
            return window_attn.window_attention(q, k, v, bias=bias, mask=mask)
        window_attn.decline(q.shape[2], k.shape[2], q.shape[3])
    return attention_plain(q, k, v, bias, mask, mm)


def attention_plain(q, k, v, bias=None, mask=None, mm=torch.matmul) -> torch.Tensor:
    """The plain version of :func:`attention_core` (and of B15)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    attn = mm(q, k.transpose(-2, -1)).to(acc)
    if bias is not None:
        attn = attn + bias[None].to(acc)
    if mask is not None:
        nw = mask.shape[0]
        b = attn.shape[0] // nw
        attn = attn.reshape(b, nw, *attn.shape[1:]) + mask[None, :, None].to(acc)
        attn = attn.reshape(-1, *attn.shape[2:])
    attn = torch.softmax(attn, dim=-1)
    return mm(attn.to(v.dtype), v)
