"""Windowed multi-head attention core.

Port of ``studiosr_tpu/ops/attention.py``. Operands are (B, heads, N, d);
``bias`` is (heads, N, M) and ``mask`` is (nW, N, M) broadcast as
``mask[None, :, None]`` over B = batch * nW windows in row-major order.

Two backends, as in the JAX package: ``"xla"`` (the default) computes the
plain PyTorch version here; ``"pallas"`` (the JAX package's opt-in name)
routes every call through B15, ``ops/cuda/window_attn.py::window_attention``,
which launches its CUDA kernel on a CUDA tensor and takes this plain version
on a CPU one.
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
) -> torch.Tensor:
    """softmax(q @ k^T + bias + mask) @ v; ``q`` already carries 1/sqrt(d).
    Scores and softmax in f32, or f64 for f64 operands."""
    if _BACKEND == "pallas":
        from studiosr_tpu_torch.ops.cuda.window_attn import window_attention

        return window_attention(q, k, v, bias=bias, mask=mask)
    return attention_plain(q, k, v, bias, mask)


def attention_plain(q, k, v, bias=None, mask=None) -> torch.Tensor:
    """The plain version of :func:`attention_core` (and of B15)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    attn = torch.matmul(q, k.transpose(-2, -1)).to(acc)
    if bias is not None:
        attn = attn + bias[None].to(acc)
    if mask is not None:
        nw = mask.shape[0]
        b = attn.shape[0] // nw
        attn = attn.reshape(b, nw, *attn.shape[1:]) + mask[None, :, None].to(acc)
        attn = attn.reshape(-1, *attn.shape[2:])
    attn = torch.softmax(attn, dim=-1)
    return torch.matmul(attn.to(v.dtype), v)
