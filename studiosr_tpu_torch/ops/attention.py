"""Windowed multi-head attention core (plain PyTorch).

Port of ``studiosr_tpu/ops/attention.py::attention_core`` (the XLA path).
Operands are (B, heads, N, d); ``bias`` is (heads, N, M) and ``mask`` is
(nW, N, M) broadcast as ``mask[None, :, None]`` over B = batch * nW windows
in row-major order.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_core"]


def attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q @ k^T + bias + mask) @ v; ``q`` already carries 1/sqrt(d).
    Scores and softmax in f32, or f64 for f64 operands."""
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
