"""Differentiable core of HAT's overlapping cross-attention (OCAB).

Port of ``studiosr_tpu/ops/oca_vjp.py::oca_attention``: softmax(q k^T +
bias) v over q (bw, heads, nq, d), already scaled by 1/sqrt(d), k and v (bw,
heads, nk, d) and the (heads, nq, nk) bias, forward through B12 and backward
through B13 (``ops/cuda/oca_core.py``), which recomputes the scores, so the
(bw, heads, nq, nk) f32 score tensor is never kept. A call without grad
takes B12 as well, as the JAX primal does. The JAX package falls back to a
chunked XLA scan where its kernels decline a layout (``oca_supported``:
query or key counts not multiples of 8, or scores past its VMEM budget,
as at HAT's windows 4, 12 and above 24); the port needs no such route,
because B12 and B13 take every query and key count on the card (their
large entries above 256 queries or 576 keys), and a CUDA tensor launches
the kernels or raises. On CPU tensors both take their plain versions.
"""

from __future__ import annotations

import torch

from studiosr_tpu_torch.ops.cuda.oca_core import oca_core_bwd, oca_core_fwd

__all__ = ["oca_attention"]


class _OcaAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return oca_core_fwd(q, k, v, bias)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = oca_core_bwd(q, k, v, bias, g)
        return dq, dk, dv, dbias.to(bias.dtype)


def oca_attention(q, k, v, bias):
    """softmax(q @ k^T + bias) @ v over (bw, heads, nq | nk, d) operands."""
    return _OcaAttention.apply(q, k, v, bias)
