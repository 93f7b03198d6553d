"""Differentiable fused MLP half of a Swin block.

Port of ``studiosr_tpu/ops/pallas/mlp_vjp.py``'s ``mlp_block_dp_vjp`` and
``mlp_block_vjp``: y = x + d * fc2(gelu(fc1(LN x))) on (rows, C), with the
per-sample drop-path scale d = ``dp_scales[row // rows_per_sample]``, or
d = 1 (``mlp_block_vjp``, MaxSR's feed-forward: the kernels then read no
scales at all). Forward through
B6 (``ops/cuda/mlp_block.py``), backward through B7
(``ops/cuda/mlp_bwd.py``), which recomputes LN, fc1 and GELU, so the only
residuals are the input and the operands. B7 takes the branch cotangent
d g and adds the (1 - d) g of the residual to dx, as ``mlp_vjp.py::_dp_bwd``
does. ``dp_scales`` gets no gradient. A call without grad takes B6 as well.
On CPU tensors both kernels take their plain versions.
"""

from __future__ import annotations

import torch

from studiosr_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
from studiosr_tpu_torch.ops.cuda.mlp_bwd import mlp_bwd

__all__ = ["mlp_block_dp_vjp", "mlp_block_vjp"]


class _MlpBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, dp_scales, rows_per_sample):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2, dp_scales)
        ctx.rows_per_sample = rows_per_sample
        return fused_mlp_block(x, ln_w, ln_b, w1, b1, w2, b2, drop_path=dp_scales, rows_per_sample=rows_per_sample)

    @staticmethod
    def backward(ctx, g):
        x, ln_w, ln_b, w1, b1, w2, b2, dp_scales = ctx.saved_tensors
        grads = mlp_bwd(
            x, g.contiguous(), ln_w, ln_b, w1, b1, w2, drop_path=dp_scales, rows_per_sample=ctx.rows_per_sample
        )
        params = (ln_w, ln_b, w1, b1, w2, b2)
        return (grads[0], *(gr.to(p.dtype) for gr, p in zip(grads[1:], params)), None, None)


def mlp_block_dp_vjp(x, ln_w, ln_b, w1, b1, w2, b2, dp_scales, rows_per_sample: int):
    """``w1`` (C, hidden), ``w2`` (hidden, C) in (in, out) layout;
    ``dp_scales`` (B,) already divided by keep; rows_per_sample maps rows to
    samples."""
    return _MlpBlock.apply(x, ln_w, ln_b, w1, b1, w2, b2, dp_scales, rows_per_sample)


def mlp_block_vjp(x, ln_w, ln_b, w1, b1, w2, b2):
    """:func:`mlp_block_dp_vjp` without drop-path
    (``studiosr_tpu/ops/pallas/mlp_vjp.py:128``)."""
    return _MlpBlock.apply(x, ln_w, ln_b, w1, b1, w2, b2, None, 0)
