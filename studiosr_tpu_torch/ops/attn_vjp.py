"""Differentiable fused window-attention half of a Swin block.

Port of ``studiosr_tpu/ops/attn_vjp.py::attention_map_vjp``: on (B, H, W, C)
maps, y = x + d_b * (proj(WA(LN(roll(x)))) rolled back), forward through B5
(``ops/cuda/window_attention.py``) and backward through B8
(``ops/cuda/attn_bwd.py``), which recomputes the forward flash-style, so
the only residuals are the block input and the operands. The mask is
``calculate_mask`` of the rolled map, implied by ``shift``; it and the
per-sample drop-path scales ``dp_scales`` (B,) get no gradient. A call
without grad (``torch.no_grad``) takes B5 as well, as the JAX primal
delegates to its fused forward. On CPU tensors both kernels take their
plain versions.
"""

from __future__ import annotations

import torch

from studiosr_tpu_torch.ops.cuda.attn_bwd import attention_bwd
from studiosr_tpu_torch.ops.cuda.window_attention import fused_window_attention_block

__all__ = ["attention_map_vjp"]


class _AttentionMap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, dp_scales, shift, heads, ws):
        ctx.save_for_backward(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, dp_scales)
        ctx.meta = (shift, heads, ws)
        return fused_window_attention_block(
            x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, heads=heads, window_size=ws, shift=shift,
            drop_path=dp_scales,
        )

    @staticmethod
    def backward(ctx, g):
        x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, dp_scales = ctx.saved_tensors
        shift, heads, ws = ctx.meta
        grads = attention_bwd(
            x, g.contiguous(), ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, heads=heads, window_size=ws, shift=shift,
            drop_path=dp_scales,
        )
        params = (ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias)
        return (grads[0], *(gr.to(p.dtype) for gr, p in zip(grads[1:], params)), None, None, None, None)


def attention_map_vjp(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, dp_scales, shift: int, heads: int, ws: int):
    """``wqkv`` (C, 3C), ``wproj`` (C, C) in (in, out) layout; ``bias`` the
    gathered (heads, N, N) rel-pos bias; ``dp_scales`` (B,) or None."""
    return _AttentionMap.apply(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, dp_scales, shift, heads, ws)
