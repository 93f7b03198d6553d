"""B6: the MLP half of a Swin block over token rows (CUDA kernel ``csrc/mlp_block.cu``).

Replaces ``studiosr_tpu/ops/pallas/swin_block.py::fused_mlp_block``:
y = x + d * fc2(gelu(fc1(LN x))) on x (rows, C), with ``drop_path`` (B,)
per-sample scales (already divided by keep) applied to row r as
``drop_path[r // rows_per_sample]``; None means 1. ``w1`` (C, hidden) and
``w2`` (hidden, C) in (in, out) layout are cast to the rows' dtype;
LayerNorm weights, biases and scales go to the kernel in f32. GELU is the
exact (erf) one.

``extra`` (rows, C) with ``extra_scale`` (C,) is HAT's CAB join, folded in
before the LayerNorm: x' = x + extra * extra_scale in f32, then
y = x' + fc2(gelu(fc1(LN x'))), the residual the f32 x' (not re-rounded).
It runs a second instantiation of the kernel and counts its launches as
``fused_mlp_block_extra``; drop-path does not combine with it (HAT serving
has none).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from studiosr_tpu_torch.ops.cuda import _build
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, check, finish, operand, stream

__all__ = ["fused_mlp_block", "mlp_block_plain", "row_scales"]

_ARGS = (P, P, I, I, I) + (P,) * 7 + (I, P, ctypes.c_longlong, P)
_EXTRA_ARGS = (P, P, I, I, I) + (P,) * 8 + (P, ctypes.c_longlong, P)
_SIGNATURES = {
    "mlp_block_f32": _ARGS, "mlp_block_bf16": _ARGS, "mlp_block_pack_elems": (I, I),
    "mlp_block_extra_f32": _EXTRA_ARGS, "mlp_block_extra_bf16": _EXTRA_ARGS,
}
_RESTYPES = {"mlp_block_pack_elems": ctypes.c_longlong}


def row_scales(drop_path, rows: int, rows_per_sample: int):
    """(rows, 1) f32 scale of each row, or None."""
    if drop_path is None:
        return None
    if rows_per_sample <= 0 or rows % rows_per_sample or drop_path.numel() != rows // rows_per_sample:
        raise ValueError(
            f"drop_path of {drop_path.numel()} samples does not fit {rows} rows of {rows_per_sample} per sample"
        )
    return drop_path.float().repeat_interleave(rows_per_sample).reshape(rows, 1)


def mlp_block_plain(
    x, ln_w, ln_b, w1, b1, w2, b2, *, drop_path=None, rows_per_sample: int = 0, extra=None, extra_scale=None
):
    """Plain PyTorch version, computed in f32 and returned in ``x.dtype``."""
    xf = x.float()
    if extra is not None:
        xf = xf + extra.float() * extra_scale.float()
    h = F.gelu(F.layer_norm(xf, (x.shape[-1],), ln_w.float(), ln_b.float(), 1e-5) @ w1.float() + b1.float())
    delta = h @ w2.float() + b2.float()
    d = row_scales(drop_path, x.shape[0], rows_per_sample)
    if d is not None:
        delta = delta * d
    return (xf + delta).to(x.dtype)


def fused_mlp_block(
    x, ln_w, ln_b, w1, b1, w2, b2, *, drop_path=None, rows_per_sample: int = 0, extra=None, extra_scale=None
):
    """(rows, C) -> (rows, C). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if (extra is None) != (extra_scale is None):
        raise ValueError("fused_mlp_block: extra and extra_scale come together")
    if extra is not None and drop_path is not None:
        raise NotImplementedError("fused_mlp_block: drop_path with extra is not supported")
    kw = dict(drop_path=drop_path, rows_per_sample=rows_per_sample, extra=extra, extra_scale=extra_scale)
    if x.device.type == "cpu":
        return mlp_block_plain(x, ln_w, ln_b, w1, b1, w2, b2, **kw)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_mlp_block: unsupported dtype {x.dtype}")
    rows, c = x.shape
    hidden = w1.shape[-1]
    row_scales(drop_path, rows, rows_per_sample)  # validates the scales' shape
    dev, dt = x.device, x.dtype
    # the kernel reads every operand during the launch; keep each converted copy alive until then
    ops = [
        operand(ln_w, "ln_w", (c,), torch.float32, dev), operand(ln_b, "ln_b", (c,), torch.float32, dev),
        operand(w1, "w1", (c, hidden), dt, dev), operand(b1, "b1", (hidden,), torch.float32, dev),
        operand(w2, "w2", (hidden, c), dt, dev), operand(b2, "b2", (c,), torch.float32, dev),
    ]
    px = check(x, "x", (rows, c), dt, dev)
    out = torch.empty_like(x)
    lib = _build.load("mlp_block", _SIGNATURES, _RESTYPES)
    pack = lib.mlp_block_pack_elems(c, hidden)
    packed = torch.empty(pack, dtype=dt, device=dev)
    ptrs = [t.data_ptr() for t in ops]
    bf16 = dt == torch.bfloat16
    if extra is None:
        dp = None if drop_path is None else operand(drop_path, "drop_path", (drop_path.numel(),), torch.float32, dev)
        fn = lib.mlp_block_bf16 if bf16 else lib.mlp_block_f32
        status = fn(px, out.data_ptr(), rows, c, hidden, *ptrs, None if dp is None else dp.data_ptr(), rows_per_sample,
                    packed.data_ptr(), pack, stream(dev))
        finish("fused_mlp_block", status)
    else:
        pe = check(extra, "extra", (rows, c), dt, dev)
        es = operand(extra_scale, "extra_scale", (c,), torch.float32, dev)
        fn = lib.mlp_block_extra_bf16 if bf16 else lib.mlp_block_extra_f32
        status = fn(px, out.data_ptr(), rows, c, hidden, *ptrs, pe, es.data_ptr(), packed.data_ptr(), pack,
                    stream(dev))
        finish("fused_mlp_block_extra", status)
    return out
