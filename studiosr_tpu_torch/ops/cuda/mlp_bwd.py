"""B7: the backward of B6 with the forward recomputed (CUDA kernel ``csrc/mlp_bwd.cu``).

Replaces ``studiosr_tpu/ops/pallas/mlp_vjp.py::_bwd`` (reached through
``_dp_bwd``). For y = x + d * fc2(gelu(fc1(LN x))) on x (rows, C), with
``drop_path`` / ``rows_per_sample`` as in ``ops/cuda/mlp_block.py``, and
the cotangent ``g`` of y, it returns

    (dx, d ln_w, d ln_b, d w1, d b1, d w2, d b2)

with dx in ``x.dtype`` and the parameter gradients in f32 (the caller casts
each to its parameter's dtype). The kernel sums its weight-gradient
partials in a fixed order, so the result is the same from run to run.
"""

from __future__ import annotations

import ctypes

import torch

from studiosr_tpu_torch.ops.cuda import _build
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, check, finish, operand, stream
from studiosr_tpu_torch.ops.cuda.mlp_block import row_scales

__all__ = ["mlp_bwd", "mlp_bwd_plain"]

_LL = ctypes.c_longlong
_ARGS = (P, P, P, I, I, I) + (P,) * 6 + (I,) + (P,) * 5 + (P, _LL, P, _LL, P)
_SIGNATURES = {
    "mlp_bwd_f32": _ARGS,
    "mlp_bwd_bf16": _ARGS,
    "mlp_bwd_scratch": (I, I, I, ctypes.POINTER(_LL), ctypes.POINTER(_LL)),
}
_RESTYPES = {"mlp_bwd_scratch": None}
_INV_SQRT2PI = 0.3989422804014327


def mlp_bwd_plain(x, g, ln_w, ln_b, w1, b1, w2, *, drop_path=None, rows_per_sample: int = 0):
    """Plain PyTorch version (``mlp_vjp.py::_bwd`` / ``_dp_bwd`` in f32)."""
    x32, g32 = x.float(), g.float()
    s, b = ln_w.float(), ln_b.float()
    w1, b1, w2 = w1.float(), b1.float(), w2.float()
    d = row_scales(drop_path, x.shape[0], rows_per_sample)
    gb = g32 if d is None else d * g32
    mu = x32.mean(-1, keepdim=True)
    inv = torch.rsqrt((x32 - mu).square().mean(-1, keepdim=True) + 1e-5)
    xhat = (x32 - mu) * inv
    ln = xhat * s + b
    h1 = ln @ w1 + b1
    cdf = 0.5 * (1.0 + torch.erf(h1 * 0.7071067811865476))
    g1 = h1 * cdf
    dh1 = (gb @ w2.t()) * (cdf + h1 * torch.exp(-0.5 * h1 * h1) * _INV_SQRT2PI)
    dln = dh1 @ w1.t()
    dxhat = dln * s
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = gb + (dxhat - m1 - xhat * m2) * inv
    if d is not None:
        dx = dx + (1.0 - d) * g32
    return (
        dx.to(x.dtype), (dln * xhat).sum(0), dln.sum(0), ln.t() @ dh1, dh1.sum(0), g1.t() @ gb, gb.sum(0),
    )


def mlp_bwd(x, g, ln_w, ln_b, w1, b1, w2, *, drop_path=None, rows_per_sample: int = 0):
    """CPU tensors take the plain version; CUDA tensors launch the kernel or raise."""
    kw = dict(drop_path=drop_path, rows_per_sample=rows_per_sample)
    if x.device.type == "cpu":
        return mlp_bwd_plain(x, g, ln_w, ln_b, w1, b1, w2, **kw)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"mlp_bwd: unsupported dtype {x.dtype}")
    rows, c = x.shape
    hidden = w1.shape[-1]
    row_scales(drop_path, rows, rows_per_sample)  # validates the scales' shape
    dev, dt, f32 = x.device, x.dtype, torch.float32
    ops = [
        operand(ln_w, "ln_w", (c,), f32, dev), operand(ln_b, "ln_b", (c,), f32, dev),
        operand(w1, "w1", (c, hidden), dt, dev), operand(b1, "b1", (hidden,), f32, dev),
        operand(w2, "w2", (hidden, c), dt, dev),
        None if drop_path is None else operand(drop_path, "drop_path", (drop_path.numel(),), f32, dev),
    ]
    px = check(x, "x", (rows, c), dt, dev)
    pg = check(g, "g", (rows, c), dt, dev)
    lib = _build.load("mlp_bwd", _SIGNATURES, _RESTYPES)
    t_elems, f_elems = _LL(), _LL()
    lib.mlp_bwd_scratch(rows, c, hidden, ctypes.byref(t_elems), ctypes.byref(f_elems))
    tscratch = torch.empty(t_elems.value, dtype=dt, device=dev)
    fscratch = torch.empty(f_elems.value, dtype=f32, device=dev)
    dx = torch.empty_like(x)
    ds_db = torch.empty(2 * c, dtype=f32, device=dev)
    dw1, db1 = torch.empty(c, hidden, dtype=f32, device=dev), torch.empty(hidden, dtype=f32, device=dev)
    dw2, db2 = torch.empty(hidden, c, dtype=f32, device=dev), torch.empty(c, dtype=f32, device=dev)
    fn = lib.mlp_bwd_bf16 if dt == torch.bfloat16 else lib.mlp_bwd_f32
    ptrs = [None if t is None else t.data_ptr() for t in ops]
    status = fn(
        px, pg, dx.data_ptr(), rows, c, hidden, *ptrs, rows_per_sample, ds_db.data_ptr(), dw1.data_ptr(),
        db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), tscratch.data_ptr(), t_elems.value,
        fscratch.data_ptr(), f_elems.value, stream(dev),
    )
    finish("mlp_bwd", status)
    return dx, ds_db[:c], ds_db[c:], dw1, db1, dw2, db2
