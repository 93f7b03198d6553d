"""B8 and B9: the backward of B5 with the forward recomputed (CUDA kernels
``csrc/attn_bwd.cu`` at window 8, ``csrc/attn_bwd16.cu`` at window 16).

Replaces ``studiosr_tpu/ops/pallas/attn_bwd.py::pairs_attention_bwd`` (B8)
and ``::v5_attention_bwd`` (B9, HAT's window 16). For
y = x + d_b * proj(WA(LN x)) on (B, H, W, C) maps, with ``shift`` and
``drop_path`` as in ``ops/cuda/window_attention.py`` (the output aligned
with the input), and the cotangent ``g`` of y, it returns

    (dx, d ln_w, d ln_b, d wqkv, d bqkv, d wproj, d bproj, d bias)

with dx in ``x.dtype`` and the parameter gradients in f32 (the caller casts
each to its parameter's dtype); d bias is (heads, N, N), the gradient of the
gathered rel-pos bias (autograd of ``gather_rel_bias`` scatters it into the
(2 ws - 1)^2 table). ``wqkv`` is unscaled, so its q columns need no
re-scaling. The kernels sum their partials in a fixed order, so the result
is the same from run to run. Window-16 launches count as
``attention_bwd_ws16``.
"""

from __future__ import annotations

import ctypes

import torch

from studiosr_tpu_torch.ops.cuda import _build
from studiosr_tpu_torch.ops.cuda._launch import P, I, check, finish, operand, stream
from studiosr_tpu_torch.ops.cuda.window_attention import KERNEL_WINDOW, KERNEL_WINDOW16, check_window_map
from studiosr_tpu_torch.ops.windows import calculate_mask, window_partition, window_reverse

__all__ = ["attention_bwd", "attention_bwd_plain", "window_bwd_math"]

_LL = ctypes.c_longlong
_ARGS = (P, P, P, I, I, I, I, I, I) + (P,) * 7 + (P,) * 6 + (P, _LL, P, _LL, P)
_SIGNATURES = {
    "attn_bwd_f32": _ARGS,
    "attn_bwd_bf16": _ARGS,
    "attn_bwd_scratch": (I, I, I, I, I, ctypes.POINTER(_LL), ctypes.POINTER(_LL)),
}
_RESTYPES = {"attn_bwd_scratch": None}
_ARGS16 = (P, P, P, I, I, I, I, I, I, I) + (P,) * 7 + (P,) * 6 + (P, _LL, P, _LL, P)
_SIGNATURES16 = {
    "attn_bwd16_f32": _ARGS16,
    "attn_bwd16_bf16": _ARGS16,
    "attn_bwd16_scratch": (I, I, I, I, I, I, ctypes.POINTER(_LL), ctypes.POINTER(_LL)),
}
_RESTYPES16 = {"attn_bwd16_scratch": None}


def _split_heads(t, heads: int):
    nw, n, c = t.shape
    return t.reshape(nw, n, heads, c // heads).transpose(1, 2)  # (nw, heads, n, d)


def _merge_heads(t):
    nw, heads, n, d = t.shape
    return t.transpose(1, 2).reshape(nw, n, heads * d)


def window_bwd_math(x, s, b, wqkv, bqkv, wproj, bias, mask, heads: int, g):
    """``studiosr_tpu/ops/attn_vjp.py::_window_bwd_math`` in f32 on (nW, N, C)
    windows (``mask`` (nW_img, N, N) repeats over the batch, or None):
    grads of x + proj(WA(LN x)) for (x, s, b, wqkv, bqkv, wproj, bproj, bias)."""
    nw, n, c = x.shape
    d = c // heads
    scale = float(d) ** -0.5
    x32, g32 = x.float(), g.float()
    s, wqkv, wproj = s.float(), wqkv.float(), wproj.float()
    mu = x32.mean(-1, keepdim=True)
    inv = torch.rsqrt((x32 - mu).square().mean(-1, keepdim=True) + 1e-5)
    xhat = (x32 - mu) * inv
    ln = xhat * s + b.float()
    qkv = ln @ wqkv + bqkv.float()
    q = _split_heads(qkv[..., :c], heads) * scale
    k = _split_heads(qkv[..., c : 2 * c], heads)
    v = _split_heads(qkv[..., 2 * c :], heads)
    scores = q @ k.transpose(-1, -2) + bias.float()[None]
    if mask is not None:
        scores = (scores.reshape(-1, mask.shape[0], heads, n, n) + mask.float()[None, :, None]).reshape(scores.shape)
    probs = torch.softmax(scores, dim=-1)
    attn = _merge_heads(probs @ v)

    dwproj = torch.einsum("wnc,wnk->ck", attn, g32)
    dbproj = g32.sum((0, 1))
    dav = _split_heads(g32 @ wproj.t(), heads)
    dv = probs.transpose(-1, -2) @ dav
    dprobs = dav @ v.transpose(-1, -2)
    dscores = probs * (dprobs - (dprobs * probs).sum(-1, keepdim=True))
    dbias = dscores.sum(0)
    dq = dscores @ k * scale
    dk = dscores.transpose(-1, -2) @ q
    dqkv = torch.cat([_merge_heads(dq), _merge_heads(dk), _merge_heads(dv)], dim=-1)
    dwqkv = torch.einsum("wnc,wnk->ck", ln, dqkv)
    dbqkv = dqkv.sum((0, 1))
    dln = dqkv @ wqkv.t()
    dxhat = dln * s
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = g32 + (dxhat - m1 - xhat * m2) * inv
    return dx, (dln * xhat).sum((0, 1)), dln.sum((0, 1)), dwqkv, dbqkv, dwproj, dbproj, dbias


def attention_bwd_plain(
    x, g, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, *, heads: int, window_size: int, shift: int = 0, drop_path=None
):
    """Plain PyTorch version: roll, partition, :func:`window_bwd_math` with the
    branch cotangent d g, reverse, roll back, plus (1 - d) g."""
    del bproj  # the bias of proj does not enter the gradients
    bsz, h, w, c = x.shape
    ws = window_size
    g32 = g.float()
    dd = None if drop_path is None else drop_path.float().reshape(-1, 1, 1, 1)
    gb = g32 if dd is None else dd * g32
    roll = (lambda t: torch.roll(t, (-shift, -shift), dims=(1, 2))) if shift else (lambda t: t)
    mask = torch.from_numpy(calculate_mask((h, w), ws, shift)).to(x.device) if shift else None
    parts = lambda t: window_partition(roll(t), ws).reshape(-1, ws * ws, c)  # noqa: E731
    dzw, *grads = window_bwd_math(parts(x.float()), ln_w, ln_b, wqkv, bqkv, wproj, bias, mask, heads, parts(gb))
    dx = window_reverse(dzw.reshape(-1, ws, ws, c), ws, h, w)
    if shift:
        dx = torch.roll(dx, (shift, shift), dims=(1, 2))
    if dd is not None:
        dx = dx + (1.0 - dd) * g32
    return (dx.to(x.dtype), *grads)


def attention_bwd(
    x, g, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, *, heads: int, window_size: int, shift: int = 0, drop_path=None
):
    """CPU tensors take the plain version; CUDA tensors launch the kernel or raise."""
    kw = dict(heads=heads, window_size=window_size, shift=shift, drop_path=drop_path)
    if x.device.type == "cpu":
        return attention_bwd_plain(x, g, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, **kw)
    check_window_map("attention_bwd", x, heads, window_size, shift, (KERNEL_WINDOW, KERNEL_WINDOW16))
    bsz, h, w, c = x.shape
    n = window_size * window_size
    dev, dt, f32 = x.device, x.dtype, torch.float32
    ops = [
        operand(ln_w, "ln_w", (c,), f32, dev), operand(ln_b, "ln_b", (c,), f32, dev),
        operand(wqkv, "wqkv", (c, 3 * c), dt, dev), operand(bqkv, "bqkv", (3 * c,), f32, dev),
        operand(wproj, "wproj", (c, c), dt, dev), operand(bias, "bias", (heads, n, n), f32, dev),
        None if drop_path is None else operand(drop_path, "drop_path", (bsz,), f32, dev),
    ]
    px = check(x, "x", (bsz, h, w, c), dt, dev)
    pg = check(g, "g", (bsz, h, w, c), dt, dev)
    ws16 = window_size == KERNEL_WINDOW16
    t_elems, f_elems = _LL(), _LL()
    if ws16:
        lib = _build.load("attn_bwd16", _SIGNATURES16, _RESTYPES16)
        lib.attn_bwd16_scratch(bsz, h, w, c, heads, window_size, ctypes.byref(t_elems), ctypes.byref(f_elems))
    else:
        lib = _build.load("attn_bwd", _SIGNATURES, _RESTYPES)
        lib.attn_bwd_scratch(bsz, h, w, c, heads, ctypes.byref(t_elems), ctypes.byref(f_elems))
    tscratch = torch.empty(t_elems.value, dtype=dt, device=dev)
    fscratch = torch.empty(f_elems.value, dtype=f32, device=dev)
    dx = torch.empty_like(x)
    ds_db = torch.empty(2 * c, dtype=f32, device=dev)
    dwqkv, dbqkv = torch.empty(c, 3 * c, dtype=f32, device=dev), torch.empty(3 * c, dtype=f32, device=dev)
    dwproj, dbproj = torch.empty(c, c, dtype=f32, device=dev), torch.empty(c, dtype=f32, device=dev)
    dbias = torch.empty(heads, n, n, dtype=f32, device=dev)
    bf16 = dt == torch.bfloat16
    if ws16:
        fn, geometry = lib.attn_bwd16_bf16 if bf16 else lib.attn_bwd16_f32, (heads, window_size, shift)
    else:
        fn, geometry = lib.attn_bwd_bf16 if bf16 else lib.attn_bwd_f32, (heads, shift)
    ptrs = [None if t is None else t.data_ptr() for t in ops]
    status = fn(
        px, pg, dx.data_ptr(), bsz, h, w, c, *geometry, *ptrs, ds_db.data_ptr(), dwqkv.data_ptr(),
        dbqkv.data_ptr(), dwproj.data_ptr(), dbproj.data_ptr(), dbias.data_ptr(), tscratch.data_ptr(),
        t_elems.value, fscratch.data_ptr(), f_elems.value, stream(dev),
    )
    finish("attention_bwd_ws16" if ws16 else "attention_bwd", status)
    return dx, ds_db[:c], ds_db[c:], dwqkv, dbqkv, dwproj, dbproj, dbias
