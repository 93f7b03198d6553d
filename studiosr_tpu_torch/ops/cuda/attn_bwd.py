"""B8 and B9: the backward of B5 with the forward recomputed (CUDA kernels
``csrc/attn_bwd_mma.cu`` in bf16 at every window; ``csrc/attn_bwd_f32.cu``
in f32 at windows 2 to 16; ``csrc/attn_bwd.cu`` at windows 2 to 8 and
``csrc/attn_bwd16.cu`` from 9 at wider heads, and the latter in f32 from 17).

Replaces ``studiosr_tpu/ops/pallas/attn_bwd.py::pairs_attention_bwd`` (B8,
windows with 2 ws^2 <= 128: 2 to 8) and ``::v5_attention_bwd`` (B9, the
larger windows: 9 to 16, HAT's 16, and from 17 on ``csrc/lb_core.cuh``'s
two-formation core, each score tile formed twice (B13's large family shares
it; :func:`large_partition` mirrors its blocks), MaxSR adaptive above a 256
x 256 crop, HAT at window 24). For
y = x + d_b * proj(WA(LN x)) on (B, H, W, C) maps, with ``shift`` and
``drop_path`` as in ``ops/cuda/window_attention.py`` (the output aligned
with the input), and the cotangent ``g`` of y, it returns

    (dx, d ln_w, d ln_b, d wqkv, d bqkv, d wproj, d bproj, d bias)

with dx in ``x.dtype`` and the parameter gradients in f32 (the caller casts
each to its parameter's dtype); d bias is (heads, N, N), the gradient of the
gathered rel-pos bias (autograd of ``gather_rel_bias`` scatters it into the
(2 ws - 1)^2 table). ``wqkv`` is unscaled, so its q columns need no
re-scaling. The kernels sum their partials in a fixed order, so the result
is the same from run to run. Launches at windows 2 to 8 count as
``attention_bwd``, at 9 to 16 as ``attention_bwd_ws16`` and from 17 as
``attention_bwd_large`` (``window_attention.window_family``).

Routing, by dtype and geometry, never by a failure: bf16 with a head dim up
to 32 and C a multiple of 4 up to 184 (:func:`mma_takes`) launches the
kernels written for the H100, ``csrc/attn_bwd_mma.cu`` (C entries
``attn_bwd_mma_bf16`` at windows 2 to 8, ``attn_bwd16_mma_bf16`` at 9 to 16,
``attn_bwd_large_mma_bf16`` from 17); f32 at windows 2 to 16 with a head
dim up to 32 and C a multiple of 4 up to 256 (:func:`f32_mma_takes`:
SwinFIR's recipe, HAT's f32 step at window 16, and every f32 width the paths
train) launches ``csrc/attn_bwd_f32.cu`` (``attn_bwd_mma_f32`` at windows 2
to 8, ``attn_bwd16_mma_f32`` at 9 to 16, its attention core in two sweeps,
``csrc/tf_window16.cuh``'s ``tw_rows_kernel`` then ``ab16_main_kernel``:
every product in 3xTF32 on the tensor cores, the row products on wgmma, the
weights packed and split by :func:`_f32_pack_index`'s rule);
other geometries launch ``attn_bwd_bf16`` / ``attn_bwd16_bf16`` /
``attn_bwd_large_bf16`` and the ``_f32`` entries, by the same split. Each
launch is counted under its C entry (``engagement.entries()``). The H100
kernels read the weights packed per call (:func:`pack_attn_bwd_weights`'s
rule, gathered on the card by the entry itself), read a bf16 bias (the bf16
step's) as it is and any other in f32, and return the weight gradients
with each head padded to pad16(d), which the wrapper drops.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from studiosr_tpu_torch.ops.cuda import _build, large_bwd, tf32x3
from studiosr_tpu_torch.ops.cuda._launch import P, I, aligned, check, finish, operand, STREAM, call
from studiosr_tpu_torch.ops.cuda.window_attention import (
    _NP_WIDTHS, FAMILY_STEM, _image, _pad16, check_window_map, f32_mma_takes, f32_wqkv_index, large_window, mma_takes,
    window_family,
)
from studiosr_tpu_torch.ops.windows import calculate_mask, window_partition, window_reverse

__all__ = ["attention_bwd", "attention_bwd_plain", "window_bwd_math", "mma_takes", "f32_mma_takes",
           "pack_attn_bwd_weights", "pack_attn_bwd_f32_weights",
           "large_partition", "large_plan"]

_LL = ctypes.c_longlong
_ARGS = (P, P, P, I, I, I, I, I, I, I) + (P,) * 7 + (P,) * 6 + (P, _LL, P, _LL, P)
_SIGNATURES = {
    "attn_bwd_f32": _ARGS,
    "attn_bwd_bf16": _ARGS,
    "attn_bwd_scratch": (I, I, I, I, I, I, ctypes.POINTER(_LL), ctypes.POINTER(_LL)),
}
_RESTYPES = {"attn_bwd_scratch": None}
_ARGS16 = (P, P, P, I, I, I, I, I, I, I) + (P,) * 7 + (P,) * 6 + (P, _LL, P, _LL, P)
_SIGNATURES16 = {
    "attn_bwd16_f32": _ARGS16,
    "attn_bwd16_bf16": _ARGS16,
    "attn_bwd_large_f32": _ARGS16,
    "attn_bwd_large_bf16": _ARGS16,
    "attn_bwd16_scratch": (I, I, I, I, I, I, ctypes.POINTER(_LL), ctypes.POINTER(_LL)),
}
_RESTYPES16 = {"attn_bwd16_scratch": None}
_ARGS_MMA = (P, P, P) + (I,) * 8 + (P,) * 8 + (_LL,) + (P,) * 6 + (P, _LL, P, _LL, P)
_SIGNATURES_MMA = {
    "attn_bwd_mma_bf16": _ARGS_MMA,
    "attn_bwd16_mma_bf16": _ARGS_MMA,
    "attn_bwd_large_mma_bf16": _ARGS_MMA,
    "attn_bwd_mma_scratch": (I, I, I, I, I, I, ctypes.POINTER(_LL), ctypes.POINTER(_LL)),
    "attn_bwd_mma_pack_elems": (I, I),
}
_RESTYPES_MMA = {"attn_bwd_mma_pack_elems": _LL}
_ARGS_F32 = (P, P, P) + (I,) * 7 + (P,) * 8 + (_LL,) + (P,) * 6 + (P, _LL, P)
_SIGNATURES_F32 = {
    "attn_bwd_mma_f32": _ARGS_F32,
    "attn_bwd16_mma_f32": _ARGS_F32,
    "attn_bwd_mma_f32_scratch": (I, I, I, I, I, I, ctypes.POINTER(_LL)),
    "attn_bwd_mma_f32_pack_elems": (I, I),
}
_RESTYPES_F32 = {"attn_bwd_mma_f32_pack_elems": _LL}
_KROWS, _KSTAGE = 96, 64  # K rows of a projection stage and of a dln stage (AM_KROWS, AM_KSTAGE)


def _f32_products(c: int, heads: int) -> list:
    """(K, N) of the f32 kernel's row products, each head padded to DP =
    pad16(d), HD = heads DP: q|k|v = LN Wqkv (C x 3 HD), dattn = g_b
    Wproj^T (C x HD), dln = dqkv Wqkv^T (3 HD x C)."""
    hd = heads * _pad16(c // heads)
    return [(c, 3 * hd), (c, hd), (3 * hd, c)]


@functools.lru_cache(maxsize=None)
def _f32_pack_index(c: int, heads: int) -> np.ndarray:
    """For each hi value of the f32 kernel's packed weights, its flat index
    into ``cat(wqkv.flatten(), wproj.flatten())`` (wqkv (C, 3C), wproj (C,
    C)), or 4 C^2 for a zero. With d = C / heads, DP = pad16(d), HD = heads
    DP, the row products' K x N weights, each head's columns (or rows)
    padded from d to DP with zeros: Wqkv (C x 3 HD, [r, p HD + h DP + j] =
    wqkv[r, p C + h d + j]), Wproj^T (C x HD, [r, h DP + j] = wproj[h d + j,
    r]) and Wqkv^T (3 HD x C, the first one transposed), each in
    ``tfw_pack``'s image order (``tf32x3.tfw_image_index``)."""
    d, dp = c // heads, _pad16(c // heads)
    hd, zero = heads * dp, 4 * c * c
    r = np.arange(c)[:, None]
    wq = f32_wqkv_index(c, heads)  # the forward's Wqkv (B5 f32's)
    pcol = np.arange(hd)
    ph, pj = pcol // dp, pcol % dp
    wpt = np.where((pj < d)[None], 3 * c * c + (ph * d + pj)[None] * c + r, zero)
    return np.concatenate([tf32x3.tfw_image_index(m, zero) for m in (wq, wpt, wq.T)])


def pack_attn_bwd_f32_weights(wqkv: torch.Tensor, wproj: torch.Tensor, heads: int) -> torch.Tensor:
    """The f32 kernel's packed weights (f32): the values :func:`_f32_pack_index`
    gathers, each stage block as its hi then its lo image
    (``tf32x3.pack_images``); the entry packs the same on the card on every
    call, this is its plain version."""
    c = wqkv.shape[0]
    src = torch.cat([wqkv.reshape(-1), wproj.to(wqkv.dtype).reshape(-1), wqkv.new_zeros(1)]).float()
    return tf32x3.pack_images(src[torch.from_numpy(_f32_pack_index(c, heads)).to(src.device)],
                              _f32_products(c, heads))


@functools.lru_cache(maxsize=None)
def _pack_index(c: int, heads: int) -> np.ndarray:
    """For each element of the packed weights, its flat index into
    ``cat(wqkv.flatten(), wproj.flatten())`` (wqkv (C, 3C), wproj (C, C)), or
    4 C^2 for a zero. Per head h (d = C / heads, DP = pad16(d), KC =
    pad16(C)), in stages of 96 K rows: its q|k|v columns as B of LN @ Wqkv,
    a K-major image of the stage's rows x 3 DP, column p DP + j =
    wqkv[:, p C + h d + j] (zero for j >= d); then its rows of Wproj as B
    of g_b @ Wproj^T, rows x DP, column j = wproj[h d + j, :]. Then Wqkv^T
    as B of dqkv @ Wqkv^T (K = 3 heads DP padded dq|dk|dv columns, N = the
    product width NP >= C) in stages of 64 K rows, each a K-major image:
    row p heads DP + h DP + j, column n = wqkv[n, p C + h d + j]."""
    d, dp, kc = c // heads, _pad16(c // heads), _pad16(c)
    hd = heads * dp
    npw = next(w for w in _NP_WIDTHS if c <= w)
    zero = 4 * c * c
    parts = []
    for h in range(heads):
        for k0 in range(0, kc, _KROWS):
            rows = min(_KROWS, kc - k0)
            k, n = np.meshgrid(np.arange(rows), np.arange(3 * dp), indexing="ij")
            p, j, r = n // dp, n % dp, k0 + k
            parts.append(_image(k, n, rows, np.where((r < c) & (j < d), r * 3 * c + p * c + h * d + j, zero)))
            k, j = np.meshgrid(np.arange(rows), np.arange(dp), indexing="ij")
            r = k0 + k
            parts.append(_image(k, j, rows, np.where((r < c) & (j < d), 3 * c * c + (h * d + j) * c + r, zero)))
    for s0 in range(0, 3 * hd, _KSTAGE):
        rows = min(_KSTAGE, 3 * hd - s0)
        k, n = np.meshgrid(np.arange(rows), np.arange(npw), indexing="ij")
        col = s0 + k
        p, h, j = col // hd, (col % hd) // dp, col % dp
        parts.append(_image(k, n, rows, np.where((j < d) & (n < c), n * 3 * c + p * c + h * d + j, zero)))
    return np.concatenate(parts)


def pack_attn_bwd_weights(wqkv: torch.Tensor, wproj: torch.Tensor, heads: int) -> torch.Tensor:
    """The packed weights the H100 kernels stream (the rule of
    :func:`_pack_index`), as a 1-D tensor of ``wqkv``'s dtype. The entry
    gathers the same on the card on every call; this is its plain version."""
    c = wqkv.shape[0]
    src = torch.cat([wqkv.reshape(-1), wproj.to(wqkv.dtype).reshape(-1), wqkv.new_zeros(1)])
    return src[torch.from_numpy(_pack_index(c, heads)).to(src.device)]


@functools.lru_cache(maxsize=None)
def _device_pack_index(c: int, heads: int, dev: torch.device, f32: bool = False) -> torch.Tensor:
    """:func:`_pack_index` (``f32``: :func:`_f32_pack_index`) as an int32
    tensor on ``dev``, for the entry's gather."""
    index = _f32_pack_index(c, heads) if f32 else _pack_index(c, heads)
    return torch.from_numpy(index.astype(np.int32)).to(dev)


def large_plan(windows: int, c: int, heads: int, ws: int, sms: int = 132) -> large_bwd.Plan:
    """The plan of ``attn_bwd_large_mma_bf16``'s attention core (windows
    from 17): ``windows`` windows of ceil(ws^2 / 64) query tiles and key
    chunks, the head dim padded to 16 or 32; its ``f_elems`` are the f32
    scratch the entry adds for the core."""
    tiles = -(-ws * ws // 64)
    return large_bwd.plan(windows, heads, tiles, tiles, _pad16(c // heads), sms)


def large_partition(windows: int, c: int, heads: int, ws: int, sms: int = 132) -> dict:
    """The core's passes at window ``ws`` as their blocks take them
    (``large_bwd.partition``)."""
    tiles = -(-ws * ws // 64)
    return large_bwd.partition(windows, heads, tiles, tiles, _pad16(c // heads), sms)


def _split_heads(t, heads: int):
    nw, n, c = t.shape
    return t.reshape(nw, n, heads, c // heads).transpose(1, 2)  # (nw, heads, n, d)


def _merge_heads(t):
    nw, heads, n, d = t.shape
    return t.transpose(1, 2).reshape(nw, n, heads * d)


def window_bwd_math(x, s, b, wqkv, bqkv, wproj, bias, mask, heads: int, g, mm=torch.matmul):
    """``studiosr_tpu/ops/attn_vjp.py::_window_bwd_math`` in f32 on (nW, N, C)
    windows (``mask`` (nW_img, N, N) repeats over the batch, or None):
    grads of x + proj(WA(LN x)) for (x, s, b, wqkv, bqkv, wproj, bproj, bias).
    ``mm`` takes each product (``tf32x3.matmul`` repeats the f32 kernel's
    arithmetic)."""
    nw, n, c = x.shape
    d = c // heads
    scale = float(d) ** -0.5
    x32, g32 = x.float(), g.float()
    s, wqkv, wproj = s.float(), wqkv.float(), wproj.float()
    mu = x32.mean(-1, keepdim=True)
    inv = torch.rsqrt((x32 - mu).square().mean(-1, keepdim=True) + 1e-5)
    xhat = (x32 - mu) * inv
    ln = xhat * s + b.float()
    qkv = mm(ln, wqkv) + bqkv.float()
    q = _split_heads(qkv[..., :c], heads) * scale
    k = _split_heads(qkv[..., c : 2 * c], heads)
    v = _split_heads(qkv[..., 2 * c :], heads)
    scores = mm(q, k.transpose(-1, -2)) + bias.float()[None]
    if mask is not None:
        scores = (scores.reshape(-1, mask.shape[0], heads, n, n) + mask.float()[None, :, None]).reshape(scores.shape)
    probs = torch.softmax(scores, dim=-1)
    attn = _merge_heads(mm(probs, v))

    dwproj = torch.einsum("wnc,wnk->ck", attn, g32) if mm is torch.matmul else mm(
        attn.reshape(-1, c).t(), g32.reshape(-1, c))
    dbproj = g32.sum((0, 1))
    dav = _split_heads(mm(g32, wproj.t()), heads)
    dv = mm(probs.transpose(-1, -2), dav)
    dprobs = mm(dav, v.transpose(-1, -2))
    dscores = probs * (dprobs - (dprobs * probs).sum(-1, keepdim=True))
    dbias = dscores.sum(0)
    dq = mm(dscores, k) * scale
    dk = mm(dscores.transpose(-1, -2), q)
    dqkv = torch.cat([_merge_heads(dq), _merge_heads(dk), _merge_heads(dv)], dim=-1)
    dwqkv = torch.einsum("wnc,wnk->ck", ln, dqkv) if mm is torch.matmul else mm(
        ln.reshape(-1, c).t(), dqkv.reshape(-1, 3 * c))
    dbqkv = dqkv.sum((0, 1))
    dln = mm(dqkv, wqkv.t())
    dxhat = dln * s
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = g32 + (dxhat - m1 - xhat * m2) * inv
    return dx, (dln * xhat).sum((0, 1)), dln.sum((0, 1)), dwqkv, dbqkv, dwproj, dbproj, dbias


def attention_bwd_plain(
    x, g, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, *, heads: int, window_size: int, shift: int = 0, drop_path=None,
    mm=torch.matmul,
):
    """Plain PyTorch version: roll, partition, :func:`window_bwd_math` (its
    products by ``mm``) with the branch cotangent d g, reverse, roll back,
    plus (1 - d) g."""
    del bproj  # the bias of proj does not enter the gradients
    bsz, h, w, c = x.shape
    ws = window_size
    g32 = g.float()
    dd = None if drop_path is None else drop_path.float().reshape(-1, 1, 1, 1)
    gb = g32 if dd is None else dd * g32
    roll = (lambda t: torch.roll(t, (-shift, -shift), dims=(1, 2))) if shift else (lambda t: t)
    mask = torch.from_numpy(calculate_mask((h, w), ws, shift)).to(x.device) if shift else None
    parts = lambda t: window_partition(roll(t), ws).reshape(-1, ws * ws, c)  # noqa: E731
    dzw, *grads = window_bwd_math(parts(x.float()), ln_w, ln_b, wqkv, bqkv, wproj, bias, mask, heads, parts(gb), mm)
    dx = window_reverse(dzw.reshape(-1, ws, ws, c), ws, h, w)
    if shift:
        dx = torch.roll(dx, (shift, shift), dims=(1, 2))
    if dd is not None:
        dx = dx + (1.0 - dd) * g32
    return (dx.to(x.dtype), *grads)


def attention_bwd(
    x, g, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, *, heads: int, window_size: int, shift: int = 0, drop_path=None
):
    """CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. A launch counts under ``attention_bwd`` at windows 2 to 8, under
    ``attention_bwd_ws16`` at 9 to 16 and under ``attention_bwd_large`` from
    17."""
    kw = dict(heads=heads, window_size=window_size, shift=shift, drop_path=drop_path)
    if x.device.type == "cpu":
        return attention_bwd_plain(x, g, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, **kw)
    check_window_map("attention_bwd", x, heads, window_size, shift)
    bsz, h, w, c = x.shape
    n = window_size * window_size
    dev, dt, f32 = x.device, x.dtype, torch.float32
    mma = dt == torch.bfloat16 and mma_takes(c, heads)
    # the H100 kernels read a bf16 bias (the bf16 step's) as it is
    bias_dt = torch.bfloat16 if mma and getattr(bias, "dtype", None) == torch.bfloat16 else f32
    ops = [
        operand(ln_w, "ln_w", (c,), f32, dev), operand(ln_b, "ln_b", (c,), f32, dev),
        operand(wqkv, "wqkv", (c, 3 * c), dt, dev), operand(bqkv, "bqkv", (3 * c,), f32, dev),
        operand(wproj, "wproj", (c, c), dt, dev), operand(bias, "bias", (heads, n, n), bias_dt, dev),
        None if drop_path is None else operand(drop_path, "drop_path", (bsz,), f32, dev),
    ]
    px = check(x, "x", (bsz, h, w, c), dt, dev)
    pg = check(g, "g", (bsz, h, w, c), dt, dev)
    ws16, family = large_window(window_size), window_family(window_size)
    name = "attention_bwd" + family
    dx = torch.empty_like(x)
    ds_db = torch.empty(2 * c, dtype=f32, device=dev)
    dbproj = torch.empty(c, dtype=f32, device=dev)
    dbias = torch.empty(heads, n, n, dtype=f32, device=dev)
    ptrs = [None if t is None else t.data_ptr() for t in ops]
    t_elems, f_elems = _LL(), _LL()
    if mma:
        return _attention_bwd_mma(px, pg, dx, x.shape, heads, window_size, shift, ops, ds_db, dbproj, dbias, name)
    if dt == f32 and f32_mma_takes(c, heads, window_size):
        return _attention_bwd_f32(x, g, dx, heads, window_size, shift, ops, ds_db, dbproj, dbias, name)
    if ws16:
        lib = _build.load("attn_bwd16", _SIGNATURES16, _RESTYPES16)
        call(dev, lib.attn_bwd16_scratch, bsz, h, w, c, heads, window_size, ctypes.byref(t_elems),
             ctypes.byref(f_elems))
    else:
        lib = _build.load("attn_bwd", _SIGNATURES, _RESTYPES)
        call(dev, lib.attn_bwd_scratch, bsz, h, w, c, heads, window_size, ctypes.byref(t_elems), ctypes.byref(f_elems))
    tscratch = torch.empty(t_elems.value, dtype=dt, device=dev)
    fscratch = torch.empty(f_elems.value, dtype=f32, device=dev)
    dwqkv, dbqkv = torch.empty(c, 3 * c, dtype=f32, device=dev), torch.empty(3 * c, dtype=f32, device=dev)
    dwproj = torch.empty(c, c, dtype=f32, device=dev)
    entry = "attn_bwd" + FAMILY_STEM[family] + ("_bf16" if dt == torch.bfloat16 else "_f32")
    status = call(dev, getattr(lib, entry), px, pg, dx.data_ptr(), bsz, h, w, c, heads, window_size, shift, *ptrs,
                  ds_db.data_ptr(), dwqkv.data_ptr(), dbqkv.data_ptr(), dwproj.data_ptr(), dbproj.data_ptr(),
                  dbias.data_ptr(), tscratch.data_ptr(), t_elems.value, fscratch.data_ptr(), f_elems.value, STREAM)
    finish(name, status, entry)
    return dx, ds_db[:c], ds_db[c:], dwqkv, dbqkv, dwproj, dbproj, dbias


def _attention_bwd_mma(px, pg, dx, shape, heads, window_size, shift, ops, ds_db, dbproj, dbias, name):
    """The launch of ``csrc/attn_bwd_mma.cu`` (bf16, :func:`mma_takes`):
    the weight gradients come back with each head padded to pad16(d) and are
    cut here."""
    bsz, h, w, c = shape
    d, dp = c // heads, _pad16(c // heads)
    hd, dev, f32 = heads * dp, dx.device, torch.float32
    ln_w, ln_b, wqkv, bqkv, wproj, bias, drop = ops
    lib = _build.load("attn_bwd_mma", _SIGNATURES_MMA, _RESTYPES_MMA)
    index = _device_pack_index(c, heads, dev)
    if call(dev, lib.attn_bwd_mma_pack_elems, c, heads) != index.numel():
        raise RuntimeError(f"{name}: the packed weights of C {c}, {heads} heads disagree with the kernel's layout")
    t_elems, f_elems = _LL(), _LL()
    status = call(dev, lib.attn_bwd_mma_scratch, bsz, h, w, c, heads, window_size, ctypes.byref(t_elems),
                  ctypes.byref(f_elems))
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} while sizing the scratch")
    tscratch = torch.empty(t_elems.value, dtype=dx.dtype, device=dev)
    fscratch = torch.empty(f_elems.value, dtype=f32, device=dev)
    dwqkv = torch.empty(c, 3 * hd, dtype=f32, device=dev)
    dbqkv = torch.empty(3 * hd, dtype=f32, device=dev)
    dwproj = torch.empty(hd, c, dtype=f32, device=dev)
    entry = "attn_bwd" + FAMILY_STEM[window_family(window_size)] + "_mma_bf16"
    status = call(dev, getattr(lib, entry), px, pg, dx.data_ptr(), bsz, h, w, c, heads, window_size, shift,
                  int(bias.dtype == torch.bfloat16), ln_w.data_ptr(), ln_b.data_ptr(), bqkv.data_ptr(), bias.data_ptr(),
                  None if drop is None else drop.data_ptr(), wqkv.data_ptr(), wproj.data_ptr(), index.data_ptr(),
                  index.numel(), ds_db.data_ptr(), dwqkv.data_ptr(), dbqkv.data_ptr(), dwproj.data_ptr(),
                  dbproj.data_ptr(), dbias.data_ptr(), tscratch.data_ptr(), t_elems.value, fscratch.data_ptr(),
                  f_elems.value, STREAM)
    finish(name, status, entry)
    dwqkv = dwqkv.view(c, 3, heads, dp)[..., :d].reshape(c, 3 * c)
    dbqkv = dbqkv.view(3, heads, dp)[..., :d].reshape(3 * c)
    dwproj = dwproj.view(heads, dp, c)[:, :d].reshape(c, c)
    return dx, ds_db[:c], ds_db[c:], dwqkv, dbqkv, dwproj, dbproj, dbias


def _attention_bwd_f32(x, g, dx, heads, window_size, shift, ops, ds_db, dbproj, dbias, name):
    """The launch of ``csrc/attn_bwd_f32.cu`` (f32, :func:`f32_mma_takes`;
    ``attn_bwd_mma_f32`` at windows 2 to 8, ``attn_bwd16_mma_f32`` at 9 to
    16): the weight gradients come back with each head padded to pad16(d)
    and are cut here."""
    bsz, h, w, c = x.shape
    d, dp = c // heads, _pad16(c // heads)
    hd, dev, f32 = heads * dp, dx.device, torch.float32
    ln_w, ln_b, wqkv, bqkv, wproj, bias, drop = ops
    lib = _build.load("attn_bwd_f32", _SIGNATURES_F32, _RESTYPES_F32)
    index = _device_pack_index(c, heads, dev, True)
    if call(dev, lib.attn_bwd_mma_f32_pack_elems, c, heads) != index.numel():
        raise RuntimeError(f"{name}: the f32 packed weights of C {c}, {heads} heads disagree with the kernel's layout")
    f_elems = _LL()
    status = call(dev, lib.attn_bwd_mma_f32_scratch, bsz, h, w, c, heads, window_size, ctypes.byref(f_elems))
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} while sizing the scratch")
    fscratch = torch.empty(f_elems.value, dtype=f32, device=dev)
    dwqkv = torch.empty(c, 3 * hd, dtype=f32, device=dev)
    dbqkv = torch.empty(3 * hd, dtype=f32, device=dev)
    dwproj = torch.empty(hd, c, dtype=f32, device=dev)
    xa, ga, wa, ba = aligned(x), aligned(g), aligned(ln_w), aligned(ln_b)
    entry = "attn_bwd" + FAMILY_STEM[window_family(window_size)] + "_mma_f32"
    status = call(dev, getattr(lib, entry), xa.data_ptr(), ga.data_ptr(), dx.data_ptr(), bsz, h, w, c, heads,
                  window_size, shift, wa.data_ptr(), ba.data_ptr(), bqkv.data_ptr(), bias.data_ptr(),
                  None if drop is None else drop.data_ptr(), wqkv.data_ptr(), wproj.data_ptr(), index.data_ptr(),
                  index.numel(), ds_db.data_ptr(), dwqkv.data_ptr(), dbqkv.data_ptr(), dwproj.data_ptr(),
                  dbproj.data_ptr(), dbias.data_ptr(), fscratch.data_ptr(), f_elems.value, STREAM)
    finish(name, status, entry)
    dwqkv = dwqkv.view(c, 3, heads, dp)[..., :d].reshape(c, 3 * c)
    dbqkv = dbqkv.view(3, heads, dp)[..., :d].reshape(3 * c)
    dwproj = dwproj.view(heads, dp, c)[:, :d].reshape(c, c)
    return dx, ds_db[:c], ds_db[c:], dwqkv, dbqkv, dwproj, dbproj, dbias
