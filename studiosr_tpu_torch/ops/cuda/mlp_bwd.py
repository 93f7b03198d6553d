"""B7: the backward of B6 with the forward recomputed (CUDA kernels ``csrc/mlp_bwd_mma.cu``
in bf16, ``csrc/mlp_bwd_f32.cu`` in f32, ``csrc/mlp_bwd.cu`` at other widths).

Replaces ``studiosr_tpu/ops/pallas/mlp_vjp.py::_bwd`` (reached through
``_dp_bwd``). For y = x + d * fc2(gelu(fc1(LN x))) on x (rows, C), with
``drop_path`` / ``rows_per_sample`` as in ``ops/cuda/mlp_block.py``, and
the cotangent ``g`` of y, it returns

    (dx, d ln_w, d ln_b, d w1, d b1, d w2, d b2)

with dx in ``x.dtype`` and the parameter gradients in f32 (the caller casts
each to its parameter's dtype). The kernels sum their weight-gradient
partials in a fixed order, so the result is the same from run to run.

Routing, by dtype and geometry, never by a failure: bf16 with C a multiple
of 4 up to 184 and a hidden width up to 512 (:func:`mma_takes`) launches
the kernel written for the H100, ``csrc/mlp_bwd_mma.cu`` (C entry
``mlp_bwd_mma_bf16``), which reads the weights packed on every call by
:func:`_pack_index`'s rule (gathered on the card by the entry); f32 with C
a multiple of 4 up to 256 (:func:`f32_mma_takes`: SwinFIR's recipe, and
every f32 width the paths train) launches ``csrc/mlp_bwd_f32.cu``
(``mlp_bwd_mma_f32``: every product in 3xTF32 on the tensor cores, the row
products on wgmma, the weights packed and split by
:func:`_f32_pack_index`'s rule); other geometries launch
``mlp_bwd_bf16`` / ``mlp_bwd_f32`` (``csrc/mlp_bwd.cu``). Each launch is
counted under its C entry (``engagement.entries()``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from studiosr_tpu_torch.ops.cuda import _build, tf32x3
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, aligned, check, finish, operand, STREAM, call
from studiosr_tpu_torch.ops.cuda.mlp_block import row_scales
from studiosr_tpu_torch.ops.cuda.window_attention import _NP_WIDTHS, _image, _pad16

__all__ = ["mlp_bwd", "mlp_bwd_plain", "mma_takes", "f32_mma_takes", "pack_mlp_bwd_weights", "pack_mlp_bwd_f32_weights"]

_LL = ctypes.c_longlong
_ARGS = (P, P, P, I, I, I) + (P,) * 6 + (I,) + (P,) * 5 + (P, _LL, P, _LL, P)
_SIGNATURES = {
    "mlp_bwd_f32": _ARGS,
    "mlp_bwd_bf16": _ARGS,
    "mlp_bwd_scratch": (I, I, I, ctypes.POINTER(_LL), ctypes.POINTER(_LL)),
}
_RESTYPES = {"mlp_bwd_scratch": None}
_ARGS_MMA = (P, P, P, I, I, I) + (P,) * 6 + (I, P, _LL) + (P,) * 5 + (P, _LL, P, _LL, P)
_SIGNATURES_MMA = {
    "mlp_bwd_mma_bf16": _ARGS_MMA,
    "mlp_bwd_mma_scratch": (I, I, I, ctypes.POINTER(_LL), ctypes.POINTER(_LL)),
    "mlp_bwd_mma_pack_elems": (I, I),
}
_RESTYPES_MMA = {"mlp_bwd_mma_pack_elems": _LL}
_ARGS_F32 = (P, P, P, I, I, I) + (P,) * 6 + (I, P, _LL) + (P,) * 5 + (P, _LL, P)
_SIGNATURES_F32 = {
    "mlp_bwd_mma_f32": _ARGS_F32,
    "mlp_bwd_mma_f32_scratch": (I, I, I, ctypes.POINTER(_LL)),
    "mlp_bwd_mma_f32_pack_elems": (I, I),
}
_RESTYPES_F32 = {"mlp_bwd_mma_f32_pack_elems": _LL}
MMA_MAX_C, MMA_MAX_HIDDEN = 184, 512
F32_MAX_C = 256  # csrc/tf32x3.cuh TF_MAX_C
_CHUNK, _KSTAGE = 96, 64  # hidden units a product chunk (MB_CHUNK), K rows a weight stage (AM_KSTAGE)
_INV_SQRT2PI = 0.3989422804014327


def mma_takes(c: int, hidden: int) -> bool:
    """Whether the bf16 kernel written for the H100 takes this geometry: C a
    multiple of 4 up to 184 and a hidden width up to 512."""
    return c % 4 == 0 and 4 <= c <= MMA_MAX_C and 1 <= hidden <= MMA_MAX_HIDDEN


def f32_mma_takes(c: int, hidden: int) -> bool:
    """Whether the f32 kernel written for the H100 takes this geometry: C a
    multiple of 4 up to 256, any hidden width."""
    return c % 4 == 0 and 4 <= c <= F32_MAX_C and hidden >= 1


def _f32_products(c: int, hidden: int) -> list:
    """(K, N) of the f32 kernel's row products: h1 = LN W1, dg1 = g_b W2^T,
    dln = dh1 W1^T, with HP the hidden width padded to 4."""
    hp = -(-hidden // 4) * 4
    return [(c, hp), (c, hp), (hp, c)]


@functools.lru_cache(maxsize=None)
def _f32_pack_index(c: int, hidden: int) -> np.ndarray:
    """For each hi value of the f32 kernel's packed weights, its flat index
    into ``cat(w1.flatten(), w2.flatten())`` (w1 (C, hidden), w2 (hidden,
    C)), or 2 C hidden for a zero: the row products' K x N weights W1 (C x
    HP, [r, j] = w1[r, j]), W2^T (C x HP, [r, j] = w2[j, r]) and W1^T (HP x
    C, [j, r] = w1[r, j]), zero at j >= hidden, each in ``tfw_pack``'s image
    order (``tf32x3.tfw_image_index``)."""
    hp = -(-hidden // 4) * 4
    zero = 2 * c * hidden
    r, j = np.meshgrid(np.arange(c), np.arange(hp), indexing="ij")
    ok = j < hidden
    w1 = np.where(ok, r * hidden + j, zero)
    w2t = np.where(ok, c * hidden + j * c + r, zero)
    return np.concatenate([tf32x3.tfw_image_index(m, zero) for m in (w1, w2t, w1.T)])


def pack_mlp_bwd_f32_weights(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The f32 kernel's packed weights (f32): the values :func:`_f32_pack_index`
    gathers, each stage block as its hi then its lo image
    (``tf32x3.pack_images``); the entry packs the same on the card on every
    call, this is its plain version."""
    c, hidden = w1.shape
    src = torch.cat([w1.reshape(-1), w2.to(w1.dtype).reshape(-1), w1.new_zeros(1)]).float()
    return tf32x3.pack_images(src[torch.from_numpy(_f32_pack_index(c, hidden)).to(src.device)],
                              _f32_products(c, hidden))


@functools.lru_cache(maxsize=None)
def _pack_index(c: int, hidden: int) -> np.ndarray:
    """For each element of the packed weights, its flat index into
    ``cat(w1.flatten(), w2.flatten())`` (w1 (C, hidden), w2 (hidden, C)), or
    2 C hidden for a zero. With KC = pad16(C) and HP = pad16(hidden): per
    chunk of 96 hidden units (HP / 96 rounded up), in stages of 64 K rows of
    KC, W1's columns of the chunk as B of LN @ W1 (a K-major image of the
    stage's rows x 96, column n = w1[:, 96 chunk + n]), then W2^T's as B of
    g_b @ W2^T (rows x 96, column n = w2[96 chunk + n, :]). Then W1^T as B
    of dh1 @ W1^T (K = HP, N = the product width NP >= C) in stages of 64 K
    rows, each a K-major image: row j, column n = w1[n, j]."""
    kc, hp = _pad16(c), _pad16(hidden)
    npw = next(w for w in _NP_WIDTHS if c <= w)
    zero = 2 * c * hidden
    parts = []
    for ch in range(-(-hp // _CHUNK)):
        for k0 in range(0, kc, _KSTAGE):
            rows = min(_KSTAGE, kc - k0)
            k, n = np.meshgrid(np.arange(rows), np.arange(_CHUNK), indexing="ij")
            r, j = k0 + k, _CHUNK * ch + n
            ok = (r < c) & (j < hidden)
            parts.append(_image(k, n, rows, np.where(ok, r * hidden + j, zero)))
            parts.append(_image(k, n, rows, np.where(ok, c * hidden + j * c + r, zero)))
    for s0 in range(0, hp, _KSTAGE):
        rows = min(_KSTAGE, hp - s0)
        k, n = np.meshgrid(np.arange(rows), np.arange(npw), indexing="ij")
        j = s0 + k
        parts.append(_image(k, n, rows, np.where((j < hidden) & (n < c), n * hidden + j, zero)))
    return np.concatenate(parts)


def pack_mlp_bwd_weights(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The packed weights the H100 kernel streams (the rule of
    :func:`_pack_index`), as a 1-D tensor of ``w1``'s dtype. The entry
    gathers the same on the card on every call; this is its plain version."""
    c, hidden = w1.shape
    src = torch.cat([w1.reshape(-1), w2.to(w1.dtype).reshape(-1), w1.new_zeros(1)])
    return src[torch.from_numpy(_pack_index(c, hidden)).to(src.device)]


@functools.lru_cache(maxsize=None)
def _device_pack_index(c: int, hidden: int, dev: torch.device, f32: bool = False) -> torch.Tensor:
    """:func:`_pack_index` (``f32``: :func:`_f32_pack_index`) as an int32
    tensor on ``dev``, for the entry's gather."""
    index = _f32_pack_index(c, hidden) if f32 else _pack_index(c, hidden)
    return torch.from_numpy(index.astype(np.int32)).to(dev)


def mlp_bwd_plain(x, g, ln_w, ln_b, w1, b1, w2, *, drop_path=None, rows_per_sample: int = 0, mm=torch.matmul):
    """Plain PyTorch version (``mlp_vjp.py::_bwd`` / ``_dp_bwd`` in f32);
    ``mm`` takes each of its five products (``tf32x3.matmul`` repeats the
    f32 kernel's arithmetic)."""
    x32, g32 = x.float(), g.float()
    s, b = ln_w.float(), ln_b.float()
    w1, b1, w2 = w1.float(), b1.float(), w2.float()
    d = row_scales(drop_path, x.shape[0], rows_per_sample)
    gb = g32 if d is None else d * g32
    mu = x32.mean(-1, keepdim=True)
    inv = torch.rsqrt((x32 - mu).square().mean(-1, keepdim=True) + 1e-5)
    xhat = (x32 - mu) * inv
    ln = xhat * s + b
    h1 = mm(ln, w1) + b1
    cdf = 0.5 * (1.0 + torch.erf(h1 * 0.7071067811865476))
    g1 = h1 * cdf
    dh1 = mm(gb, w2.t()) * (cdf + h1 * torch.exp(-0.5 * h1 * h1) * _INV_SQRT2PI)
    dln = mm(dh1, w1.t())
    dxhat = dln * s
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = gb + (dxhat - m1 - xhat * m2) * inv
    if d is not None:
        dx = dx + (1.0 - d) * g32
    return (
        dx.to(x.dtype), (dln * xhat).sum(0), dln.sum(0), mm(ln.t(), dh1), dh1.sum(0), mm(g1.t(), gb), gb.sum(0),
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
    dx = torch.empty_like(x)
    ds_db = torch.empty(2 * c, dtype=f32, device=dev)
    dw1, db1 = torch.empty(c, hidden, dtype=f32, device=dev), torch.empty(hidden, dtype=f32, device=dev)
    dw2, db2 = torch.empty(hidden, c, dtype=f32, device=dev), torch.empty(c, dtype=f32, device=dev)
    ptrs = [None if t is None else t.data_ptr() for t in ops]
    grads = [ds_db.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr()]
    t_elems, f_elems = _LL(), _LL()
    args = [px, pg, dx.data_ptr(), rows, c, hidden, *ptrs, rows_per_sample]
    if dt == torch.float32 and f32_mma_takes(c, hidden):
        return _mlp_bwd_f32(x, g, c, hidden, ops, rows_per_sample, dx, ds_db, dw1, db1, dw2, db2)
    if dt == torch.bfloat16 and mma_takes(c, hidden):
        lib = _build.load("mlp_bwd_mma", _SIGNATURES_MMA, _RESTYPES_MMA)
        index = _device_pack_index(c, hidden, dev)
        if call(dev, lib.mlp_bwd_mma_pack_elems, c, hidden) != index.numel():
            raise RuntimeError(f"mlp_bwd: the packed weights of C {c}, hidden {hidden} disagree with the kernel's "
                               "layout")
        status = call(dev, lib.mlp_bwd_mma_scratch, rows, c, hidden, ctypes.byref(t_elems), ctypes.byref(f_elems))
        if status != 0:
            raise RuntimeError(f"mlp_bwd: CUDA error {status} while sizing the scratch")
        entry = "mlp_bwd_mma_bf16"
        args += [index.data_ptr(), index.numel()]
    else:
        lib = _build.load("mlp_bwd", _SIGNATURES, _RESTYPES)
        call(dev, lib.mlp_bwd_scratch, rows, c, hidden, ctypes.byref(t_elems), ctypes.byref(f_elems))
        entry = "mlp_bwd_bf16" if dt == torch.bfloat16 else "mlp_bwd_f32"
    tscratch = torch.empty(t_elems.value, dtype=dt, device=dev)
    fscratch = torch.empty(f_elems.value, dtype=f32, device=dev)
    status = call(dev, getattr(lib, entry), *args, *grads, tscratch.data_ptr(), t_elems.value, fscratch.data_ptr(),
                  f_elems.value, STREAM)
    finish("mlp_bwd", status, entry)
    return dx, ds_db[:c], ds_db[c:], dw1, db1, dw2, db2


def _mlp_bwd_f32(x, g, c, hidden, ops, rows_per_sample, dx, ds_db, dw1, db1, dw2, db2):
    """The launch of ``csrc/mlp_bwd_f32.cu`` (f32, :func:`f32_mma_takes`)."""
    dev, rows = x.device, x.shape[0]
    ln_w, ln_b, w1, b1, w2, drop = ops
    lib = _build.load("mlp_bwd_f32", _SIGNATURES_F32, _RESTYPES_F32)
    index = _device_pack_index(c, hidden, dev, True)
    if call(dev, lib.mlp_bwd_mma_f32_pack_elems, c, hidden) != index.numel():
        raise RuntimeError(f"mlp_bwd: the f32 packed weights of C {c}, hidden {hidden} disagree with the kernel's "
                           "layout")
    f_elems = _LL()
    status = call(dev, lib.mlp_bwd_mma_f32_scratch, rows, c, hidden, ctypes.byref(f_elems))
    if status != 0:
        raise RuntimeError(f"mlp_bwd: CUDA error {status} while sizing the scratch")
    fscratch = torch.empty(f_elems.value, dtype=torch.float32, device=dev)
    xa, ga, wa, ba = aligned(x), aligned(g), aligned(ln_w), aligned(ln_b)
    status = call(dev, lib.mlp_bwd_mma_f32, xa.data_ptr(), ga.data_ptr(), dx.data_ptr(), rows, c, hidden,
                  wa.data_ptr(), ba.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                  None if drop is None else drop.data_ptr(), rows_per_sample, index.data_ptr(), index.numel(),
                  ds_db.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
                  fscratch.data_ptr(), f_elems.value, STREAM)
    finish("mlp_bwd", status, "mlp_bwd_mma_f32")
    return dx, ds_db[:c], ds_db[c:], dw1, db1, dw2, db2
