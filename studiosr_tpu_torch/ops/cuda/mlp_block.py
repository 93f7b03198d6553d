"""B6: the MLP half of a Swin block over token rows (CUDA kernels ``csrc/mlp_block_mma.cu`` in bf16,
``csrc/mlp_block_f32.cu`` in f32, ``csrc/mlp_block.cu`` at other widths).

Replaces ``studiosr_tpu/ops/pallas/swin_block.py::fused_mlp_block``:
y = x + d * fc2(gelu(fc1(LN x))) on x (rows, C), with ``drop_path`` (B,)
per-sample scales (already divided by keep) applied to row r as
``drop_path[r // rows_per_sample]``; None means 1. ``w1`` (C, hidden) and
``w2`` (hidden, C) in (in, out) layout are cast to the rows' dtype;
LayerNorm weights, biases and scales go to the kernel in f32. GELU is the
exact (erf) one; the H100 kernels (bf16 and f32) evaluate its Phi without
branches (within 2.3e-7 of erff's in f32, as B7 does).

``extra`` (rows, C) with ``extra_scale`` (C,) is HAT's CAB join, folded in
before the LayerNorm: x' = x + extra * extra_scale in f32, then
y = x' + fc2(gelu(fc1(LN x'))), the residual the f32 x' (not re-rounded).
It runs a second instantiation of the kernels and counts its launches as
``fused_mlp_block_extra``; drop-path does not combine with it (HAT serving
has none).

Routing, by dtype and geometry, never by a failure: bf16 with C a multiple
of 4 up to 184 and a hidden width up to 512 (:func:`mma_takes`) launches
the kernel written for the H100, ``csrc/mlp_block_mma.cu`` (C entries
``mlp_block_mma_bf16`` and, with ``extra``, ``mlp_block_extra_mma_bf16``),
which reads the weights packed: dense weights are gathered on every call by
:func:`_mma_pack_index`'s rule (the entry gathers them on the card), and
HAT serving packs them once, at load time (:func:`pack_mlp_block`: the blob
takes ``w1``'s place and ``w2`` is None). f32 with C a multiple of 4 up to
256 and a hidden width up to 512 (:func:`f32_mma_takes`: SwinFIR's recipe,
and every model's MLP half in f32) launches ``csrc/mlp_block_f32.cu`` (C
entries ``mlp_block_mma_f32`` and ``mlp_block_extra_mma_f32``: both
products in 3xTF32 on the tensor cores, dense weights packed and split per
call by :func:`_f32_pack_index`'s rule). Other geometries launch
``csrc/mlp_block.cu`` (``mlp_block_bf16`` / ``_f32`` and the ``extra``
entries). Each launch is counted under its C entry
(``engagement.entries()``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from studiosr_tpu_torch.ops.cuda import _build, tf32x3
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, aligned, check, finish, operand, STREAM, call
from studiosr_tpu_torch.ops.cuda.window_attention import _image, _pad16

__all__ = ["fused_mlp_block", "mlp_block_plain", "row_scales", "mma_takes", "f32_mma_takes", "pack_mlp_block",
           "unpack_mlp_block", "pack_mlp_block_f32_weights"]

_ARGS = (P, P, I, I, I) + (P,) * 7 + (I, P, ctypes.c_longlong, P)
_EXTRA_ARGS = (P, P, I, I, I) + (P,) * 8 + (P, ctypes.c_longlong, P)
_SIGNATURES = {
    "mlp_block_f32": _ARGS, "mlp_block_bf16": _ARGS, "mlp_block_pack_elems": (I, I),
    "mlp_block_extra_f32": _EXTRA_ARGS, "mlp_block_extra_bf16": _EXTRA_ARGS,
}
_RESTYPES = {"mlp_block_pack_elems": ctypes.c_longlong}
_LL = ctypes.c_longlong
_ARGS_MMA = (P, P, I, I, I) + (P,) * 7 + (I, P, P, _LL, P, P)
_EXTRA_ARGS_MMA = (P, P, I, I, I) + (P,) * 8 + (P, P, _LL, P, P)
_SIGNATURES_MMA = {"mlp_block_mma_bf16": _ARGS_MMA, "mlp_block_extra_mma_bf16": _EXTRA_ARGS_MMA,
                   "mlp_block_mma_pack_elems": (I, I)}
_RESTYPES_MMA = {"mlp_block_mma_pack_elems": _LL}
_ARGS_F32 = (P, P, I, I, I) + (P,) * 7 + (I, P, _LL, P, _LL, P)
_EXTRA_ARGS_F32 = (P, P, I, I, I) + (P,) * 9 + (_LL, P, _LL, P)
_SIGNATURES_F32 = {"mlp_block_mma_f32": _ARGS_F32, "mlp_block_extra_mma_f32": _EXTRA_ARGS_F32,
                   "mlp_block_mma_f32_pack_elems": (I, I), "mlp_block_mma_f32_scratch": (I, I, I, I)}
_RESTYPES_F32 = {"mlp_block_mma_f32_pack_elems": _LL, "mlp_block_mma_f32_scratch": _LL}
MMA_MAX_C, MMA_MAX_HIDDEN = 184, 512
F32_MAX_C, F32_MAX_HIDDEN = 256, 512  # csrc/tf32x3.cuh TF_MAX_C, csrc/mlp_block_f32.cu MF32_MAX_HIDDEN
_CHUNK = 64  # hidden units a chunk (MF_CHUNK)
_FC2_WIDTHS = (32, 64, 96, 128, 184)  # csrc/mlp_block_mma.cu mf_np: fc2's product widths


def mma_takes(c: int, hidden: int) -> bool:
    """Whether the bf16 kernel written for the H100 takes this geometry: C a
    multiple of 4 up to 184 and a hidden width up to 512."""
    return c % 4 == 0 and 4 <= c <= MMA_MAX_C and 1 <= hidden <= MMA_MAX_HIDDEN


def f32_mma_takes(c: int, hidden: int) -> bool:
    """Whether the f32 kernel written for the H100 takes this geometry: C a
    multiple of 4 up to 256 and a hidden width up to 512."""
    return c % 4 == 0 and 4 <= c <= F32_MAX_C and 1 <= hidden <= F32_MAX_HIDDEN


def _f32_products(c: int, hidden: int) -> list:
    """(K, N) of B6 f32's row products: g = gelu(LN W1) (C x HP) and g W2 (HP
    x C), with HP the hidden width padded to 4."""
    hp = -(-hidden // 4) * 4
    return [(c, hp), (hp, c)]


@functools.lru_cache(maxsize=None)
def _f32_pack_index(c: int, hidden: int) -> np.ndarray:
    """For each hi value of B6 f32's packed weights, its flat index into
    ``cat(w1.flatten(), w2.flatten())`` (w1 (C, hidden), w2 (hidden, C)), or
    2 C hidden for a zero: W1 (C x HP, [r, j] = w1[r, j]) and W2 (HP x C,
    [j, n] = w2[j, n]), zero at j >= hidden, each in ``tfw_pack``'s image
    order (``tf32x3.tfw_image_index``)."""
    hp = -(-hidden // 4) * 4
    zero = 2 * c * hidden
    r, j = np.meshgrid(np.arange(c), np.arange(hp), indexing="ij")
    w1 = np.where(j < hidden, r * hidden + j, zero)
    w2 = np.where(j.T < hidden, c * hidden + j.T * c + r.T, zero)
    return np.concatenate([tf32x3.tfw_image_index(m, zero) for m in (w1, w2)])


def pack_mlp_block_f32_weights(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """B6 f32's packed weights (f32): the values :func:`_f32_pack_index`
    gathers, each stage block as its hi then its lo image
    (``tf32x3.pack_images``); the entry packs the same on the card on every
    call, this is its plain version."""
    c, hidden = w1.shape
    src = torch.cat([w1.reshape(-1), w2.to(w1.dtype).reshape(-1), w1.new_zeros(1)]).float()
    return tf32x3.pack_images(src[torch.from_numpy(_f32_pack_index(c, hidden)).to(src.device)],
                              _f32_products(c, hidden))


@functools.lru_cache(maxsize=None)
def _mma_pack_index(c: int, hidden: int) -> np.ndarray:
    """For each element of the H100 kernel's packed weights, its flat index
    into ``cat(w1.flatten(), w2.flatten())`` (w1 (C, hidden), w2 (hidden,
    C)), or 2 C hidden for a zero. With KC = pad16(C), NP the product width
    (32, 64, 96, 128 or 184, the least >= C) and the hidden units in chunks
    of 64 (the last padded with zeros): per chunk, fc1's columns as B of LN
    @ W1 (a K-major image of KC rows x 64, row r, column n = w1[r, 64 chunk
    + n]), then fc2's rows as B of gelu @ W2 (a K-major image of 64 rows x
    NP, row k, column n = w2[64 chunk + k, n])."""
    kc = _pad16(c)
    npw = next(w for w in _FC2_WIDTHS if c <= w)
    zero = 2 * c * hidden
    parts = []
    for ch in range(-(-hidden // _CHUNK)):
        k, n = np.meshgrid(np.arange(kc), np.arange(_CHUNK), indexing="ij")
        j = _CHUNK * ch + n
        parts.append(_image(k, n, kc, np.where((k < c) & (j < hidden), k * hidden + j, zero)))
        k, n = np.meshgrid(np.arange(_CHUNK), np.arange(npw), indexing="ij")
        j = _CHUNK * ch + k
        parts.append(_image(k, n, _CHUNK, np.where((j < hidden) & (n < c), c * hidden + j * c + n, zero)))
    return np.concatenate(parts)


@functools.lru_cache(maxsize=None)
def _device_pack_index(c: int, hidden: int, dev: torch.device, f32: bool = False) -> torch.Tensor:
    """:func:`_mma_pack_index` (``f32``: :func:`_f32_pack_index`) as an int32
    tensor on ``dev``, for the entry's gather."""
    index = _f32_pack_index(c, hidden) if f32 else _mma_pack_index(c, hidden)
    return torch.from_numpy(index.astype(np.int32)).to(dev)


def pack_mlp_block(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The packed weights the H100 kernel streams (the rule of
    :func:`_mma_pack_index`), as a 1-D tensor of ``w1``'s dtype: HAT serving
    packs them once, at load time; the entry gathers the same on the card on
    every call when handed dense weights."""
    c, hidden = w1.shape
    if tuple(w2.shape) != (hidden, c):
        raise ValueError(f"pack_mlp_block: w1 {tuple(w1.shape)} and w2 {tuple(w2.shape)} do not fit")
    src = torch.cat([w1.reshape(-1), w2.to(w1.dtype).reshape(-1), w1.new_zeros(1)])
    return src[torch.from_numpy(_mma_pack_index(c, hidden)).to(src.device)]


def unpack_mlp_block(blob: torch.Tensor, c: int, hidden: int):
    """(w1 (C, hidden), w2 (hidden, C)) back from :func:`pack_mlp_block`'s blob."""
    index = torch.from_numpy(_mma_pack_index(c, hidden)).to(blob.device)
    if blob.dim() != 1 or blob.numel() != index.numel():
        raise ValueError(f"unpack_mlp_block: a blob of {tuple(blob.shape)} is not one of C {c}, hidden {hidden}")
    keep = index < 2 * c * hidden
    flat = blob.new_zeros(2 * c * hidden)
    flat[index[keep]] = blob[keep]
    return flat[: c * hidden].reshape(c, hidden), flat[c * hidden:].reshape(hidden, c)


def _dense(x, w1, w2, b1):
    """(w1, w2) dense: unpacked when ``w2`` is None and ``w1`` is the packed blob."""
    if w2 is not None:
        return w1, w2
    return unpack_mlp_block(w1, x.shape[-1], b1.numel())


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
    x, ln_w, ln_b, w1, b1, w2, b2, *, drop_path=None, rows_per_sample: int = 0, extra=None, extra_scale=None,
    mm=torch.matmul,
):
    """Plain PyTorch version, computed in f32 and returned in ``x.dtype``;
    ``w2`` None means ``w1`` is :func:`pack_mlp_block`'s blob. ``mm`` takes
    each product (``tf32x3.matmul`` repeats the f32 kernel's arithmetic)."""
    w1, w2 = _dense(x, w1, w2, b1)
    xf = x.float()
    if extra is not None:
        xf = xf + extra.float() * extra_scale.float()
    h = F.gelu(mm(F.layer_norm(xf, (x.shape[-1],), ln_w.float(), ln_b.float(), 1e-5), w1.float()) + b1.float())
    delta = mm(h, w2.float()) + b2.float()
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
    hidden = b1.numel()
    row_scales(drop_path, rows, rows_per_sample)  # validates the scales' shape
    dev, dt, f32 = x.device, x.dtype, torch.float32
    mma = dt == torch.bfloat16 and mma_takes(c, hidden)
    if w2 is None and not mma:
        raise ValueError(f"fused_mlp_block: packed weights (w2 None) are the bf16 H100 kernel's, not {dt} at C {c}, "
                         f"hidden {hidden}")
    if mma:
        return _fused_mma(x, ln_w, ln_b, w1, b1, w2, b2, drop_path, rows_per_sample, extra, extra_scale)
    if dt == f32 and f32_mma_takes(c, hidden):
        return _fused_f32(x, ln_w, ln_b, w1, b1, w2, b2, drop_path, rows_per_sample, extra, extra_scale)
    # the kernel reads every operand during the launch; keep each converted copy alive until then
    ops = [
        operand(ln_w, "ln_w", (c,), f32, dev), operand(ln_b, "ln_b", (c,), f32, dev),
        operand(w1, "w1", (c, hidden), dt, dev), operand(b1, "b1", (hidden,), f32, dev),
        operand(w2, "w2", (hidden, c), dt, dev), operand(b2, "b2", (c,), f32, dev),
    ]
    px = check(x, "x", (rows, c), dt, dev)
    out = torch.empty_like(x)
    lib = _build.load("mlp_block", _SIGNATURES, _RESTYPES)
    pack = call(dev, lib.mlp_block_pack_elems, c, hidden)
    packed = torch.empty(pack, dtype=dt, device=dev)
    ptrs = [t.data_ptr() for t in ops]
    bf16 = dt == torch.bfloat16
    if extra is None:
        dp = None if drop_path is None else operand(drop_path, "drop_path", (drop_path.numel(),), f32, dev)
        entry = "mlp_block_bf16" if bf16 else "mlp_block_f32"
        status = call(dev, getattr(lib, entry), px, out.data_ptr(), rows, c, hidden, *ptrs,
                      None if dp is None else dp.data_ptr(), rows_per_sample, packed.data_ptr(), pack, STREAM)
        finish("fused_mlp_block", status, entry)
    else:
        pe = check(extra, "extra", (rows, c), dt, dev)
        es = operand(extra_scale, "extra_scale", (c,), f32, dev)
        entry = "mlp_block_extra_bf16" if bf16 else "mlp_block_extra_f32"
        status = call(dev, getattr(lib, entry), px, out.data_ptr(), rows, c, hidden, *ptrs, pe, es.data_ptr(),
                      packed.data_ptr(), pack, STREAM)
        finish("fused_mlp_block_extra", status, entry)
    return out


def _fused_mma(x, ln_w, ln_b, w1, b1, w2, b2, drop_path, rows_per_sample, extra, extra_scale):
    """The bf16 launch of ``csrc/mlp_block_mma.cu`` on dense or packed weights."""
    rows, c = x.shape
    hidden = b1.numel()
    dev, dt, f32 = x.device, x.dtype, torch.float32
    lib = _build.load("mlp_block_mma", _SIGNATURES_MMA, _RESTYPES_MMA)
    index = _device_pack_index(c, hidden, dev)
    pack = call(dev, lib.mlp_block_mma_pack_elems, c, hidden)
    if pack != index.numel():
        raise RuntimeError(f"fused_mlp_block: the packed weights of C {c}, hidden {hidden} disagree with the "
                           "kernel's layout")
    ops = [operand(ln_w, "ln_w", (c,), f32, dev), operand(ln_b, "ln_b", (c,), f32, dev),
           operand(b1, "b1", (hidden,), f32, dev), operand(b2, "b2", (c,), f32, dev)]
    if w2 is None:
        blob = check(w1, "w1 (packed)", (pack,), dt, dev)
        if blob % 16:
            raise ValueError("fused_mlp_block: the packed weights must lie on a 16-byte boundary")
        dense, scratch = [None, None], None
    else:
        blob = None
        dense = [operand(w1, "w1", (c, hidden), dt, dev), operand(w2, "w2", (hidden, c), dt, dev)]
        scratch = torch.empty(pack, dtype=dt, device=dev)
    px = check(x, "x", (rows, c), dt, dev)
    out = torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    weights = [ptr(ops[0]), ptr(ops[1]), ptr(dense[0]), ptr(ops[2]), ptr(dense[1]), ptr(ops[3])]
    tail = [index.data_ptr(), blob, pack, ptr(scratch), STREAM]
    if extra is None:
        dp = None if drop_path is None else operand(drop_path, "drop_path", (drop_path.numel(),), f32, dev)
        status = call(dev, lib.mlp_block_mma_bf16, px, out.data_ptr(), rows, c, hidden, *weights, ptr(dp),
                      rows_per_sample, *tail)
        finish("fused_mlp_block", status, "mlp_block_mma_bf16")
    else:
        pe = check(extra, "extra", (rows, c), dt, dev)
        es = operand(extra_scale, "extra_scale", (c,), f32, dev)
        status = call(dev, lib.mlp_block_extra_mma_bf16, px, out.data_ptr(), rows, c, hidden, *weights, pe,
                      es.data_ptr(), *tail)
        finish("fused_mlp_block_extra", status, "mlp_block_extra_mma_bf16")
    return out


def _fused_f32(x, ln_w, ln_b, w1, b1, w2, b2, drop_path, rows_per_sample, extra, extra_scale):
    """The f32 launch of ``csrc/mlp_block_f32.cu`` on dense weights, packed
    and split by the entry."""
    rows, c = x.shape
    hidden = b1.numel()
    dev, f32 = x.device, torch.float32
    lib = _build.load("mlp_block_f32", _SIGNATURES_F32, _RESTYPES_F32)
    index = _device_pack_index(c, hidden, dev, True)
    if call(dev, lib.mlp_block_mma_f32_pack_elems, c, hidden) != index.numel():
        raise RuntimeError(f"fused_mlp_block: the f32 packed weights of C {c}, hidden {hidden} disagree with the "
                           "kernel's layout")
    # the entry reads x, ln_w, ln_b, extra and its scale four values at a time: 16-byte aligned copies
    weights = [aligned(operand(ln_w, "ln_w", (c,), f32, dev)), aligned(operand(ln_b, "ln_b", (c,), f32, dev)),
               operand(w1, "w1", (c, hidden), f32, dev), operand(b1, "b1", (hidden,), f32, dev),
               operand(w2, "w2", (hidden, c), f32, dev), operand(b2, "b2", (c,), f32, dev)]
    check(x, "x", (rows, c), f32, dev)
    xa = aligned(x)
    f_elems = call(dev, lib.mlp_block_mma_f32_scratch, rows, c, hidden, int(extra is not None))
    fscratch = torch.empty(f_elems, dtype=f32, device=dev)
    out = torch.empty_like(xa)
    ptrs = [t.data_ptr() for t in weights]
    tail = [index.data_ptr(), index.numel(), fscratch.data_ptr(), f_elems, STREAM]
    if extra is None:
        dp = None if drop_path is None else operand(drop_path, "drop_path", (drop_path.numel(),), f32, dev)
        status = call(dev, lib.mlp_block_mma_f32, xa.data_ptr(), out.data_ptr(), rows, c, hidden, *ptrs,
                      None if dp is None else dp.data_ptr(), rows_per_sample, *tail)
        finish("fused_mlp_block", status, "mlp_block_mma_f32")
    else:
        check(extra, "extra", (rows, c), f32, dev)
        ea = aligned(extra)
        es = aligned(operand(extra_scale, "extra_scale", (c,), f32, dev))
        status = call(dev, lib.mlp_block_extra_mma_f32, xa.data_ptr(), out.data_ptr(), rows, c, hidden, *ptrs,
                      ea.data_ptr(), es.data_ptr(), *tail)
        finish("fused_mlp_block_extra", status, "mlp_block_extra_mma_f32")
    return out
