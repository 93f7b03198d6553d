"""B1: the whole Swin block in one pass (CUDA kernels ``csrc/swin_block_mma.cu``
in bf16, ``csrc/swin_block.cu`` in f32).

Replaces ``studiosr_tpu/ops/pallas/swin_block.py::fused_swin_block``:
z = x + proj(WA(LN1 x)), y = z + fc2(gelu(fc1(LN2 z))) over ws x ws windows
with the relative-position bias. ``shift > 0`` computes the shifted block,
roll(+shift) . block . roll(-shift) with the shifted-window mask of
``ops/windows.py::calculate_mask``, and returns the output aligned with the
input (the JAX kernel's ``read_shift`` leaves it in the rolled space).

Operands: ``x`` (B, H, W, C); LayerNorm weights and every bias f32; dense
weights in (in, out) layout in the map's dtype (``wqkv`` (C, 3C) with
q | k | v column blocks, unscaled: the kernel applies 1/sqrt(d) to q);
``bias`` the gathered (heads, N, N) f32 rel-pos bias. In bf16 the weights
may instead come packed (:func:`pack_swin_weights`, what serving prepares
once at load time): the packed blob takes the place of ``wqkv`` and
``wproj``, ``bias``, ``w1``, ``w2`` are None; so may they in f32
(:func:`pack_swin_f32`, the f32 kernel's blob of hi / lo TF32 images, where
:func:`f32_mma_takes` the geometry). bf16 launches the kernel written for
the H100 (C entry ``swin_block_mma_bf16``), f32 where :func:`f32_mma_takes`
the 3xTF32 kernel written for it (``csrc/swin_block_f32.cu``,
``swin_block_mma_f32``), both on packed weights (dense ones are packed
first, on every call); other f32 geometries the older kernel
(``swin_block_f32``), which packs its dense weights into a scratch on every
call. The plain version on an f32 blob multiplies by hi + lo, within 2^-22
|w| of the weights packed. The HAT/training operands of the TPU kernel
(``extra``, ``extra_scale``, ``drop_path``) are not part of this port.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from studiosr_tpu_torch.ops.attention import attention_core
from studiosr_tpu_torch.ops.cuda import _build
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, check, finish, STREAM, call
from studiosr_tpu_torch.ops.cuda.tf32x3 import split
from studiosr_tpu_torch.ops.windows import calculate_mask, window_partition, window_reverse

__all__ = [
    "fused_swin_block", "swin_block_plain", "packed_elements", "pack_swin_weights", "unpack_swin_weights",
    "swin_pack_stages", "mma_geometry_error", "KERNEL_WINDOW", "f32_mma_takes", "swin_f32_stages", "pack_swin_f32",
    "unpack_swin_f32", "pack_swin_block",
]

KERNEL_WINDOW = 8  # one 64-token window per thread block (f32), per four warps (bf16)
_ARGS = (P, P, I, I, I, I, I, I, I) + (P,) * 13 + (P, ctypes.c_longlong, P)
_SIGNATURES = {"swin_block_f32": _ARGS}
_MMA_ARGS = (P,) * 11 + (I,) * 7 + (ctypes.c_longlong, P)
_MMA_SIGNATURES = {"swin_block_mma_bf16": _MMA_ARGS, "swin_block_mma_elements": (I, I, I)}
_MMA_RESTYPES = {"swin_block_mma_elements": ctypes.c_longlong}
_F32_SIGNATURES = {"swin_block_mma_f32": (P,) * 11 + (I,) * 7 + (ctypes.c_longlong, P),
                   "swin_block_mma_f32_elements": (I, I, I)}
_F32_RESTYPES = {"swin_block_mma_f32_elements": ctypes.c_longlong}
# csrc/swin_block_f32.cu: columns a stage (an N tile), K rows a stage, a head's padded dims, the widest C
_F32_BN, _F32_BK, _F32_DP, _F32_MAX_C = 96, 32, 32, 180
_PERM8 = np.array([0, 2, 4, 6, 1, 3, 5, 7])  # packed row i of an 8-row group holds unit _PERM8[i]
# csrc/swin_block_mma.cu: bytes a ring slot, hidden units a chunk, widest C
_SLOT_BYTES, _CHUNK, _MMA_MAX_C = 28672, 64, 184
_TOK = KERNEL_WINDOW * KERNEL_WINDOW


def packed_elements(c: int, heads: int, hidden: int) -> int:
    """Elements of the scratch the f32 kernel packs its weights into: the
    ``SwinPack`` layout of ``csrc/swin_block.cu`` (the kernel checks it)."""

    def pad(v: int, m: int) -> int:
        return -(-v // m) * m

    kc, kh = pad(c, 32), pad(hidden, 32)
    nq, nc, nh = pad(3 * pad(c // heads, 16), 64), pad(c, 64), pad(hidden, 64)
    return heads * kc * nq + kc * nc + kc * nh + kh * nc


def _pad16(v: int) -> int:
    return -(-v // 16) * 16


def _np(c: int) -> int:
    """Columns of proj's and fc2's products (``sm_np``: the wgmma widths)."""
    return next(n for n in (32, 64, 96, 128, 184) if c <= n)


def mma_geometry_error(c: int, heads: int) -> str:
    """Why the bf16 kernel does not take C ``c`` with ``heads`` heads, or ''."""
    if c % heads:
        return f"C {c} is not a multiple of {heads} heads"
    if c % 4 or c > _MMA_MAX_C:
        return f"C {c} (the bf16 kernel takes C a multiple of 4 up to {_MMA_MAX_C})"
    if c // heads > 32:
        return f"head dim {c // heads} (the bf16 kernel takes head dims up to 32)"
    return ""


def swin_pack_stages(c: int, heads: int, hidden: int) -> List[Tuple[str, int, int, int, int]]:
    """The packed blob's stages in the order the kernel consumes them (the
    loop of ``SmGeom::stages`` in ``csrc/swin_block_mma.cu``): (kind, head or
    first hidden unit, first K row, K rows, columns). Per head: "qkv" stages
    of its q|k|v columns (3 x pad16(d)) by rows of pad16(C), then one "pb"
    stage (its f32 bias in score-fragment order, then its pad16(d) rows of
    proj, 184 columns at C 180); per chunk of 64 hidden units: "fc1" stages
    of its columns, then one "fc2" stage of its rows. A stage holds at most
    28 KB."""
    d = c // heads
    dp, kc, np_ = _pad16(d), _pad16(c), _np(c)

    def rows(n: int) -> int:
        return min(kc, _SLOT_BYTES // (2 * n) // 16 * 16)

    out = []
    for h in range(heads):
        rq = rows(3 * dp)
        out += [("qkv", h, r0, min(rq, kc - r0), 3 * dp) for r0 in range(0, kc, rq)]
        out.append(("pb", h, 0, dp, np_))
    for c0 in range(0, hidden, _CHUNK):
        hc = _pad16(min(_CHUNK, hidden - c0))
        rh = rows(hc)
        out += [("fc1", c0, r0, min(rh, kc - r0), hc) for r0 in range(0, kc, rh)]
        out.append(("fc2", c0, 0, hc, np_))
    return out


def _stage_elements(kind: str, nrows: int, ncols: int) -> int:
    return nrows * ncols + (2 * _TOK * _TOK if kind == "pb" else 0)


def _k_major(block: torch.Tensor) -> torch.Tensor:
    """(K, N) -> wgmma's K-major core-matrix order, flat: element (k, n) at
    (n / 8) K 8 + (k / 8) 64 + (n % 8) 8 + k % 8 (``sm_kmajor``)."""
    k, n = block.shape
    return block.reshape(k // 8, 8, n // 8, 8).permute(2, 0, 3, 1).reshape(-1)


def _from_k_major(flat: torch.Tensor, k: int, n: int) -> torch.Tensor:
    return flat.reshape(n // 8, k // 8, 8, 8).permute(1, 3, 0, 2).reshape(k, n)


def _bias_fragments(bias_h: torch.Tensor) -> torch.Tensor:
    """(64, 64) f32 -> the order a warp's score fragments hold it: for row
    tile wr, key tile nt and lane 4 g + t, (16 wr + g, 8 nt + 2 t), its right
    neighbour, and the same 8 rows down."""
    return bias_h.reshape(4, 2, 8, 8, 4, 2).permute(0, 3, 2, 4, 1, 5).reshape(-1)


def pack_swin_weights(wqkv, wproj, bias, w1, w2, heads: int) -> torch.Tensor:
    """Dense B1 weights -> the bf16 blob ``csrc/swin_block_mma.cu`` streams:
    the stages of :func:`swin_pack_stages` back to back, each the image of a
    shared-memory ring slot (the weights in wgmma's K-major core-matrix
    order), zero outside the source matrices. The f32 bias is stored bit for
    bit (two bf16 elements a value)."""
    c, hidden = wqkv.shape[0], w1.shape[1]
    d = c // heads
    dp, kc, np_ = _pad16(d), _pad16(c), _np(c)
    dev = wqkv.device
    bf = torch.bfloat16
    # q|k|v of each head: (heads, pad16(C), 3 dp), head h's part p in columns p dp .. p dp + d
    qkv = torch.zeros(heads, kc, 3, dp, dtype=bf, device=dev)
    qkv[:, :c, :, :d] = wqkv.detach().to(bf).reshape(c, 3, heads, d).permute(2, 0, 1, 3)
    qkv = qkv.reshape(heads, kc, 3 * dp)
    proj = torch.zeros(heads, dp, np_, dtype=bf, device=dev)
    proj[:, :d, :c] = wproj.detach().to(bf).reshape(heads, d, c)
    w1p = torch.zeros(kc, _pad16(hidden) + _CHUNK, dtype=bf, device=dev)
    w1p[:c, :hidden] = w1.detach().to(bf)
    w2p = torch.zeros(_pad16(hidden) + _CHUNK, np_, dtype=bf, device=dev)
    w2p[:hidden, :c] = w2.detach().to(bf)
    bias_bits = bias.detach().float().contiguous()
    pieces = []
    for kind, idx, r0, nrows, ncols in swin_pack_stages(c, heads, hidden):
        if kind == "qkv":
            block = qkv[idx, r0 : r0 + nrows]
        elif kind == "pb":
            pieces.append(_bias_fragments(bias_bits[idx]).view(bf))
            block = proj[idx]
        elif kind == "fc1":
            block = w1p[r0 : r0 + nrows, idx : idx + ncols]
        else:
            block = w2p[idx : idx + nrows]
        pieces.append(_k_major(block))
    return torch.cat(pieces)


def unpack_swin_weights(packed: torch.Tensor, c: int, heads: int, hidden: int):
    """Inverse of :func:`pack_swin_weights`: (wqkv, wproj, bias, w1, w2),
    the weights bf16 and the bias f32."""
    stages = swin_pack_stages(c, heads, hidden)
    total = sum(_stage_elements(kind, nrows, ncols) for kind, _, _, nrows, ncols in stages)
    if packed.dim() != 1 or packed.dtype != torch.bfloat16 or packed.numel() != total:
        raise ValueError(
            f"packed B1 weights {tuple(packed.shape)} {packed.dtype} do not fit C {c}, {heads} heads, hidden {hidden}"
        )
    d = c // heads
    dp, kc = _pad16(d), _pad16(c)
    bf = torch.bfloat16
    dev = packed.device
    qkv = torch.zeros(heads, kc, 3 * dp, dtype=bf, device=dev)
    wproj = torch.zeros(heads, d, c, dtype=bf, device=dev)
    bias = torch.zeros(heads, _TOK * _TOK, dtype=torch.float32, device=dev)
    w1 = torch.zeros(kc, _pad16(hidden) + _CHUNK, dtype=bf, device=dev)
    w2 = torch.zeros(_pad16(hidden) + _CHUNK, c, dtype=bf, device=dev)
    at = 0
    for kind, idx, r0, nrows, ncols in stages:
        if kind == "pb":
            bias[idx] = packed[at : at + 2 * _TOK * _TOK].view(torch.float32)
            at += 2 * _TOK * _TOK
        block = _from_k_major(packed[at : at + nrows * ncols], nrows, ncols)
        at += nrows * ncols
        if kind == "qkv":
            qkv[idx, r0 : r0 + nrows] = block
        elif kind == "pb":
            wproj[idx] = block[:d, :c]
        elif kind == "fc1":
            w1[r0 : r0 + nrows, idx : idx + ncols] = block
        else:
            w2[idx : idx + nrows] = block[:, :c]
    wqkv = qkv[:, :c].reshape(heads, c, 3, dp)[..., :d].permute(1, 2, 0, 3).reshape(c, 3 * c)
    perm = bias.reshape(heads, 4, 8, 8, 4, 2, 2).permute(0, 1, 5, 3, 2, 4, 6)  # (wr, nt, g, t, hh, e) -> rows, cols
    return wqkv, wproj.reshape(c, c), perm.reshape(heads, _TOK, _TOK), w1[:c, :hidden], w2[:hidden]


def f32_mma_takes(c: int, heads: int, hidden: int) -> bool:
    """Whether f32 B1 at window 8 runs the 3xTF32 kernel written for the
    H100 (``csrc/swin_block_f32.cu``): C a multiple of 4 up to 180, head dims
    up to 32, any hidden. Other geometries keep ``swin_block.cu``."""
    return heads >= 1 and c % heads == 0 and c % 4 == 0 and 4 <= c <= _F32_MAX_C and c // heads <= _F32_DP \
        and hidden >= 1


def swin_f32_stages(c: int, heads: int, hidden: int) -> List[Tuple[str, int, int, int]]:
    """The f32 blob's stages in the order the kernel consumes them (the loop
    of ``sb32_kernel`` in ``csrc/swin_block_f32.cu``; its ``Sb32Geom::
    stages`` counts them): (kind, head or hidden chunk, K stage, output
    tile), each 32 K rows x 96 columns. Per head: "qkv" for each 32 LN
    channels (its q, k, v columns, 32 a part), then "proj" for each
    96-column output tile (its 32 padded dims as rows); per chunk of 96
    hidden units: "fc1" for each 32 LN channels, then "fc2" for each 32
    units and output tile."""
    ks, nt, chunks = -(-c // _F32_BK), -(-c // _F32_BN), -(-hidden // _F32_BN)
    out = []
    for h in range(heads):
        out += [("qkv", h, k, 0) for k in range(ks)] + [("proj", h, 0, t) for t in range(nt)]
    for ch in range(chunks):
        out += [("fc1", ch, k, 0) for k in range(ks)] + [("fc2", ch, k, t) for k in range(3) for t in range(nt)]
    return out


@functools.lru_cache(maxsize=16)
def _f32_pack_index(c: int, heads: int, hidden: int) -> np.ndarray:
    """For each value of the blob's hi images, in order, its flat index in
    wqkv, wproj, w1 and w2 laid end to end ((in, out) layouts), or the index
    one past them (a zero): stage by stage (:func:`swin_f32_stages`), element
    (k, n) of a stage at (n / 8) 256 + (k / 4) 32 + (n % 8) 4 + k % 4
    (``tfw_image``). proj's and fc2's K rows are permuted inside each 8-row
    group (row i holds unit ``_PERM8[i]``)."""
    d = c // heads
    off_proj, off_w1 = 3 * c * c, 4 * c * c
    off_w2, zero = off_w1 + c * hidden, off_w1 + 2 * c * hidden
    k = np.arange(_F32_BK)[:, None]
    n = np.arange(_F32_BN)[None, :]
    kp = (k // 8) * 8 + _PERM8[k % 8]
    stages = []
    for kind, i, ks, t in swin_f32_stages(c, heads, hidden):
        if kind == "qkv":
            ch, part, j = _F32_BK * ks + k, n // _F32_DP, n % _F32_DP
            ok, src = (ch < c) & (j < d), ch * 3 * c + part * c + i * d + j
        elif kind == "proj":
            col = _F32_BN * t + n
            ok, src = (kp < d) & (col < c), off_proj + (i * d + kp) * c + col
        elif kind == "fc1":
            ch, u = _F32_BK * ks + k, _F32_BN * i + n
            ok, src = (ch < c) & (u < hidden), off_w1 + ch * hidden + u
        else:
            u, col = _F32_BN * i + _F32_BK * ks + kp, _F32_BN * t + n
            ok, src = (u < hidden) & (col < c), off_w2 + u * c + col
        stages.append(np.where(ok, src, zero))
    full = np.stack(stages)  # (stages, 32, 96)
    pos = ((n // 8) * 256 + (k // 4) * 32 + (n % 8) * 4 + k % 4).ravel()
    out = np.empty((len(stages), _F32_BK * _F32_BN), dtype=np.int64)
    out[:, pos] = full.reshape(len(stages), -1)
    return out.reshape(-1)


def pack_swin_f32(wqkv, wproj, bias, w1, w2, heads: int) -> torch.Tensor:
    """Dense f32 B1 weights -> the blob ``csrc/swin_block_f32.cu`` streams:
    the stages of :func:`swin_f32_stages` back to back, each the hi image
    tf32(w) then the lo image tf32(w - hi) of its 32 x 96 block (the gather
    of :func:`_f32_pack_index`, zero outside the source matrices), then each
    head's (64, 64) f32 bias in score-fragment order (for row tile wr, key
    tile nt and lane 4 g + t: (16 wr + g, 8 nt + 2 t), its right neighbour,
    and the same 8 rows down)."""
    c, hidden = wqkv.shape[0], w1.shape[1]
    idx = torch.from_numpy(_f32_pack_index(c, heads, hidden)).to(wqkv.device)
    flat = torch.cat([t.detach().float().reshape(-1) for t in (wqkv, wproj, w1, w2)] +
                     [torch.zeros(1, device=wqkv.device)])
    hi, lo = split(flat[idx].reshape(-1, _F32_BK * _F32_BN))
    frags = [_bias_fragments(bias[h].detach().float()) for h in range(heads)]
    return torch.cat([torch.stack([hi, lo], 1).reshape(-1), *frags])


def pack_swin_block(wqkv, wproj, bias, w1, w2, heads: int) -> Optional[torch.Tensor]:
    """Dense B1 weights (in, out) and gathered rel-pos bias -> the blob of
    the kernel of ``wqkv``'s dtype, where that kernel takes the geometry:
    bf16 where :func:`mma_geometry_error` is '' (:func:`pack_swin_weights`),
    f32 where :func:`f32_mma_takes` (:func:`pack_swin_f32`); None otherwise
    (the first-design f32 kernel reads dense weights)."""
    c, hidden = wqkv.shape[0], w1.shape[1]
    if wqkv.dtype == torch.bfloat16 and not mma_geometry_error(c, heads):
        return pack_swin_weights(wqkv, wproj, bias, w1, w2, heads)
    if wqkv.dtype == torch.float32 and f32_mma_takes(c, heads, hidden):
        return pack_swin_f32(wqkv, wproj, bias, w1, w2, heads)
    return None


def _f32_elements(c: int, heads: int, hidden: int) -> int:
    return len(swin_f32_stages(c, heads, hidden)) * 2 * _F32_BK * _F32_BN + heads * _TOK * _TOK


def unpack_swin_f32(packed: torch.Tensor, c: int, heads: int, hidden: int):
    """Inverse of :func:`pack_swin_f32`: (wqkv, wproj, bias, w1, w2) in f32,
    each weight hi + lo (within 2^-22 |w| of the weight packed), the bias as
    it was."""
    if packed.dim() != 1 or packed.dtype != torch.float32 or packed.numel() != _f32_elements(c, heads, hidden):
        raise ValueError(f"packed f32 B1 weights {tuple(packed.shape)} {packed.dtype} do not fit C {c}, {heads} heads, "
                         f"hidden {hidden}")
    idx = torch.from_numpy(_f32_pack_index(c, heads, hidden)).to(packed.device)
    nw = idx.numel()
    images = packed[:2 * nw].reshape(-1, 2, _F32_BK * _F32_BN)
    flat = torch.zeros(4 * c * c + 2 * c * hidden + 1, device=packed.device)
    flat[idx] = (images[:, 0] + images[:, 1]).reshape(-1)
    wqkv, wproj = flat[:3 * c * c].reshape(c, 3 * c), flat[3 * c * c:4 * c * c].reshape(c, c)
    w1 = flat[4 * c * c:4 * c * c + c * hidden].reshape(c, hidden)
    w2 = flat[4 * c * c + c * hidden:-1].reshape(hidden, c)
    perm = packed[2 * nw:].reshape(heads, 4, 8, 8, 4, 2, 2).permute(0, 1, 5, 3, 2, 4, 6)
    return wqkv, wproj, perm.reshape(heads, _TOK, _TOK), w1, w2


def _dense(x, wqkv, wproj, bias, w1, w2, heads: int, hidden: int):
    """The dense weights, unpacked where ``wqkv`` is a packed blob."""
    if wqkv.dim() == 1:
        unpack = unpack_swin_weights if wqkv.dtype == torch.bfloat16 else unpack_swin_f32
        return unpack(wqkv, x.shape[-1], heads, hidden)
    return wqkv, wproj, bias, w1, w2


def swin_block_plain(
    x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2,
    *, heads: int, window_size: int, shift: int = 0, mm=torch.matmul,
):
    """Plain PyTorch version, computed in f32 and returned in ``x.dtype``;
    weights dense or packed. ``mm`` takes every product (``tf32x3.matmul``:
    the f32 kernel's arithmetic)."""
    wqkv, wproj, bias, w1, w2 = _dense(x, wqkv, wproj, bias, w1, w2, heads, b1.shape[0])
    b, h, w, c = x.shape
    ws = window_size
    n = ws * ws
    d = c // heads
    xf = x.float()
    if shift:
        xf = torch.roll(xf, (-shift, -shift), dims=(1, 2))
    ln = F.layer_norm(xf, (c,), ln1_w.float(), ln1_b.float(), 1e-5)
    qkv = mm(window_partition(ln, ws).reshape(-1, n, c), wqkv.float()) + bqkv.float()
    qkv = qkv.reshape(-1, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    mask = torch.from_numpy(calculate_mask((h, w), ws, shift)).to(x.device) if shift else None
    attn = attention_core(qkv[0] * d**-0.5, qkv[1], qkv[2], bias=bias.float(), mask=mask, mm=mm)
    attn = mm(attn.transpose(1, 2).reshape(-1, n, c), wproj.float()) + bproj.float()
    z = xf + window_reverse(attn.reshape(-1, ws, ws, c), ws, h, w)
    hidden = F.gelu(mm(F.layer_norm(z, (c,), ln2_w.float(), ln2_b.float(), 1e-5), w1.float()) + b1.float())
    y = z + (mm(hidden, w2.float()) + b2.float())
    if shift:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    return y.to(x.dtype)


def fused_swin_block(
    x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2,
    *, heads: int, window_size: int, shift: int = 0,
):
    """(B, H, W, C) -> (B, H, W, C); weights dense, or packed (bf16; f32
    where :func:`f32_mma_takes`). CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    args = (x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return swin_block_plain(*args, heads=heads, window_size=window_size, shift=shift)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_swin_block: unsupported dtype {x.dtype}")
    bsz, h, w, c = x.shape
    ws = window_size
    if ws != KERNEL_WINDOW:
        raise NotImplementedError(f"fused_swin_block: the CUDA kernel takes window size {KERNEL_WINDOW}, not {ws}")
    if h % ws or w % ws or c % heads or not 0 <= shift < ws:
        raise ValueError(f"fused_swin_block: shape {tuple(x.shape)}, heads {heads}, shift {shift} do not fit")
    hidden = b1.shape[-1]
    dev, dt, f32 = x.device, x.dtype, torch.float32
    px = check(x, "x", (bsz, h, w, c), dt, dev)
    out = torch.empty_like(x)
    if dt == torch.bfloat16:
        why = mma_geometry_error(c, heads)
        if why:
            raise NotImplementedError(f"fused_swin_block: the bf16 kernel does not take {why}")
        if wqkv.dim() != 1:
            check(wqkv, "wqkv", (c, 3 * c), dt, dev), check(wproj, "wproj", (c, c), dt, dev)
            check(bias, "bias", (heads, _TOK, _TOK), f32, dev)
            check(w1, "w1", (c, hidden), dt, dev), check(w2, "w2", (hidden, c), dt, dev)
            wqkv = pack_swin_weights(wqkv, wproj, bias, w1, w2, heads)  # kept alive until the launch is enqueued
        elif any(t is not None for t in (wproj, bias, w1, w2)):
            raise ValueError("fused_swin_block: with packed weights wproj, bias, w1 and w2 are None")
        lib = _build.load("swin_block_mma", _MMA_SIGNATURES, _MMA_RESTYPES)
        pack = call(dev, lib.swin_block_mma_elements, c, heads, hidden)
        pw = check(wqkv, "packed weights", (pack,), dt, dev)
        ptrs = [
            check(ln1_w, "ln1_w", (c,), f32, dev), check(ln1_b, "ln1_b", (c,), f32, dev),
            check(bqkv, "bqkv", (3 * c,), f32, dev), check(bproj, "bproj", (c,), f32, dev),
            check(ln2_w, "ln2_w", (c,), f32, dev), check(ln2_b, "ln2_b", (c,), f32, dev),
            check(b1, "b1", (hidden,), f32, dev), check(b2, "b2", (c,), f32, dev),
        ]
        entry = "swin_block_mma_bf16"
        status = call(dev, lib.swin_block_mma_bf16, px, out.data_ptr(), pw, *ptrs, bsz, h, w, c, heads, hidden, shift,
                      pack, STREAM)
    elif f32_mma_takes(c, heads, hidden):
        if wqkv.dim() != 1:
            check(wqkv, "wqkv", (c, 3 * c), dt, dev), check(wproj, "wproj", (c, c), dt, dev)
            check(bias, "bias", (heads, _TOK, _TOK), f32, dev)
            check(w1, "w1", (c, hidden), dt, dev), check(w2, "w2", (hidden, c), dt, dev)
            wqkv = pack_swin_f32(wqkv, wproj, bias, w1, w2, heads)  # kept alive until the launch is enqueued
        elif any(t is not None for t in (wproj, bias, w1, w2)):
            raise ValueError("fused_swin_block: with packed weights wproj, bias, w1 and w2 are None")
        lib = _build.load("swin_block_f32", _F32_SIGNATURES, _F32_RESTYPES)
        pack = call(dev, lib.swin_block_mma_f32_elements, c, heads, hidden)
        pw = check(wqkv, "packed weights", (pack,), dt, dev)
        ptrs = [
            check(ln1_w, "ln1_w", (c,), f32, dev), check(ln1_b, "ln1_b", (c,), f32, dev),
            check(bqkv, "bqkv", (3 * c,), f32, dev), check(bproj, "bproj", (c,), f32, dev),
            check(ln2_w, "ln2_w", (c,), f32, dev), check(ln2_b, "ln2_b", (c,), f32, dev),
            check(b1, "b1", (hidden,), f32, dev), check(b2, "b2", (c,), f32, dev),
        ]
        entry = "swin_block_mma_f32"
        status = call(dev, lib.swin_block_mma_f32, px, out.data_ptr(), pw, *ptrs, bsz, h, w, c, heads, hidden, shift,
                      pack, STREAM)
    else:
        if wqkv.dim() == 1:
            raise ValueError("fused_swin_block: packed f32 weights at a geometry the f32 kernel does not take")
        n = ws * ws
        ptrs = [
            check(ln1_w, "ln1_w", (c,), f32, dev), check(ln1_b, "ln1_b", (c,), f32, dev),
            check(wqkv, "wqkv", (c, 3 * c), dt, dev), check(bqkv, "bqkv", (3 * c,), f32, dev),
            check(wproj, "wproj", (c, c), dt, dev), check(bproj, "bproj", (c,), f32, dev),
            check(bias, "bias", (heads, n, n), f32, dev),
            check(ln2_w, "ln2_w", (c,), f32, dev), check(ln2_b, "ln2_b", (c,), f32, dev),
            check(w1, "w1", (c, hidden), dt, dev), check(b1, "b1", (hidden,), f32, dev),
            check(w2, "w2", (hidden, c), dt, dev), check(b2, "b2", (c,), f32, dev),
        ]
        pack = packed_elements(c, heads, hidden)
        packed = torch.empty(pack, dtype=dt, device=dev)
        lib = _build.load("swin_block", _SIGNATURES)
        entry = "swin_block_f32"
        status = call(dev, lib.swin_block_f32, px, out.data_ptr(), bsz, h, w, c, heads, hidden, shift, *ptrs,
                      packed.data_ptr(), pack, STREAM)
    finish("fused_swin_block", status, entry)
    return out
