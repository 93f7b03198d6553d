"""B12 and B13: the OCAB cross-attention core, forward and backward (CUDA kernels ``csrc/oca_core.cu``;
in bf16 ``csrc/oca_fwd_mma.cu`` and ``csrc/oca_bwd_mma.cu``).

Replaces ``studiosr_tpu/ops/pallas/oca_core.py::oca_core_fwd`` (B12) and
``::oca_core_bwd`` (B13). On q (bw, heads, nq, d), already scaled by
1/sqrt(d), k and v (bw, heads, nk, d) and the (heads, nq, nk) logit bias:

    out = softmax(q k^T + bias) v;
    (dq, dk, dv, d bias) for the cotangent g of out, d bias summed over the
    bw windows, in f32.

q, k, v (and g) are f32 or bf16, one dtype, any strided view whose last
dimension is contiguous (the OCAB's transposed views reach the kernel
without a copy); the bias is handed to the kernel in f32 (the large backward
reads a bf16 bias as it is, as B12 does). Outputs come back
as transposed views of (bw, tokens, heads, d) tensors, the layout the OCAB
reads them in. The kernels take head dims up to 64 and any query and key
count (HAT at every window).

Routing of B12 and B13, by dtype and geometry, never by a failure: bf16
with a head dim up to 32, at most 256 queries and 576 keys
(:func:`mma_takes`: HAT's windows up to 16) launches the kernels written
for the H100. B12:
``csrc/oca_fwd_mma.cu`` (C entry ``oca_core_fwd_mma_bf16``), a pass that
packs q, k and v into wgmma's 64-token images (:func:`pack_fwd_images` is its
plain version, :func:`fwd_from_images` the forward read from them), then the
attention per (window, head, pair of query tiles); a bias handed in bf16 is
read as it is, any other in f32. B13: ``csrc/oca_bwd_mma.cu`` (C entry
``oca_core_bwd_mma_bf16``): a pass that packs q, g, k and v into wgmma's
K-major 64-token tiles (:func:`pack_images` is its plain version), the row
statistics, then p, dscores and the sums per (head, key chunk, group of
windows) (:func:`main_partition` mirrors the blocks' partition). bf16 with
a head dim up to 32 above that (HAT's windows from 17, 576 queries x 1296
keys at window 24) launches their large entries,
``oca_core_fwd_large_mma_bf16`` (the same passes, the key chunks streamed
through a ring) and ``oca_core_bwd_large_mma_bf16`` (the same images, then
``csrc/lb_core.cuh``'s two-formation core, which B9's large family shares:
the row statistics, then p, dscores, d bias, dq's partials, dk and dv per
(group of windows, head, key chunk), then the sums in a fixed order; each
score tile formed twice; :func:`large_partition` mirrors its blocks and
:func:`large_scratch` its scratch). f32 B13 in :func:`mma_takes`'s geometry
(HAT's f32 training step and checks at windows up to 16) launches
``csrc/oca_bwd_f32.cu`` (C entry ``oca_core_bwd_mma_f32``): 3xTF32 on the
tensor cores, a pass that packs q, g, k and v into padded f32 rows, the row
statistics per (window, head, slab of 128 queries), then p, dscores and the
sums per (head, key chunk, group of windows), each score tile formed twice
(:func:`f32_partition` mirrors the blocks). Other bf16 geometries and f32
B12, f32 B13 at head dims above 32 or above 256 queries or 576 keys launch
``oca_core_fwd_bf16`` / ``_f32`` and ``oca_core_bwd_bf16`` / ``_f32``. A launch at more than 256
queries or 576 keys is counted under ``oca_core_fwd_large`` /
``oca_core_bwd_large``, the others under ``oca_core_fwd`` /
``oca_core_bwd``, and each under its C entry (``engagement.entries()``).
"""

from __future__ import annotations

import ctypes

import torch

from studiosr_tpu_torch.ops.cuda import _build, large_bwd, tf32x3
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, finish, operand, STREAM, call
from studiosr_tpu_torch.ops.cuda.window_attention import MAX_HEAD_DIM

__all__ = [
    "oca_core_fwd", "oca_core_bwd", "oca_core_plain", "oca_core_bwd_plain", "mma_takes", "pack_images",
    "main_partition", "pack_fwd_images", "fwd_from_images", "counter", "large_partition", "large_scratch",
    "f32_partition", "F32_SLAB",
]

_LL = ctypes.c_longlong
_STRIDES = ctypes.POINTER(_LL)
_FWD = (P, P, P, P, P, _STRIDES, I, I, I, I, I, P)
_BWD = (P,) * 9 + (_STRIDES, I, I, I, I, I, P, _LL, P)
_SIGNATURES = {
    "oca_core_fwd_f32": _FWD,
    "oca_core_fwd_bf16": _FWD,
    "oca_core_bwd_f32": _BWD,
    "oca_core_bwd_bf16": _BWD,
    "oca_core_bwd_scratch": (I, I, I, I),
}
_RESTYPES = {"oca_core_bwd_scratch": _LL}
_FWD_MMA = (P, P, P, P, P, _STRIDES, I, I, I, I, I, I, P, _LL, P)
_SIGNATURES_FWD_MMA = {
    "oca_core_fwd_mma_bf16": _FWD_MMA,
    "oca_core_fwd_mma_scratch": (I,) * 5 + (ctypes.POINTER(_LL),),
    "oca_core_fwd_large_mma_bf16": _FWD_MMA,
    "oca_core_fwd_large_mma_scratch": (I,) * 6 + (ctypes.POINTER(_LL),),  # and the bias's dtype
}
_BWD_MMA = (P,) * 9 + (_STRIDES, I, I, I, I, I, P, _LL, P, _LL, P)
_SIGNATURES_MMA = {
    "oca_core_bwd_mma_bf16": _BWD_MMA,
    "oca_core_bwd_mma_scratch": (I,) * 5 + (ctypes.POINTER(_LL), ctypes.POINTER(_LL)),
    "oca_core_bwd_large_mma_bf16": (P,) * 9 + (_STRIDES, I) + _BWD_MMA[10:],  # and the bias's dtype
    "oca_core_bwd_large_mma_scratch": (I,) * 5 + (ctypes.POINTER(_LL), ctypes.POINTER(_LL)),
}
_SIGNATURES_F32 = {
    "oca_core_bwd_mma_f32": _BWD,
    "oca_core_bwd_mma_f32_scratch": (I,) * 5 + (ctypes.POINTER(_LL),),
}
F32_SLAB = 128  # csrc/oca_bwd_f32.cu O32_SLAB: query rows a slab of the f32 backward
MMA_MAX_QUERIES, MMA_MAX_KEYS, MMA_MAX_HEAD_DIM = 256, 576, 32  # csrc/oca_*_mma.cu O*_MAX_NQ, O*_MAX_NK
_TOK = 64  # tokens a tile (AM_TOK)
# csrc/oca_fwd_mma.cu of_perm: the key a chunk's image position p = 8 nt + 2 tq + e holds (16 tq + 2 nt + e)
_KEY_PERM = [16 * ((p % 8) // 2) + 2 * (p // 8) + p % 2 for p in range(_TOK)]


def mma_takes(heads: int, nq: int, nk: int, d: int) -> bool:
    """Whether the bf16 forward and backward written for the H100 take this
    geometry: a head dim up to 32, at most 256 queries and 576 keys a
    window."""
    return heads >= 1 and 1 <= d <= MMA_MAX_HEAD_DIM and 1 <= nq <= MMA_MAX_QUERIES and 1 <= nk <= MMA_MAX_KEYS


def _large(nq: int, nk: int) -> bool:
    """More queries or keys than the whole-unit kernels hold: the large family."""
    return nq > MMA_MAX_QUERIES or nk > MMA_MAX_KEYS


def counter(name: str, nq: int, nk: int) -> str:
    """The launch counter of B12 (``name`` ``oca_core_fwd``) or B13
    (``oca_core_bwd``) at this geometry: ``_large`` above 256 queries or
    576 keys, in either dtype."""
    return name + ("_large" if _large(nq, nk) else "")


def _tiles(n: int) -> int:
    return -(-n // _TOK)


def _kmajor_tiles(t, n: int, dp: int, token_major: bool = False, permuted: bool = False) -> torch.Tensor:
    """(bw, heads, n, d) -> (bw * heads, elements) of whole 64-token tiles
    in wgmma's core-matrix image, zero past n and d: image position t,
    column j at (t // 8) DP 8 + (j // 8) 64 + (t % 8) 8 + j % 8 (K-major in
    d), or with ``token_major`` at (j // 8) 512 + (t // 8) 64 + (j % 8) 8 + t
    % 8 (K-major in the tokens). Position t holds token t of the tile, or
    with ``permuted`` token ``_KEY_PERM[t]``."""
    bw, heads, _, d = t.shape
    tiles = _tiles(n)
    padded = t.new_zeros(bw, heads, tiles * _TOK, dp)
    padded[:, :, :n, :d] = t
    if permuted:
        padded = padded.reshape(bw, heads, tiles, _TOK, dp)[:, :, :, _KEY_PERM].reshape(bw, heads, -1, dp)
    # (unit, tile, token group, token in group, column group, column in group)
    x = padded.reshape(bw * heads, tiles, _TOK // 8, 8, dp // 8, 8)
    order = (0, 1, 4, 2, 5, 3) if token_major else (0, 1, 2, 4, 3, 5)
    return x.permute(*order).reshape(bw * heads, -1)


def pack_images(q, k, v, g) -> torch.Tensor:
    """Plain version of the H100 backward's pass 0 (``ob_pack_kernel``): per
    (window, head) unit, q and g in ceil(nq / 64) tiles, then k and v in
    ceil(nk / 64) chunks, each 64 tokens x DP (16 at d <= 16, else 32) in
    wgmma's K-major core-matrix image: token t, column j at (t // 8) DP 8 +
    (j // 8) 64 + (t % 8) 8 + j % 8, zero past the tokens and past d.
    Returns (bw * heads, unit elements) in q's dtype."""
    nq, nk, d = q.shape[2], k.shape[2], q.shape[3]
    dp = 16 if d <= 16 else 32
    return torch.cat([_kmajor_tiles(t, n, dp) for t, n in ((q, nq), (g, nq), (k, nk), (v, nk))], 1)


def pack_fwd_images(q, k, v) -> torch.Tensor:
    """Plain version of the H100 forward's pass 0 (``of_pack_kernel``): per
    (window, head) unit, q in ceil(nq / 64) tiles and k in ceil(nk / 64)
    chunks, K-major in d as :func:`pack_images` lays them (position t,
    column j at (t // 8) DP 8 + (j // 8) 64 + (t % 8) 8 + j % 8), then v in
    ceil(nk / 64) chunks K-major in the tokens (the B operand of p v):
    position t, column j at (j // 8) 512 + (t // 8) 64 + (j % 8) 8 + t % 8.
    64 tokens x DP (16 at d <= 16, else 32) a tile, zero past the tokens and
    past d. q's position t holds its token t; k's and v's position t = 8 nt +
    2 tq + e of a chunk holds its key 16 tq + 2 nt + e, so the kernel's lane
    quad tq finds its score columns' bias in 16 consecutive keys. Returns
    (bw * heads, unit elements) in q's dtype."""
    nq, nk, d = q.shape[2], k.shape[2], q.shape[3]
    dp = 16 if d <= 16 else 32
    return torch.cat([_kmajor_tiles(q, nq, dp), _kmajor_tiles(k, nk, dp, permuted=True),
                      _kmajor_tiles(v, nk, dp, True, True)], 1)


def fwd_from_images(img, bias, bw: int, heads: int, nq: int, nk: int, d: int):
    """The forward as the H100 kernel reads its operands: q, k and v taken
    back from the images of :func:`pack_fwd_images` (d's padding included, so a
    misplaced element there changes the result), then :func:`oca_core_plain`.
    Returns (bw, heads, nq, d)."""
    dp = 16 if d <= 16 else 32
    qt, kt = _tiles(nq), _tiles(nk)
    units = img.reshape(bw * heads, qt + 2 * kt, _TOK * dp)

    def back(part, n: int, token_major: bool = False, permuted: bool = False):
        tiles = part.shape[1]
        if token_major:  # (unit, tile, j // 8, t // 8, j % 8, t % 8)
            x = part.reshape(bw * heads, tiles, dp // 8, 8, 8, 8).permute(0, 1, 3, 5, 2, 4)
        else:  # (unit, tile, t // 8, j // 8, t % 8, j % 8)
            x = part.reshape(bw * heads, tiles, 8, dp // 8, 8, 8).permute(0, 1, 2, 4, 3, 5)
        x = x.reshape(bw, heads, tiles, _TOK, dp)
        if permuted:  # position t holds key _KEY_PERM[t]
            x = x[:, :, :, sorted(range(_TOK), key=_KEY_PERM.__getitem__)]
        return x.reshape(bw, heads, tiles * _TOK, dp)[:, :, :n]

    q = back(units[:, :qt], nq)
    k = back(units[:, qt:qt + kt], nk, permuted=True)
    v = back(units[:, qt + kt:], nk, True, True)
    return oca_core_plain(q, k, v, bias)[..., :d]


def main_partition(bw: int, heads: int, nq: int, nk: int, sms: int = 132):
    """The H100 backward's main pass as its blocks take it: for each block
    (in launch order) the (window, head, query tile, key chunk) units of work
    it computes, in order: block b is (group b // (heads KT), head (b // KT) %
    heads, key chunk b % KT), its warpgroup w takes query tiles w, w + 2, and
    it walks the windows g, g + groups, .... Each (window, head, tile, chunk)
    must appear exactly once. Its groups (``ob_groups``) follow the f32
    passes' rule, ``tf32x3.groups``."""
    qt, kt = _tiles(nq), _tiles(nk)
    groups = tf32x3.groups(bw, heads * kt, sms)
    blocks = []
    for b in range(groups * heads * kt):
        c, h, grp = b % kt, (b // kt) % heads, b // (kt * heads)
        blocks.append([(w, h, i, c) for w in range(grp, bw, groups) for wg in range(2) for i in range(wg, qt, 2)])
    return blocks


def f32_partition(bw: int, heads: int, nq: int, nk: int, sms: int = 132):
    """The f32 backward's main pass as its blocks take it (``csrc/oca_bwd_f32.cu``
    ``o32_main_kernel``): for each block (in launch order) its (window, head,
    slab, key chunk) units of work, in order: block b is (group b // (heads
    KT), head (b // KT) % heads, key chunk b % KT) and walks the windows g, g
    + groups, ..., each a slab of 128 queries at a time. Each (window, head,
    slab, chunk) must appear exactly once; the groups are :func:`main_partition`'s."""
    slabs, kt = -(-nq // F32_SLAB), _tiles(nk)
    groups = tf32x3.groups(bw, heads * kt, sms)
    blocks = []
    for b in range(groups * heads * kt):
        c, h, grp = b % kt, (b // kt) % heads, b // (kt * heads)
        blocks.append([(w, h, s, c) for w in range(grp, bw, groups) for s in range(slabs)])
    return blocks


def _dp(d: int) -> int:
    return 16 if d <= 16 else 32


def large_partition(bw: int, heads: int, nq: int, nk: int, d: int, sms: int = 132) -> dict:
    """The large entry's passes as their blocks take them
    (``large_bwd.partition``): bw windows of ceil(nq / 64) query tiles and
    ceil(nk / 64) key chunks, d padded to 16 or 32."""
    return large_bwd.partition(bw, heads, _tiles(nq), _tiles(nk), _dp(d), sms)


def large_scratch(bw: int, heads: int, nq: int, nk: int, d: int, sms: int = 132) -> tuple:
    """(bf16, f32) scratch elements of the large entry (``ob_scratch``): the
    images, units x (2 QT + 2 KT) tiles of 64 x DP; ``lb_core.cuh``'s
    statistics, dq partials, dk / dv partials and d-bias slabs, then the
    bias in fragment order (heads x QT x KT tiles of 64 x 64)."""
    qt, kt, dp = _tiles(nq), _tiles(nk), _dp(d)
    return (bw * heads * (2 * qt + 2 * kt) * _TOK * dp,
            large_bwd.plan(bw, heads, qt, kt, dp, sms).f_elems + heads * qt * kt * _TOK * _TOK)


def oca_core_plain(q, k, v, bias):
    """``studiosr_tpu/ops/oca_vjp.py::_core_math`` in f32, returned in ``q.dtype``."""
    p = torch.softmax(q.float() @ k.float().transpose(-1, -2) + bias.float()[None], dim=-1)
    return (p @ v.float()).to(q.dtype)


def oca_core_bwd_plain(q, k, v, bias, g):
    """The explicit formulas of ``oca_core.py::_bwd_kernel`` in f32: (dq, dk,
    dv) in ``q.dtype`` and d bias (heads, nq, nk) in f32."""
    q32, k32, v32, g32 = q.float(), k.float(), v.float(), g.float()
    p = torch.softmax(q32 @ k32.transpose(-1, -2) + bias.float()[None], dim=-1)
    dv = p.transpose(-1, -2) @ g32
    dp = g32 @ v32.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq, dk = ds @ k32, ds.transpose(-1, -2) @ q32
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), ds.sum(0)


def _geometry(name: str, q, k, v):
    """(bw, heads, nq, nk, d) after checking what the kernels take."""
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share one dtype of {KERNEL_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)} do not fit")
    bw, heads, nq, d = q.shape
    nk = k.shape[2]
    if k.shape[0] != bw or k.shape[1] != heads or k.shape[3] != d or min(bw, heads, nq, nk, d) < 1:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} do not fit")
    if d > MAX_HEAD_DIM:
        raise NotImplementedError(f"{name}: the kernels take d <= {MAX_HEAD_DIM}, not d {d}")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"{name}: operands on {q.device} and {t.device}")
    return bw, heads, nq, nk, d


def _rows(t):
    """``t`` with its last dimension contiguous (a view when it already is)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _out(bw: int, heads: int, n: int, d: int, like):
    """An output (bw, heads, n, d), laid out as (bw, n, heads, d)."""
    return torch.empty(bw, n, heads, d, dtype=like.dtype, device=like.device).transpose(1, 2)


def _strides(*tensors):
    flat = []
    for t in tensors:
        flat += [0, 0, 0] if t is None else list(t.stride()[:3])
    return (_LL * len(flat))(*flat)


def oca_core_fwd(q, k, v, bias):
    """softmax(q k^T + bias) v (B12). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return oca_core_plain(q, k, v, bias)
    bw, heads, nq, nk, d = _geometry("oca_core_fwd", q, k, v)
    q, k, v = _rows(q), _rows(k), _rows(v)
    dev = q.device
    out = _out(bw, heads, nq, d, q)
    strides = _strides(q, k, v, None, out, None, None, None)
    if q.dtype == torch.bfloat16 and d <= MMA_MAX_HEAD_DIM:
        # a bf16 bias is read as it is (the same values as in f32, half the bytes); any other in f32
        bdt = torch.bfloat16 if torch.is_tensor(bias) and bias.dtype == torch.bfloat16 else torch.float32
        b = operand(bias, "bias", (heads, nq, nk), bdt, dev)
        lib = _build.load("oca_fwd_mma", _SIGNATURES_FWD_MMA)
        large = not mma_takes(heads, nq, nk, d)
        entry = "oca_core_fwd_large_mma_bf16" if large else "oca_core_fwd_mma_bf16"
        t_elems = _LL()
        # the large entry's scratch holds the bias in fragment order, in its dtype
        flag = (int(bdt == torch.bfloat16),) if large else ()
        status = call(dev, getattr(lib, entry.replace("_bf16", "_scratch")), bw, heads, nq, nk, d, *flag,
                      ctypes.byref(t_elems))
        if status != 0:
            raise RuntimeError(f"oca_core_fwd: CUDA error {status} while sizing the scratch")
        tscratch = torch.empty(t_elems.value, dtype=q.dtype, device=dev)
        status = call(dev, getattr(lib, entry), q.data_ptr(), k.data_ptr(), v.data_ptr(), b.data_ptr(), out.data_ptr(),
                      strides, int(bdt == torch.bfloat16), bw, heads, nq, nk, d, tscratch.data_ptr(), t_elems.value,
                      STREAM)
    else:
        b = operand(bias, "bias", (heads, nq, nk), torch.float32, dev)
        lib = _build.load("oca_core", _SIGNATURES, _RESTYPES)
        entry = "oca_core_fwd_bf16" if q.dtype == torch.bfloat16 else "oca_core_fwd_f32"
        status = call(dev, getattr(lib, entry), q.data_ptr(), k.data_ptr(), v.data_ptr(), b.data_ptr(), out.data_ptr(),
                      strides, bw, heads, nq, nk, d, STREAM)
    finish(counter("oca_core_fwd", nq, nk), status, entry)
    return out


def oca_core_bwd(q, k, v, bias, g):
    """(dq, dk, dv, d bias) of :func:`oca_core_fwd` for the cotangent ``g``
    (B13); d bias in f32. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if q.device.type == "cpu":
        return oca_core_bwd_plain(q, k, v, bias, g)
    bw, heads, nq, nk, d = _geometry("oca_core_bwd", q, k, v)
    if tuple(g.shape) != tuple(q.shape) or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"oca_core_bwd: g {tuple(g.shape)} {g.dtype} does not match q {tuple(q.shape)} {q.dtype}")
    q, k, v, g = _rows(q), _rows(k), _rows(v), _rows(g)
    dev = q.device
    large = q.dtype == torch.bfloat16 and d <= MMA_MAX_HEAD_DIM and not mma_takes(heads, nq, nk, d)
    # the large entry reads a bf16 bias (the bf16 step's) as it is; the others read f32
    bdt = torch.bfloat16 if large and torch.is_tensor(bias) and bias.dtype == torch.bfloat16 else torch.float32
    b32 = operand(bias, "bias", (heads, nq, nk), bdt, dev)
    dq, dk, dv = _out(bw, heads, nq, d, q), _out(bw, heads, nk, d, q), _out(bw, heads, nk, d, q)
    dbias = torch.empty(heads, nq, nk, dtype=torch.float32, device=dev)
    strides = _strides(q, k, v, g, None, dq, dk, dv)
    ptrs = [t.data_ptr() for t in (q, k, v, b32, g, dq, dk, dv, dbias)]
    if q.dtype == torch.float32 and mma_takes(heads, nq, nk, d):
        lib = _build.load("oca_bwd_f32", _SIGNATURES_F32)
        entry = "oca_core_bwd_mma_f32"
        f_elems = _LL()
        status = call(dev, lib.oca_core_bwd_mma_f32_scratch, bw, heads, nq, nk, d, ctypes.byref(f_elems))
        if status != 0:
            raise RuntimeError(f"oca_core_bwd: CUDA error {status} while sizing the scratch")
        fscratch = torch.empty(f_elems.value, dtype=torch.float32, device=dev)
        status = call(dev, lib.oca_core_bwd_mma_f32, *ptrs, strides, bw, heads, nq, nk, d, fscratch.data_ptr(),
                      f_elems.value, STREAM)
    elif q.dtype == torch.bfloat16 and d <= MMA_MAX_HEAD_DIM:
        lib = _build.load("oca_bwd_mma", _SIGNATURES_MMA)
        entry = "oca_core_bwd_large_mma_bf16" if large else "oca_core_bwd_mma_bf16"
        t_elems, f_elems = _LL(), _LL()
        status = call(dev, getattr(lib, entry.replace("_bf16", "_scratch")), bw, heads, nq, nk, d,
                      ctypes.byref(t_elems), ctypes.byref(f_elems))
        if status != 0:
            raise RuntimeError(f"oca_core_bwd: CUDA error {status} while sizing the scratch")
        tscratch = torch.empty(t_elems.value, dtype=q.dtype, device=dev)
        fscratch = torch.empty(f_elems.value, dtype=torch.float32, device=dev)
        flag = (int(bdt == torch.bfloat16),) if large else ()
        status = call(dev, getattr(lib, entry), *ptrs, strides, *flag, bw, heads, nq, nk, d, tscratch.data_ptr(),
                      t_elems.value, fscratch.data_ptr(), f_elems.value, STREAM)
    else:
        lib = _build.load("oca_core", _SIGNATURES, _RESTYPES)
        f_elems = call(dev, lib.oca_core_bwd_scratch, bw, heads, nq, nk)
        fscratch = torch.empty(f_elems, dtype=torch.float32, device=dev)
        entry = "oca_core_bwd_bf16" if q.dtype == torch.bfloat16 else "oca_core_bwd_f32"
        status = call(dev, getattr(lib, entry), *ptrs, strides, bw, heads, nq, nk, d, fscratch.data_ptr(), f_elems,
                      STREAM)
    finish(counter("oca_core_bwd", nq, nk), status, entry)
    return dq, dk, dv, dbias
