"""B2: fused 3x3 convolution (CUDA kernel ``csrc/conv3x3.cu``).

Replaces ``studiosr_tpu/ops/pallas/conv3x3.py::fused_conv3x3``:
y = act(conv3x3(x) + b) [+ x] [+ extra] on NHWC maps with zero SAME padding
and f32 accumulation, in one pass over the map. ``activation`` is None,
``"relu"`` or ``"lrelu{slope}"`` (slope 0.01 when omitted). Any Cout.

Weights are HWIO (3, 3, Cin, Cout) in the map's dtype, or packed: in bf16
the layout of :func:`pack_conv3x3_weights`, in f32 with Cout > 16 that of
:func:`pack_conv3x3_f32_weights` (what serving prepares once at load time,
:func:`prepare_fused_conv3x3_weights`); the bias is f32. bf16 launches the
kernel written for the H100 (``csrc/conv3x3_mma.cuh``, C entry
``conv3x3_mma_bf16``), f32 with Cout > 16 the 3xTF32 kernel written for it
(``csrc/conv3x3_f32.cuh``, ``conv3x3_mma_f32``), both on packed weights
(HWIO weights are packed first, on every call); f32 with Cout <= 16 the FMA
kernel of ``csrc/conv3x3.cuh`` (``conv3x3_f32``) on HWIO weights
(:func:`f32_mma_takes`). ``engagement.entries()`` tells them apart.

Also B11, ``fused_cab_body``: HAT's CAB trunk y2 = res_scale
conv2(gelu(conv1(LN x))) with the per-image f32 channel sums of y2 that
feed the squeeze-excite gate. bf16 with C even up to 192 and Cm up to 64
(:func:`cab_mma_takes`) launches the kernel written for the H100
(``csrc/cab_mma.cu``, C entry ``cab_body_mma_bf16``) on weights packed by
:func:`pack_cab_weights`; f32 with C a multiple of 4 up to 256 and Cm up to
64 (:func:`cab_f32_mma_takes`) the 3xTF32 one there (``cab_body_mma_f32``,
on B2's f32 kernel) on weights packed by :func:`pack_cab_f32_convs` (serving
packs both at load time, HWIO weights are packed per call); other
geometries run ``csrc/cab_body.cu`` (``cab_body_f32`` / ``cab_body_bf16``)
on HWIO weights. And B14,
``fused_resblock`` (CUDA kernels ``csrc/resblock.cu``, replacing
``conv3x3.py::fused_resblock``):
y = x + res_scale (conv2(act(conv1(x) + b1)) + b2), SwinFIR's SFB spatial
branch, at any height (the JAX wrapper declines odd ones to two convs). In
bf16 both of its passes run B2's kernel written for the H100 on packed
weights (C entry ``resblock_mma_bf16``; serving packs them at load time,
HWIO weights are packed per call); f32 with C > 16 both on B2's f32 kernel
written for it (``resblock_mma_f32``, packed the same way), f32 with C <= 16
``resblock_f32`` on HWIO.

The f32 packed weights carry hi and lo TF32 images (``cvt.rna``), so the
plain version on them multiplies by hi + lo, which is within 2^-22 |w| of
the weights they were packed from.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from studiosr_tpu_torch.ops.cuda import _build
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, F as CF, aligned, check, finish, operand, STREAM, call
from studiosr_tpu_torch.ops.cuda.tf32x3 import split

__all__ = [
    "fused_conv3x3", "conv3x3_plain", "prepare_conv3x3_weights", "pack_conv3x3_weights", "unpack_conv3x3_weights",
    "prepare_fused_conv3x3_weights", "parse_activation", "fused_cab_body", "cab_body_plain", "fused_resblock",
    "resblock_plain", "cab_mma_takes", "pack_cab_weights", "pack_cab_convs", "unpack_cab_weights", "packed_cab_shape",
    "cab_partition", "f32_mma_takes", "pack_conv3x3_f32_weights", "unpack_conv3x3_f32_weights",
    "packed_conv3x3_f32_shape", "cab_f32_mma_takes", "pack_cab_f32_convs", "cab_f32_partition",
]

_ARGS = (P, P, P, P, P, I, I, I, I, I, I, CF, I, P)
_SIGNATURES = {"conv3x3_f32": _ARGS, "conv3x3_mma_bf16": _ARGS, "conv3x3_mma_f32": _ARGS,
               "conv3x3_mma_f32_elements": (I, I)}
_RESTYPES = {"conv3x3_mma_f32_elements": ctypes.c_longlong}
_CAB_ARGS = (P,) * 12 + (I,) * 5 + (CF, P)
_CAB_SIGNATURES = {"cab_body_f32": _CAB_ARGS, "cab_body_bf16": _CAB_ARGS, "cab_body_partials": (I, I, I)}
_CAB_MMA_SIGNATURES = {"cab_body_mma_bf16": _CAB_ARGS, "cab_body_mma_tiles": (I, I), "cab_body_mma_f32": _CAB_ARGS,
                       "cab_body_mma_f32_tiles": (I, I)}
# csrc/cab_mma.cu: conv1's and conv2's columns a ring slot, input channels a
# slot (K chunk), the pixel tile, the widest C and Cm
_CAB_N1, _CAB_N2, _CAB_KC, _CAB_TILE, _CAB_MAX_C, _CAB_MAX_CM = 64, 96, 64, (16, 8), 192, 64
_RES_ARGS = (P,) * 7 + (I,) * 5 + (CF, CF, P)
_RES_SIGNATURES = {"resblock_f32": _RES_ARGS, "resblock_mma_bf16": _RES_ARGS, "resblock_mma_f32": _RES_ARGS}
_ACT_CODES = {None: 0, "relu": 1, "lrelu": 2}  # shared with csrc/conv3x3.cuh
_MMA_KC, _MMA_BLOCK = 16, 192  # csrc/conv3x3_mma.cuh: input channels a stage, output channels a block
# csrc/conv3x3_f32.cuh: output channels a block (CT_BN), input channels a chunk (CT_KC); Cout up to _F32_NARROW keeps conv3x3.cuh
_F32_BN, _F32_KC, _F32_NARROW = 96, 32, 16
# csrc/cab_mma.cu's f32 entry: the widest C (TF_MAX_C) and Cm; the pixel tile (CT_TH, CT_TW)
_CAB_F32_MAX_C, _CAB_F32_TILE = 256, (12, 16)


def packed_conv3x3_shape(cin: int, cout: int) -> Tuple[int, ...]:
    """(Cout blocks of 192, Cin stages of 16, 9 taps, 16 channels, 200)."""
    return (-(-cout // _MMA_BLOCK), -(-cin // _MMA_KC), 9, _MMA_KC, _MMA_BLOCK + 8)


def parse_activation(kind: Optional[str]) -> Tuple[Optional[str], float]:
    """None / "relu" / "lrelu[slope]" -> (kind, slope)."""
    if kind is None or kind == "relu":
        return kind, 0.0
    if kind.startswith("lrelu"):
        return "lrelu", float(kind[5:]) if len(kind) > 5 else 0.01
    raise ValueError(f"unknown activation {kind!r}")


def prepare_conv3x3_weights(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """torch OIHW 3x3 conv weight -> contiguous HWIO (3, 3, Cin, Cout) in ``dtype``."""
    return weight.detach().permute(2, 3, 1, 0).to(dtype).contiguous()


def pack_conv3x3_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) -> B2's packed bf16 weights: for each block of
    output channels and each stage of 16 input channels, the (9, 16, width +
    8) image of the kernel's shared-memory stage, zero past Cin and Cout, so
    the kernel copies whole 16-byte pieces."""
    _, _, cin, cout = w.shape
    nblk, nst, _, kc, wl = packed_conv3x3_shape(cin, cout)
    n = wl - 8
    taps = F.pad(w.detach().to(torch.bfloat16).reshape(9, cin, cout), (0, nblk * n - cout, 0, nst * kc - cin))
    packed = torch.zeros(nblk, nst, 9, kc, wl, dtype=torch.bfloat16, device=w.device)
    packed[..., :n] = taps.reshape(9, nst, kc, nblk, n).permute(3, 1, 0, 2, 4)
    return packed


def unpack_conv3x3_weights(packed: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """Inverse of :func:`pack_conv3x3_weights`: HWIO (3, 3, Cin, Cout)."""
    nblk, nst, _, kc, wl = packed_conv3x3_shape(cin, cout)
    if tuple(packed.shape) != (nblk, nst, 9, kc, wl):
        raise ValueError(f"packed weights {tuple(packed.shape)} do not fit Cin {cin}, Cout {cout}")
    taps = packed[..., : wl - 8].permute(2, 1, 3, 0, 4).reshape(9, nst * kc, nblk * (wl - 8))
    return taps[:, :cin, :cout].reshape(3, 3, cin, cout)


def f32_mma_takes(cout: int) -> bool:
    """Whether an f32 conv runs the 3xTF32 kernel written for the H100
    (``csrc/conv3x3_f32.cuh``, packed weights): Cout > 16. Narrower ones
    (conv_last) keep ``csrc/conv3x3.cuh``'s FMA kernel on HWIO, where one
    96-column tile would be mostly padding."""
    return cout > _F32_NARROW


def packed_conv3x3_f32_shape(cin: int, cout: int, bn: int = _F32_BN) -> Tuple[int, ...]:
    """(N tiles of ``bn`` output channels (96; B11's conv1 64), chunks of 32
    input channels, 9 taps, hi | lo, a 32 x bn image)."""
    return (-(-cout // bn), -(-cin // _F32_KC), 9, 2, bn * _F32_KC)


def pack_conv3x3_f32_weights(w: torch.Tensor, bn: int = _F32_BN) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) f32 -> the f32 kernel's packed weights: for
    each tile of ``bn`` output channels, chunk of 32 input channels and tap,
    the hi image tf32(w) then the lo image tf32(w - hi) of the 32 x bn block
    (zero past Cin and Cout), element (k, n) at (n / 8) 256 + (k / 4) 32 +
    (n % 8) 4 + k % 4 (``tfw_image``: wgmma's K-major core matrices of 8 n x
    4 k), the image of a ring slot."""
    _, _, cin, cout = w.shape
    nt, nch, _, _, _ = packed_conv3x3_f32_shape(cin, cout, bn)
    taps = F.pad(w.detach().float().reshape(9, cin, cout), (0, nt * bn - cout, 0, nch * _F32_KC - cin))
    blocks = taps.reshape(9, nch, _F32_KC, nt, bn).permute(3, 1, 0, 2, 4)  # (nt, nch, 9, k, n)
    img = blocks.reshape(nt, nch, 9, _F32_KC // 4, 4, bn // 8, 8).permute(0, 1, 2, 5, 3, 6, 4)
    hi, lo = split(img.reshape(nt, nch, 9, bn * _F32_KC).contiguous())
    return torch.stack([hi, lo], 3)


def unpack_conv3x3_f32_weights(packed: torch.Tensor, cin: int, cout: int, bn: int = _F32_BN) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) from :func:`pack_conv3x3_f32_weights`'s
    images: hi + lo, within 2^-22 |w| of the packed weights."""
    shape = packed_conv3x3_f32_shape(cin, cout, bn)
    if tuple(packed.shape) != shape or packed.dtype != torch.float32:
        raise ValueError(f"packed f32 weights {tuple(packed.shape)} do not fit Cin {cin}, Cout {cout}: expected {shape}")
    nt, nch = shape[:2]
    img = (packed[:, :, :, 0] + packed[:, :, :, 1]).reshape(nt, nch, 9, bn // 8, _F32_KC // 4, 8, 4)
    blocks = img.permute(0, 1, 2, 4, 6, 3, 5).reshape(nt, nch, 9, _F32_KC, bn)
    taps = blocks.permute(2, 1, 3, 0, 4).reshape(9, nch * _F32_KC, nt * bn)
    return taps[:, :cin, :cout].reshape(3, 3, cin, cout)


def prepare_fused_conv3x3_weights(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """torch OIHW 3x3 conv weight -> B2's (and B14's) weight operand, laid
    out once at load time: packed for bf16 (the kernel's own layout) and for
    f32 with Cout > 16 (the f32 kernel's hi / lo images), HWIO otherwise. B11
    packs its own (:func:`pack_cab_weights`); B3 and B4 pack theirs with
    ``upsampler.pack_tail``."""
    hwio = prepare_conv3x3_weights(weight, dtype)
    if dtype == torch.bfloat16:
        return pack_conv3x3_weights(hwio)
    return pack_conv3x3_f32_weights(hwio) if f32_mma_takes(hwio.shape[3]) else hwio


def _hwio(w: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    if w.dim() != 5:
        return w
    return unpack_conv3x3_weights(w, cin, cout) if w.dtype == torch.bfloat16 else unpack_conv3x3_f32_weights(
        w, cin, cout)


def _b2_weights(w: torch.Tensor, name: str, cin: int, cout: int, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """B2's weight operand as the kernel of ``dtype`` reads it: in bf16, and
    in f32 with Cout > 16, the packed layout (HWIO packed on the way), in
    f32 with Cout <= 16 HWIO; raises otherwise."""
    if dtype == torch.bfloat16:
        if w.dim() == 4:
            check(w, name, (3, 3, cin, cout), dtype, dev)
            w = pack_conv3x3_weights(w)
        check(w, name, packed_conv3x3_shape(cin, cout), dtype, dev)
    elif f32_mma_takes(cout):
        if w.dim() == 4:
            check(w, name, (3, 3, cin, cout), dtype, dev)
            w = pack_conv3x3_f32_weights(w)
        check(w, name, packed_conv3x3_f32_shape(cin, cout), dtype, dev)
    else:
        check(w, name, (3, 3, cin, cout), dtype, dev)
    return w


def _entry(kind: str, dtype: torch.dtype, cout: int) -> str:
    """The C entry of B2 (``kind`` "conv3x3") or B14 ("resblock") for
    ``dtype`` and ``cout``."""
    if dtype == torch.bfloat16:
        return f"{kind}_mma_bf16"
    return f"{kind}_mma_f32" if f32_mma_takes(cout) else f"{kind}_f32"


def conv3x3_plain(x, w, b, activation: Optional[str] = None, residual: bool = False, extra=None, mm=None):
    """Plain PyTorch version, computed in f32 and returned in ``x.dtype``;
    ``w`` HWIO or packed. With ``mm`` (``tf32x3.matmul``: the f32 kernel's
    products) the conv is an im2col product through it."""
    w = _hwio(w, x.shape[-1], b.shape[0])
    xf = x.float()
    if mm is None:
        y = F.conv2d(xf.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), b.float(), padding=1).permute(0, 2, 3, 1)
    else:
        bsz, h, wd, cin = xf.shape
        xp = F.pad(xf, (0, 0, 1, 1, 1, 1))
        cols = torch.stack([xp[:, dy:dy + h, dx:dx + wd] for dy in range(3) for dx in range(3)], 3)
        y = mm(cols.reshape(-1, 9 * cin), w.float().reshape(9 * cin, -1)).reshape(bsz, h, wd, -1) + b.float()
    kind, slope = parse_activation(activation)
    if kind == "relu":
        y = torch.relu(y)
    elif kind == "lrelu":
        y = torch.where(y >= 0, y, slope * y)
    if residual:
        y = y + xf
    if extra is not None:
        y = y + extra.float()
    return y.to(x.dtype)


def fused_conv3x3(x, w, b, activation: Optional[str] = None, residual: bool = False, extra=None):
    """(B, H, W, Cin) -> (B, H, W, Cout); ``w`` HWIO, or packed (bf16; f32
    with Cout > 16). CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, activation, residual, extra)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_conv3x3: unsupported dtype {x.dtype}")
    bsz, h, wd, cin = x.shape
    cout = b.shape[0]
    if residual and cin != cout:
        raise ValueError(f"fused_conv3x3: residual needs Cin == Cout, got {cin} and {cout}")
    kind, slope = parse_activation(activation)
    dev = x.device
    px = check(x, "x", (bsz, h, wd, cin), x.dtype, dev)
    w = _b2_weights(w, "w", cin, cout, x.dtype, dev)  # kept alive until the launch is enqueued
    pw = w.data_ptr()
    pb = check(b, "b", (cout,), torch.float32, dev)
    pe = None if extra is None else check(extra, "extra", (bsz, h, wd, cout), x.dtype, dev)
    out = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=dev)
    lib = _build.load("conv3x3", _SIGNATURES, _RESTYPES)
    entry = _entry("conv3x3", x.dtype, cout)
    status = call(dev, getattr(lib, entry), px, pw, pb, pe, out.data_ptr(), bsz, h, wd, cin, cout, _ACT_CODES[kind],
                  slope, int(residual), STREAM)
    finish("fused_conv3x3", status, entry)
    return out


def cab_mma_takes(c: int, cm: int) -> bool:
    """Whether B11's bf16 kernel written for the H100 takes this geometry: C
    even up to 192 (conv1's K, 64 a slot, at most three slots a tap; conv2's
    columns in pairs), Cm up to 64 (conv1's N)."""
    return 2 <= c <= _CAB_MAX_C and c % 2 == 0 and 1 <= cm <= _CAB_MAX_CM


def cab_f32_mma_takes(c: int, cm: int) -> bool:
    """Whether B11's f32 kernel written for the H100 (``cab_body_mma_f32``)
    takes this geometry: C a multiple of 4 up to 256 (its LN row pass, four
    channels a piece; conv2's N tiles of 96), Cm up to 64 (conv1's one N
    tile of 64)."""
    return 4 <= c <= _CAB_F32_MAX_C and c % 4 == 0 and 1 <= cm <= _CAB_MAX_CM


def pack_cab_f32_convs(w1: torch.Tensor, w2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """B11's two HWIO f32 convs packed as its f32 kernel reads them
    (:func:`pack_conv3x3_f32_weights`' hi / lo images): conv1 in 64-column
    tiles, conv2 in 96."""
    return pack_conv3x3_f32_weights(w1, _CAB_N1), pack_conv3x3_f32_weights(w2, _CAB_N2)


def cab_f32_partition(h: int, w: int):
    """B11's pixel tiles as the f32 kernel's conv2 blocks take them: tile i
    (the partials' middle index) is the 12 x 16 pixels from (y0, x0) = (12
    (i // ceil(W / 16)), 16 (i % ceil(W / 16))), clipped to the map. Returns
    [(y0, y1, x0, x1)] in tile order."""
    th, tw = _CAB_F32_TILE
    tiles_w = -(-w // tw)
    return [(th * (i // tiles_w), min(th * (i // tiles_w) + th, h), tw * (i % tiles_w), min(tw * (i % tiles_w) + tw, w))
            for i in range(-(-h // th) * tiles_w)]


def packed_cab_shape(cin: int, cout: int, nc: int) -> Tuple[int, ...]:
    """(column chunks of nc, 9 taps, K chunks of 64 input channels, 8 groups
    of 8 input channels, nc / 8 groups of 8 columns, 8 columns, 8 input
    channels)."""
    return (-(-cout // nc), 9, -(-cin // _CAB_KC), _CAB_KC // 8, nc // 8, 8, 8)


def pack_cab_weights(w: torch.Tensor, nc: int) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) -> the bf16 layout of B11's weight ring (conv1
    ``nc`` 64, conv2 96): for each chunk of ``nc`` output columns, each tap
    and each chunk of 64 input channels, the image of a ring slot, wgmma's
    K-major operand: element (column n, input channel k) at [k / 8, n / 8, n
    % 8, k % 8], zero past Cin and Cout."""
    _, _, cin, cout = w.shape
    nchunk, _, kch, kg, ng, _, _ = packed_cab_shape(cin, cout, nc)
    wt = F.pad(w.detach().to(torch.bfloat16).reshape(9, cin, cout), (0, nchunk * nc - cout, 0, kch * _CAB_KC - cin))
    wt = wt.reshape(9, kch, kg, 8, nchunk, ng, 8)  # tap, K chunk, k / 8, k % 8, chunk, n / 8, n % 8
    return wt.permute(4, 0, 1, 2, 5, 6, 3).contiguous()


def pack_cab_convs(w1: torch.Tensor, w2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """B11's two HWIO convs packed as its bf16 kernel reads them: conv1 in
    chunks of 64 columns, conv2 of 96."""
    return pack_cab_weights(w1, _CAB_N1), pack_cab_weights(w2, _CAB_N2)


def unpack_cab_weights(packed: torch.Tensor, cin: int, cout: int, nc: int) -> torch.Tensor:
    """Inverse of :func:`pack_cab_weights`: HWIO (3, 3, Cin, Cout)."""
    shape = packed_cab_shape(cin, cout, nc)
    if tuple(packed.shape) != shape:
        raise ValueError(f"packed weights {tuple(packed.shape)} do not fit Cin {cin}, Cout {cout}: expected {shape}")
    nchunk, _, kch, _, ng, _, _ = shape
    wt = packed.permute(1, 2, 3, 6, 0, 4, 5).reshape(9, kch * _CAB_KC, nchunk * ng * 8)
    return wt[:, :cin, :cout].reshape(3, 3, cin, cout)


def cab_partition(h: int, w: int):
    """B11's pixel tiles as the H100 kernel's blocks take them: tile i (block
    i of an image, the partials' middle index) is the 16 x 8 pixels from
    (y0, x0) = (16 (i // ceil(W / 8)), 8 (i % ceil(W / 8))), clipped to the
    map. Returns [(y0, y1, x0, x1)] in tile order."""
    th, tw = _CAB_TILE
    tiles_w = -(-w // tw)
    return [(th * (i // tiles_w), min(th * (i // tiles_w) + th, h), tw * (i % tiles_w), min(tw * (i % tiles_w) + tw, w))
            for i in range(-(-h // th) * tiles_w)]


def _cab_hwio(w: torch.Tensor, cin: int, cout: int, nc: int) -> torch.Tensor:
    """HWIO from B11's bf16 (7 dims) or f32 (5 dims, ``nc``-column tiles) packed weights."""
    if w.dim() == 7:
        return unpack_cab_weights(w, cin, cout, nc)
    return unpack_conv3x3_f32_weights(w, cin, cout, nc) if w.dim() == 5 else w


def cab_body_plain(x, ln_w, ln_b, w1, b1, w2, b2, res_scale: float = 1.0, mm=None):
    """Plain PyTorch version of B11, computed in f32: returns (y2 in
    ``x.dtype``, f32 (B, C) sums of y2 over H and W), y2 = res_scale (conv2
    + b2). The convs zero-pad the LayerNorm output and h1, as HAT's CAB does;
    weights HWIO or packed. ``mm`` (``tf32x3.matmul``: the f32 kernel's
    products) takes both convs as im2col products."""
    c, cm = x.shape[-1], b1.shape[0]
    ln = F.layer_norm(x.float(), (c,), ln_w.float(), ln_b.float(), 1e-5)
    h1 = F.gelu(conv3x3_plain(ln, _cab_hwio(w1, c, cm, _CAB_N1), b1, mm=mm))
    y2 = res_scale * conv3x3_plain(h1, _cab_hwio(w2, cm, c, _CAB_N2), b2, mm=mm)
    return y2.to(x.dtype), y2.sum(dim=(1, 2))


def _cab_weights(w: torch.Tensor, name: str, cin: int, cout: int, nc: int, dev: torch.device) -> torch.Tensor:
    """A conv's weights as B11's bf16 kernel reads them (HWIO packed on the way)."""
    if w.dim() == 4:
        check(w, name, (3, 3, cin, cout), torch.bfloat16, dev)
        w = pack_cab_weights(w, nc)
    check(w, name, packed_cab_shape(cin, cout, nc), torch.bfloat16, dev)
    return w


def _cab_f32_weights(w: torch.Tensor, name: str, cin: int, cout: int, nc: int, dev: torch.device) -> torch.Tensor:
    """A conv's weights as B11's f32 kernel reads them (HWIO packed on the way)."""
    if w.dim() == 4:
        check(w, name, (3, 3, cin, cout), torch.float32, dev)
        w = pack_conv3x3_f32_weights(w, nc)
    check(w, name, packed_conv3x3_f32_shape(cin, cout, nc), torch.float32, dev)
    return w


def fused_cab_body(x, ln_w, ln_b, w1, b1, w2, b2, res_scale: float = 1.0):
    """B11: (B, H, W, C) block input -> (y2 (B, H, W, C), channel sums (B, C)
    f32). ``w1`` (3, 3, C, Cm) and ``w2`` (3, 3, Cm, C) HWIO in the map's
    dtype, or packed: in bf16 by :func:`pack_cab_weights` (conv1 in chunks of
    64 columns, conv2 of 96), in f32 by :func:`pack_cab_f32_convs`;
    LayerNorm weights and conv biases f32. CPU tensors take the plain
    version; CUDA tensors launch the kernels or raise."""
    if x.device.type == "cpu":
        return cab_body_plain(x, ln_w, ln_b, w1, b1, w2, b2, res_scale)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_cab_body: unsupported dtype {x.dtype}")
    bsz, h, wd, c = x.shape
    cm = b1.shape[0]
    dev, dt, f32 = x.device, x.dtype, torch.float32
    if dt == f32 and cab_f32_mma_takes(c, cm):
        return _cab_body_f32(x, ln_w, ln_b, w1, b1, w2, b2, res_scale)
    if w1.dim() == 5 or w2.dim() == 5:
        raise ValueError(f"fused_cab_body: f32 packed weights need a geometry cab_f32_mma_takes, not C {c}, Cm {cm}")
    mma = dt == torch.bfloat16 and cab_mma_takes(c, cm)
    if mma:  # kept alive until the launch is enqueued
        w1, w2 = _cab_weights(w1, "w1", c, cm, _CAB_N1, dev), _cab_weights(w2, "w2", cm, c, _CAB_N2, dev)
    ptrs = [
        check(x, "x", (bsz, h, wd, c), dt, dev),
        check(ln_w, "ln_w", (c,), f32, dev), check(ln_b, "ln_b", (c,), f32, dev),
        w1.data_ptr() if mma else check(w1, "w1", (3, 3, c, cm), dt, dev), check(b1, "b1", (cm,), f32, dev),
        w2.data_ptr() if mma else check(w2, "w2", (3, 3, cm, c), dt, dev), check(b2, "b2", (c,), f32, dev),
    ]
    out = torch.empty_like(x)
    sums = torch.empty((bsz, c), dtype=f32, device=dev)
    if mma:
        lib = _build.load("cab_mma", _CAB_MMA_SIGNATURES)
        ln = torch.empty((bsz, h, wd, -(-c // _CAB_KC) * _CAB_KC), dtype=dt, device=dev)
        h1 = torch.empty((bsz, h, wd, _CAB_N1), dtype=dt, device=dev)
        tiles = call(dev, lib.cab_body_mma_tiles, h, wd)
        entry = "cab_body_mma_bf16"
    else:
        lib = _build.load("cab_body", _CAB_SIGNATURES)
        ln = torch.empty_like(x)
        h1 = torch.empty((bsz, h, wd, cm), dtype=dt, device=dev)
        tiles = call(dev, lib.cab_body_partials, h, wd, c)
        entry = "cab_body_bf16" if dt == torch.bfloat16 else "cab_body_f32"
    partials = torch.empty((bsz, tiles, c), dtype=f32, device=dev)
    status = call(dev, getattr(lib, entry), *ptrs, ln.data_ptr(), h1.data_ptr(), partials.data_ptr(), out.data_ptr(),
                  sums.data_ptr(), bsz, h, wd, c, cm, float(res_scale), STREAM)
    finish("fused_cab_body", status, entry)
    return out, sums


def _cab_body_f32(x, ln_w, ln_b, w1, b1, w2, b2, res_scale):
    """The launch of ``csrc/cab_mma.cu``'s f32 entry (:func:`cab_f32_mma_takes`)
    on weights packed by :func:`pack_cab_f32_convs` (HWIO packed here)."""
    bsz, h, wd, c = x.shape
    cm = b1.shape[0]
    dev, f32 = x.device, torch.float32
    pad32 = lambda v: -(-v // _F32_KC) * _F32_KC  # noqa: E731
    # kept alive until the launch is enqueued; the kernel reads x, ln_w and ln_b four values at a time
    w1, w2 = _cab_f32_weights(w1, "w1", c, cm, _CAB_N1, dev), _cab_f32_weights(w2, "w2", cm, c, _CAB_N2, dev)
    check(x, "x", (bsz, h, wd, c), f32, dev)
    lnw = aligned(operand(ln_w, "ln_w", (c,), f32, dev))
    lnb = aligned(operand(ln_b, "ln_b", (c,), f32, dev))
    xa = aligned(x)
    ptrs = [xa.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), w1.data_ptr(), check(b1, "b1", (cm,), f32, dev),
            w2.data_ptr(), check(b2, "b2", (c,), f32, dev)]
    lib = _build.load("cab_mma", _CAB_MMA_SIGNATURES)
    ln = torch.empty((bsz, h, wd, pad32(c)), dtype=f32, device=dev)
    h1 = torch.empty((bsz, h, wd, pad32(cm)), dtype=f32, device=dev)
    partials = torch.empty((bsz, call(dev, lib.cab_body_mma_f32_tiles, h, wd), c), dtype=f32, device=dev)
    out = torch.empty_like(xa)
    sums = torch.empty((bsz, c), dtype=f32, device=dev)
    status = call(dev, lib.cab_body_mma_f32, *ptrs, ln.data_ptr(), h1.data_ptr(), partials.data_ptr(), out.data_ptr(),
                  sums.data_ptr(), bsz, h, wd, c, cm, float(res_scale), STREAM)
    finish("fused_cab_body", status, "cab_body_mma_f32")
    return out, sums


def resblock_plain(x, w1, b1, w2, b2, res_scale: float = 1.0, activation: Optional[str] = "relu"):
    """Plain PyTorch version of B14, computed in f32 and returned in
    ``x.dtype``; weights HWIO or packed. conv2's zero padding is h1 zero
    outside the image."""
    h1 = conv3x3_plain(x.float(), w1, b1, activation)
    return (x.float() + res_scale * conv3x3_plain(h1, w2, b2)).to(x.dtype)


def fused_resblock(x, w1, b1, w2, b2, res_scale: float = 1.0, activation: Optional[str] = "relu"):
    """B14: (B, H, W, C) -> x + res_scale (conv2(act(conv1(x) + b1)) + b2).
    ``w1``, ``w2`` HWIO (3, 3, C, C) in the map's dtype, or packed (bf16; f32
    with C > 16); biases f32; ``activation`` "relu", "lrelu[slope]" or None. CPU tensors
    take the plain version; CUDA tensors launch the kernels or raise."""
    if x.device.type == "cpu":
        return resblock_plain(x, w1, b1, w2, b2, res_scale, activation)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_resblock: unsupported dtype {x.dtype}")
    kind, slope = parse_activation(activation)
    bsz, h, wd, c = x.shape
    dev, dt, f32 = x.device, x.dtype, torch.float32
    w1, w2 = _b2_weights(w1, "w1", c, c, dt, dev), _b2_weights(w2, "w2", c, c, dt, dev)
    ptrs = [
        check(x, "x", (bsz, h, wd, c), dt, dev), w1.data_ptr(), check(b1, "b1", (c,), f32, dev),
        w2.data_ptr(), check(b2, "b2", (c,), f32, dev),
    ]
    h1 = torch.empty_like(x)
    out = torch.empty_like(x)
    lib = _build.load("resblock", _RES_SIGNATURES)
    entry = _entry("resblock", dt, c)
    status = call(dev, getattr(lib, entry), *ptrs, h1.data_ptr(), out.data_ptr(), bsz, h, wd, c, _ACT_CODES[kind],
                  slope, float(res_scale), STREAM)
    finish("fused_resblock", status, entry)
    return out
