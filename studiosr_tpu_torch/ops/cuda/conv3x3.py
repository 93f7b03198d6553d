"""B2: fused 3x3 convolution (CUDA kernel ``csrc/conv3x3.cu``).

Replaces ``studiosr_tpu/ops/pallas/conv3x3.py::fused_conv3x3``:
y = act(conv3x3(x) + b) [+ x] [+ extra] on NHWC maps with zero SAME padding
and f32 accumulation, in one pass over the map. ``activation`` is None,
``"relu"`` or ``"lrelu{slope}"`` (slope 0.01 when omitted). Any Cout.

Weights are HWIO (3, 3, Cin, Cout) in the map's dtype; the bias is f32.

Also B11, ``fused_cab_body`` (CUDA kernels ``csrc/cab_body.cu``): HAT's CAB
trunk y2 = conv2(gelu(conv1(LN x))) with the per-image f32 channel sums of
y2 that feed the squeeze-excite gate.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from studiosr_tpu_torch.ops.cuda import _build
from studiosr_tpu_torch.ops.cuda._launch import KERNEL_DTYPES, P, I, F as CF, check, finish, stream

__all__ = [
    "fused_conv3x3", "conv3x3_plain", "prepare_conv3x3_weights", "parse_activation", "fused_cab_body",
    "cab_body_plain",
]

_ARGS = (P, P, P, P, P, I, I, I, I, I, I, CF, I, P)
_SIGNATURES = {"conv3x3_f32": _ARGS, "conv3x3_bf16": _ARGS}
_CAB_ARGS = (P,) * 12 + (I,) * 5 + (P,)
_CAB_SIGNATURES = {"cab_body_f32": _CAB_ARGS, "cab_body_bf16": _CAB_ARGS, "cab_body_partials": (I, I, I)}
_ACT_CODES = {None: 0, "relu": 1, "lrelu": 2}  # shared with csrc/conv3x3.cuh


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


def conv3x3_plain(x, w, b, activation: Optional[str] = None, residual: bool = False, extra=None):
    """Plain PyTorch version, computed in f32 and returned in ``x.dtype``."""
    xf = x.float()
    y = F.conv2d(xf.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), b.float(), padding=1).permute(0, 2, 3, 1)
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
    """(B, H, W, Cin) -> (B, H, W, Cout). CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, activation, residual, extra)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_conv3x3: unsupported dtype {x.dtype}")
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    if residual and cin != cout:
        raise ValueError(f"fused_conv3x3: residual needs Cin == Cout, got {cin} and {cout}")
    kind, slope = parse_activation(activation)
    dev = x.device
    px = check(x, "x", (bsz, h, wd, cin), x.dtype, dev)
    pw = check(w, "w", (3, 3, cin, cout), x.dtype, dev)
    pb = check(b, "b", (cout,), torch.float32, dev)
    pe = None if extra is None else check(extra, "extra", (bsz, h, wd, cout), x.dtype, dev)
    out = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=dev)
    lib = _build.load("conv3x3", _SIGNATURES)
    fn = lib.conv3x3_bf16 if x.dtype == torch.bfloat16 else lib.conv3x3_f32
    status = fn(px, pw, pb, pe, out.data_ptr(), bsz, h, wd, cin, cout, _ACT_CODES[kind], slope, int(residual), stream(dev))
    finish("fused_conv3x3", status)
    return out


def cab_body_plain(x, ln_w, ln_b, w1, b1, w2, b2):
    """Plain PyTorch version of B11, computed in f32: returns (y2 in
    ``x.dtype``, f32 (B, C) sums of y2 over H and W). The convs zero-pad
    the LayerNorm output and h1, as HAT's CAB does."""
    ln = F.layer_norm(x.float(), (x.shape[-1],), ln_w.float(), ln_b.float(), 1e-5)
    h1 = F.gelu(conv3x3_plain(ln, w1, b1))
    y2 = conv3x3_plain(h1, w2, b2)
    return y2.to(x.dtype), y2.sum(dim=(1, 2))


def fused_cab_body(x, ln_w, ln_b, w1, b1, w2, b2):
    """B11: (B, H, W, C) block input -> (y2 (B, H, W, C), channel sums (B, C)
    f32). ``w1`` (3, 3, C, Cm) and ``w2`` (3, 3, Cm, C) HWIO in the map's
    dtype; LayerNorm weights and conv biases f32. CPU tensors take the plain
    version; CUDA tensors launch the kernels or raise."""
    if x.device.type == "cpu":
        return cab_body_plain(x, ln_w, ln_b, w1, b1, w2, b2)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_cab_body: unsupported dtype {x.dtype}")
    bsz, h, wd, c = x.shape
    cm = w1.shape[-1]
    dev, dt, f32 = x.device, x.dtype, torch.float32
    ptrs = [
        check(x, "x", (bsz, h, wd, c), dt, dev),
        check(ln_w, "ln_w", (c,), f32, dev), check(ln_b, "ln_b", (c,), f32, dev),
        check(w1, "w1", (3, 3, c, cm), dt, dev), check(b1, "b1", (cm,), f32, dev),
        check(w2, "w2", (3, 3, cm, c), dt, dev), check(b2, "b2", (c,), f32, dev),
    ]
    lib = _build.load("cab_body", _CAB_SIGNATURES)
    ln = torch.empty_like(x)
    h1 = torch.empty((bsz, h, wd, cm), dtype=dt, device=dev)
    partials = torch.empty((bsz, lib.cab_body_partials(h, wd, c), c), dtype=f32, device=dev)
    out = torch.empty_like(x)
    sums = torch.empty((bsz, c), dtype=f32, device=dev)
    fn = lib.cab_body_bf16 if dt == torch.bfloat16 else lib.cab_body_f32
    status = fn(*ptrs, ln.data_ptr(), h1.data_ptr(), partials.data_ptr(), out.data_ptr(), sums.data_ptr(),
                bsz, h, wd, c, cm, stream(dev))
    finish("fused_cab_body", status)
    return out, sums
