"""Operand checks and launch bookkeeping shared by the kernel wrappers.

A wrapper validates every operand before it hands a pointer to C, calls
every C entry through :func:`call` (which makes the operands' card the
current device and passes its current stream), launches without
synchronising, counts the launch and raises on a non-zero launch status.
There is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from studiosr_tpu_torch.ops.cuda import engagement

__all__ = ["P", "I", "F", "KERNEL_DTYPES", "STREAM", "check", "operand", "aligned", "call", "finish"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
STREAM = object()  # stands, among call()'s arguments, for the device's current stream


def check(t: Optional[torch.Tensor], name: str, shape: Sequence[int], dtype: torch.dtype, device: torch.device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if t is None:
        raise ValueError(f"{name} is required")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def operand(t: Optional[torch.Tensor], name: str, shape: Sequence[int], dtype: torch.dtype, device: torch.device):
    """``t`` (f32 or bf16, ``shape``, on ``device``) as a contiguous ``dtype``
    tensor the kernel can read; raise on anything else. The caller keeps the
    result alive until the launch has been enqueued."""
    if t is None:
        raise ValueError(f"{name} is required")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {KERNEL_DTYPES}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    return t.detach().to(dtype).contiguous()


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it, starting on a 16-byte boundary (for kernels
    that read four f32 values at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def call(device: torch.device, entry, *args):
    """``entry(*args)``, a C function of a kernel library, with ``device``
    the current CUDA device and the previous one current again afterwards:
    the C side reads the SM count, sets function attributes and launches on
    the current device. :data:`STREAM` among ``args`` becomes ``device``'s
    current stream. Every C entry is called through here, so a kernel runs
    on its operands' card whichever card the calling thread had current."""
    with torch.cuda.device(device):
        handle = torch.cuda.current_stream(device).cuda_stream
        return entry(*(handle if a is STREAM else a for a in args))


def finish(name: str, status: int, entry: Optional[str] = None) -> None:
    """Count the launch of ``name`` (through C function ``entry``, when
    named) and raise if its status is not 0."""
    engagement.launched(name, entry)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
