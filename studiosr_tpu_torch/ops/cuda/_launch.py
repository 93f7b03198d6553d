"""Operand checks and launch bookkeeping shared by the kernel wrappers.

A wrapper validates every operand before it hands a pointer to C, launches
on ``torch.cuda.current_stream()`` without synchronising, counts the launch
and raises on a non-zero launch status. There is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from studiosr_tpu_torch.ops.cuda import engagement

__all__ = ["P", "I", "F", "KERNEL_DTYPES", "check", "operand", "stream", "finish"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


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


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def finish(name: str, status: int) -> None:
    """Count the launch of ``name`` and raise if its status is not 0."""
    engagement.launched(name)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
