"""The plain version of the f32 kernels' 3xTF32 products (``csrc/tf32x3.cuh``).

An f32 operand a splits into a_hi = tf32(a) (``cvt.rna.tf32.f32``: 10
mantissa bits, round to nearest, ties away from zero) and a_lo =
tf32(a - a_hi); the product a b is a_lo b_hi + a_hi b_lo + a_hi b_hi, each
TF32 product exact in f32 and accumulated in f32, the small terms first.
:func:`matmul` repeats that arithmetic (the sums in PyTorch's order, not the
kernel's), so the plain versions of B7 and B8 (``mlp_bwd_plain`` and
``attention_bwd_plain``, ``mm=matmul``) show what the kernels' products do
to their results.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["tf32_round", "split", "matmul", "tfw_bn", "tfw_image_index", "pack_images"]
TF_BK = 32  # K rows of a stage (csrc/tf32x3.cuh)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32 as ``cvt.rna.tf32.f32`` does: half an
    ulp of the 10-bit mantissa added to the magnitude, the low 13 bits
    cleared; finite values only."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, not {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi); hi + lo is x to 2^-22 |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (f32) in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def tfw_bn(n: int) -> int:
    """The N tile of a row product on wgmma (``csrc/tf32x3.cuh`` tfw_bn):
    96 columns unless 64 pads ``n`` less."""
    return 96 if -(-n // 96) * 96 <= -(-n // 64) * 64 else 64


def tfw_image_index(src: np.ndarray, zero: int) -> np.ndarray:
    """A K x N product's weights (``src[k, n]``: the flat index of each) in
    the order ``tfw_pack`` writes their hi values: per N tile of
    ``tfw_bn(N)`` columns and 32-row K stage, element (k, n) of the stage at
    (n / 8) 256 + (k / 4) 32 + (n % 8) 4 + k % 4 (K-major core matrices of 8
    n x 4 k); ``zero`` past K and N."""
    k_, n_ = src.shape
    bn = tfw_bn(n_)
    stages, tiles = -(-k_ // TF_BK), -(-n_ // bn)
    full = np.full((stages * TF_BK, tiles * bn), zero, dtype=np.int64)
    full[:k_, :n_] = src
    k, n = np.meshgrid(np.arange(TF_BK), np.arange(bn), indexing="ij")
    pos = ((n // 8) * 256 + (k // 4) * 32 + (n % 8) * 4 + k % 4).ravel()
    out = np.empty(tiles * stages * bn * TF_BK, dtype=np.int64)
    for t in range(tiles):
        for s in range(stages):
            base = (t * stages + s) * bn * TF_BK
            out[base + pos] = full[s * TF_BK:(s + 1) * TF_BK, t * bn:(t + 1) * bn].ravel()
    return out


def pack_images(values: torch.Tensor, shapes) -> torch.Tensor:
    """``tfw_pack``'s images from the products' values in hi order (the
    gather by :func:`tfw_image_index`, products in order, ``shapes`` their
    (K, N)): each stage block of BN x 32 values as its hi image, tf32(v),
    then its lo image, tf32(v - hi)."""
    out, start = [], 0
    for k_, n_ in shapes:
        bnk = tfw_bn(n_) * TF_BK
        count = -(-k_ // TF_BK) * -(-n_ // tfw_bn(n_)) * bnk
        hi, lo = split(values[start:start + count].reshape(-1, bnk))
        out.append(torch.stack([hi, lo], 1).reshape(-1))
        start += count
    return torch.cat(out)
