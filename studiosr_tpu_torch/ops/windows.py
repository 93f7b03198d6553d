"""Window partitioning utilities for shifted-window attention (NHWC, torch).

Port of ``studiosr_tpu/ops/windows.py``: partition/reverse are reshapes and
permutes; the shift mask and the relative-position index are numpy tables
computed once per static shape (``lru_cache``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "window_partition",
    "window_reverse",
    "calculate_mask",
    "shift_region_ids",
    "relative_position_index",
    "relative_position_index_oca",
    "gather_rel_bias",
    "pad_to_multiple_reflect",
    "pad_to_multiple_flip",
]


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws, ws, C) in row-major window order."""
    b, h, w, c = x.shape
    ws = window_size
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, window_size: int, h: int, w: int) -> torch.Tensor:
    """(B * nW, ws, ws, C) -> (B, H, W, C), inverse of :func:`window_partition`."""
    ws = window_size
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def shift_region_ids(h: int, w: int, window_size: int, shift_size: int) -> np.ndarray:
    """(H, W) int region id of each position of the rolled map.

    Rows split into [0, H-ws), [H-ws, H-shift), [H-shift, H) and columns
    likewise; id = 3 * row_region + col_region. Two tokens of a window may
    attend to each other iff their ids are equal. This is the rule the CUDA
    Swin block (``csrc/swin_block.cu``, ``region_id``) evaluates per token
    instead of reading the dense mask; :func:`calculate_mask` builds the mask
    from the same regions.
    """

    def region(n: int, idx: np.ndarray) -> np.ndarray:
        return np.where(idx < n - window_size, 0, np.where(idx < n - shift_size, 1, 2))

    return 3 * region(h, np.arange(h))[:, None] + region(w, np.arange(w))[None, :]


@lru_cache(maxsize=512)
def calculate_mask(x_size: tuple, window_size: int, shift_size: int) -> np.ndarray:
    """Shifted-window attention mask, (nW, ws*ws, ws*ws) with 0 / -100 fill."""
    h, w = x_size
    img_mask = np.zeros((h, w), dtype=np.float32)
    slices = (
        slice(0, -window_size),
        slice(-window_size, -shift_size),
        slice(-shift_size, None),
    )
    cnt = 0
    for hs in slices:
        for ws_ in slices:
            img_mask[hs, ws_] = cnt
            cnt += 1

    ws = window_size
    mask_windows = img_mask.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    attn_mask = mask_windows[:, None, :] - mask_windows[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


@lru_cache(maxsize=64)
def relative_position_index(window_size: int) -> np.ndarray:
    """(ws*ws, ws*ws) gather indices into the (2ws-1)^2 rel-pos bias table."""
    coords = np.stack(np.meshgrid(np.arange(window_size), np.arange(window_size), indexing="ij"))
    coords = coords.reshape(2, -1)
    relative = coords[:, :, None] - coords[:, None, :]
    relative = relative.transpose(1, 2, 0)
    relative[:, :, 0] += window_size - 1
    relative[:, :, 1] += window_size - 1
    relative[:, :, 0] *= 2 * window_size - 1
    return relative.sum(-1).astype(np.int32)


@lru_cache(maxsize=64)
def relative_position_index_oca(window_size: int, overlap_ratio: float) -> np.ndarray:
    """(ws*ws, wse*wse) gather indices into the (ws + wse - 1)^2 table of
    overlapping cross-attention: queries on the ws grid, keys and values on
    the extended wse = ws + int(overlap_ratio * ws) grid around it."""
    ws_ori = window_size
    ws_ext = window_size + int(overlap_ratio * window_size)
    coords_ori = np.stack(np.meshgrid(np.arange(ws_ori), np.arange(ws_ori), indexing="ij")).reshape(2, -1)
    coords_ext = np.stack(np.meshgrid(np.arange(ws_ext), np.arange(ws_ext), indexing="ij")).reshape(2, -1)
    relative = coords_ext[:, None, :] - coords_ori[:, :, None]
    relative = relative.transpose(1, 2, 0)
    relative[:, :, 0] += ws_ori - ws_ext + 1
    relative[:, :, 1] += ws_ori - ws_ext + 1
    relative[:, :, 0] *= ws_ori + ws_ext - 1
    return relative.sum(-1).astype(np.int32)


def gather_rel_bias(table: torch.Tensor, rpi: np.ndarray, heads: int) -> torch.Tensor:
    """(table_len, heads) rel-pos bias table -> (heads, nq, nk) bias."""
    nq, nk = rpi.shape
    idx = torch.from_numpy(rpi.reshape(-1).astype(np.int64)).to(table.device)
    return table[idx].reshape(nq, nk, heads).permute(2, 0, 1)


def pad_to_multiple_reflect(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Reflect-pad NHWC bottom/right to a window multiple (training)."""
    _, h, w, _ = x.shape
    pad_h = (multiple - h % multiple) % multiple
    pad_w = (multiple - w % multiple) % multiple
    if pad_h or pad_w:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h), mode="reflect").permute(0, 2, 3, 1)
    return x


def pad_to_multiple_flip(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Flip-concat padding used by SwinIR at eval time.

    Always extends to the *next* multiple (even when already aligned).
    """
    _, h, w, _ = x.shape
    pad_h = (h // multiple + 1) * multiple - h
    pad_w = (w // multiple + 1) * multiple - w
    x = torch.cat([x, torch.flip(x, dims=(1,))], dim=1)[:, : h + pad_h]
    x = torch.cat([x, torch.flip(x, dims=(2,))], dim=2)[:, :, : w + pad_w]
    return x
