"""The layout and block partition of ``csrc/lf_core.cuh``: the attention
core's forward above window 16 in bf16 (B5's large family, entry
``window_attention_large_mma_bf16``; B12's large entry,
``oca_core_fwd_large_mma_bf16``; B10's attention pass above 576 keys, inside
``ocab_mma_bf16``).

Plain Python, no card: the CPU tests hold the kernel's partition to its
rules with it (each score tile formed once, each output row one owner, the
key chunks in ascending order) and its shared memory to the source's
constants, and B12 / B10's bias order (``of_bias_kernel`` in
``of_attn.cuh``) element by element. Change it with ``LfLayout``,
``lf_layout``, ``lf_bias_tile`` and ``of_bias_kernel`` together.

On a unit u (window w, head h) of ``qt`` query tiles and ``kt`` key chunks
of 64 tokens, block b (one warpgroup, ``BLOCKS`` an SM) takes unit b // qt
and its query tile b % qt, forms the tile's scores against chunks 0 .. kt -
1 in order from the stages of its ring, and stores the tile's rows. A stage
holds the chunk's k and v images, the tile's bias against the chunk (64 x
64 in fragment order: B5's from ``am_bias_kernel``, B12 / B10's reordered
per call by ``of_bias_kernel``) and 64 key tags.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["SMEM", "BLOCKS", "MIN_STAGES", "MAX_STAGES", "TAGS", "Layout", "layout", "bias_tile", "of_perm",
           "of_bias_order", "partition"]

TOK = 64
BLOCKS = 4  # blocks an SM (LF_BLOCKS)
SMEM = 233472 // BLOCKS - 1024  # a block's share of the SM's shared memory (LF_SMEM)
MIN_STAGES, MAX_STAGES = 2, 4  # LF_MIN_STAGES, LF_MAX_STAGES
TAGS = 64  # bytes of key tags a stage (LF_TAGS)


class Layout(NamedTuple):
    dp: int
    stages: int
    bias_tile: int
    q_bytes: int
    stage_bytes: int
    bytes: int


def _layout(dp: int, stages: int, bias_tile: int) -> Layout:
    q = TOK * dp * 2
    stage = (2 * TOK * dp * 2 + bias_tile + TAGS + 127) // 128 * 128
    return Layout(dp, stages, bias_tile, q, stage, q + stages * stage + (MAX_STAGES + 1) * 8)


def layout(dp: int, bias_tile: int) -> Layout:
    """``lf_layout``: the most stages, from MAX_STAGES down to MIN_STAGES,
    whose shared memory fits SMEM; stages 0 where none does."""
    for s in range(MAX_STAGES, MIN_STAGES - 1, -1):
        lay = _layout(dp, s, bias_tile)
        if lay.bytes <= SMEM:
            return lay
    return _layout(dp, 0, bias_tile)


def bias_tile(bias16: bool) -> int:
    """``lf_bias_tile``: bytes of a (query tile, key chunk) bias in fragment
    order, 1024 float4 or 1024 groups of four bf16."""
    return (8 if bias16 else 16) * 8 * 128


def of_perm(p):
    """``of_perm``: the key a chunk's image position p holds."""
    return 16 * ((p & 7) >> 1) + 2 * (p >> 3) + (p & 1)


def of_bias_order(heads: int, nq: int, nk: int) -> np.ndarray:
    """``of_bias_kernel``'s output as indices into the flat (heads, nq, nk)
    bias, in its order (group ((h QT + r) KT + c) 1024 + 128 nt + wt of
    four: rows q, q + 8, image positions p, p + 1); -1 where it writes 0 (a
    query past nq), -2 where it writes -inf (a key past nk)."""
    qt, kt = -(-nq // TOK), -(-nk // TOK)
    gi = np.arange(heads * qt * kt * 1024, dtype=np.int64)
    wt, nt, c = gi % 128, gi // 128 % 8, gi // 1024 % kt
    r, h = gi // (1024 * kt) % qt, gi // (1024 * kt * qt)
    q = TOK * r + 16 * (wt >> 5) + ((wt & 31) >> 2)
    key = TOK * c + of_perm(8 * nt + 2 * (wt & 3))
    out = np.empty((gi.size, 4), dtype=np.int64)
    for k in range(4):
        qq, kk = q + 8 * (k >> 1), key + (k & 1)
        out[:, k] = np.where(kk >= nk, -2, np.where(qq >= nq, -1, (h * nq + qq) * nk + kk))
    return out.reshape(-1)


def partition(units: int, qt: int, kt: int) -> list:
    """Per block, in launch order: (unit, its query tile, the (unit, tile,
    chunk) score tiles it forms in order)."""
    return [(u, r, [(u, r, c) for c in range(kt)]) for u in range(units) for r in range(qt)]
