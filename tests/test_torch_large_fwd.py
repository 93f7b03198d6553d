"""The attention core's forward above window 16 (``csrc/lf_core.cuh``: B5's
large family, B12's large entry, B10's attention pass above 576 keys) as the
CPU can see it: the block partition, held to its rules (each score tile
formed once, every output row one owner, the key chunks in ascending
order), the shared memory it sizes against the source's constants, the
kernels it replaced gone, and the routes on meta tensors through a stand-in
library. The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import collections
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from studiosr_tpu_torch.ops.cuda import engagement, large_fwd
from studiosr_tpu_torch.ops.cuda import oca_core as oca_module
from studiosr_tpu_torch.ops.cuda import ocab as ocab_module
from studiosr_tpu_torch.ops.cuda import window_attention as wa_module
from studiosr_tpu_torch.ops.cuda._launch import STREAM

CSRC = Path(__file__).resolve().parents[1] / "studiosr_tpu_torch" / "csrc"

# (label, units, query tiles, key chunks, DP, bias tile bytes): B5 at the HAT
# window-24 step (288 windows of 6 heads, 576 tokens, the bias in bf16), at
# SwinIR x4 serving at window 24 (121 windows of a 264² map, the f32 bias of
# the blob), at MaxSR's 289² step (289 windows of 4 heads, 289 tokens in 5
# tiles), at window 33 (1089 tokens, 18 tiles, an f32 bias) and at window 256
# (1024 tiles); B12 at the window-24 step's OCA geometry (576 x 1296), at
# window 32's (1024 x 2304) and ragged (100 x 700, d 12: DP 16) with either
# bias; B10 at HAT x4 serving at window 24
CASES = [
    ("b5 hat step ws24", 288 * 6, 9, 9, 32, large_fwd.bias_tile(True)),
    ("b5 swinir serving ws24", 121 * 6, 9, 9, 32, large_fwd.bias_tile(False)),
    ("b5 maxsr 289", 289 * 4, 5, 5, 32, large_fwd.bias_tile(True)),
    ("b5 window 33", 12 * 4, 18, 18, 32, large_fwd.bias_tile(False)),
    ("b5 window 256", 1, 1024, 1024, 32, large_fwd.bias_tile(False)),
    ("b12 hat step ws24", 288 * 6, 9, 21, 32, large_fwd.bias_tile(True)),
    ("b12 hat ws32", 8 * 6, 16, 36, 32, large_fwd.bias_tile(True)),
    ("b12 ragged f32", 5 * 3, 2, 11, 16, large_fwd.bias_tile(False)),
    ("b12 ragged bf16", 5 * 3, 2, 11, 16, large_fwd.bias_tile(True)),
    ("b10 hat serving ws24", 121 * 6, 9, 21, 32, large_fwd.bias_tile(True)),
]


@pytest.mark.parametrize("label,units,qt,kt,dp,bias_tile", CASES, ids=[c[0] for c in CASES])
def test_each_tile_is_formed_once_and_every_row_has_one_owner(label, units, qt, kt, dp, bias_tile):
    blocks = large_fwd.partition(units, qt, kt)
    assert len(blocks) == units * qt
    formed = collections.Counter(t for _, _, chunks in blocks for t in chunks)
    assert set(formed) == {(u, r, c) for u in range(units) for r in range(qt) for c in range(kt)}
    assert set(formed.values()) == {1}
    owners = collections.Counter((u, r) for u, r, _ in blocks)
    assert set(owners) == {(u, r) for u in range(units) for r in range(qt)} and set(owners.values()) == {1}
    for u, r, chunks in blocks:  # a block's chunks ascending
        assert chunks == [(u, r, c) for c in range(kt)]
    # a unit's blocks are neighbours, so its k and v serve them from L2
    assert [u for u, _, _ in blocks] == sorted(u for u, _, _ in blocks)


@pytest.mark.parametrize("label,units,qt,kt,dp,bias_tile", CASES, ids=[c[0] for c in CASES])
def test_shared_memory_follows_the_source_and_fits(label, units, qt, kt, dp, bias_tile):
    """The mirror's constants are the source's; every geometry's block takes
    at least the two stages the warpgroup holds at once and fits its share
    of the SM (four blocks an SM)."""
    core = (CSRC / "lf_core.cuh").read_text()
    assert int(re.search(r"LF_BLOCKS = (\d+);", core).group(1)) == large_fwd.BLOCKS
    assert "LF_SMEM = 233472 / LF_BLOCKS - 1024;" in core and "__launch_bounds__(128, LF_BLOCKS)" in core
    assert tuple(map(int, re.search(r"LF_MIN_STAGES = (\d+), LF_MAX_STAGES = (\d+);", core).groups())) == (
        large_fwd.MIN_STAGES, large_fwd.MAX_STAGES)
    assert int(re.search(r"LF_TAGS = (\d+);", core).group(1)) == large_fwd.TAGS
    assert "lf_bias_tile(bool b16) { return (b16 ? 8 : 16) * 8 * 128; }" in core
    lay = large_fwd.layout(dp, bias_tile)
    assert large_fwd.MIN_STAGES <= lay.stages <= large_fwd.MAX_STAGES
    assert lay.bytes <= large_fwd.SMEM and lay.stage_bytes % 128 == 0
    assert lay.bytes == lay.q_bytes + lay.stages * lay.stage_bytes + (large_fwd.MAX_STAGES + 1) * 8
    if lay.stages < large_fwd.MAX_STAGES:  # one stage more would not fit
        assert lay.bytes + lay.stage_bytes > large_fwd.SMEM
    assert large_fwd.BLOCKS * (lay.bytes + 1024) <= 233472
    expected = {"b5 hat step ws24": 3, "b5 swinir serving ws24": 2, "b12 hat step ws24": 3, "b10 hat serving ws24": 3,
                "b12 ragged f32": 2, "b5 maxsr 289": 3, "b5 window 33": 2}
    assert lay.stages == expected.get(label, lay.stages)


def test_the_streaming_forward_kernels_it_replaced_are_gone():
    """wa_attn_large_kernel and of_fwd_ring_kernel have no definition or
    launch left, and the three callers launch lf_core.cuh's kernel."""
    sources = {p.name: p.read_text() for p in CSRC.glob("*.cu*")}
    for name in ("wa_attn_large_kernel", "of_fwd_ring_kernel"):
        assert not any(re.search(rf"__global__[^;{{]*\b{name}\b|\b{name}\s*<", t) for t in sources.values()), name
    assert "return lf_launch<DP>(f, a.bias16, stream);" in sources["window_attention_mma.cu"]
    assert "return lf_launch<DP>(LfOf<DP>{a, a.QT, a.KT, a.heads, a.units, a.bfrag}" in sources["of_attn.cuh"]
    assert "of_attn_launch<DP, BT>(a, st, large)" in sources["oca_fwd_mma.cu"]
    assert '#include "of_attn.cuh"' in sources["ocab_mma.cu"] and "of_attn_launch<DP, bf16>(o, st)" in sources[
        "ocab_mma.cu"]


# B12 / B10's bias orders for lf_core.cuh: the HAT window-24 OCA geometry's
# shape on one head, ragged (100 x 700), B10's padded window 20 (400 queries
# in 7 tiles, 900 keys) and window 17 at overlap 0.5 with 3 heads
OF_BIAS_CASES = [(1, 576, 1296), (2, 100, 700), (2, 400, 900), (3, 289, 676)]


@pytest.mark.parametrize("heads,nq,nk", OF_BIAS_CASES)
def test_of_bias_order_gives_each_thread_the_scores_keys(heads, nq, nk):
    """Each element of of_bias_kernel's order, built element by element, is
    the bias the attention pass reads for that score: thread wt of query tile
    r, chunk c, column (nt, e) of rows q and q + 8 scores key 64 c + 16 (wt %
    4) + 2 nt + e (of_perm's order, as of_fwd_kernel reads its 16 keys); 0
    past nq, -inf past nk; and the mirror's of_perm is the source's."""
    src = (CSRC / "of_attn.cuh").read_text()
    assert "return 16 * ((p & 7) >> 1) + 2 * (p >> 3) + (p & 1);" in src
    order = large_fwd.of_bias_order(heads, nq, nk).reshape(-1, 4)
    qt, kt = -(-nq // 64), -(-nk // 64)
    assert order.shape[0] == heads * qt * kt * 1024
    bias = np.arange(heads * nq * nk, dtype=np.int64).reshape(heads, nq, nk)
    seen = np.zeros(heads * nq * nk, dtype=np.int64)
    for gi in range(0, order.shape[0], 97):  # a sample of every (h, r, c, nt, wt) stride
        wt, nt, c = gi % 128, gi // 128 % 8, gi // 1024 % kt
        r, h = gi // (1024 * kt) % qt, gi // (1024 * kt * qt)
        for k in range(4):
            q, key = 64 * r + 16 * (wt >> 5) + ((wt & 31) >> 2) + 8 * (k >> 1), 64 * c + 16 * (wt & 3) + 2 * nt + (k & 1)
            want = -2 if key >= nk else -1 if q >= nq else bias[h, q, key]
            assert order[gi, k] == want
    valid = order[order >= 0]
    np.add.at(seen, valid, 1)
    assert set(np.unique(seen)) == {1}  # every real (query, key) once
    assert (order == -2).sum() == heads * qt * 64 * (kt * 64 - nk)


class _FakeLibrary:
    """Stands in for the built kernel libraries: records the C entries a
    wrapper calls and answers the packed layouts' sizes as the built library
    does; every launch returns 0 (and computes nothing)."""

    def __init__(self):
        self.calls = []

    def window_attention_mma_pack_elems(self, c, heads):
        return wa_module._fwd_pack_index(c, heads).size

    def ocab_mma_pack_elems(self, c, heads, hidden):
        return ocab_module.packed_ocab_elems(c, heads, hidden)

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


def _meta_call(device, entry, *args):
    return entry(*(0 if a is STREAM else a for a in args))


def _stand_in(monkeypatch):
    from studiosr_tpu_torch.ops.cuda import _build

    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda name, signatures, restypes=None: lib)
    for module in (wa_module, oca_module, ocab_module):
        monkeypatch.setattr(module, "call", _meta_call)
    return lib


def _meta(*shape, dt=torch.bfloat16):
    return torch.empty(*shape, dtype=dt, device="meta")


# (window, C, heads, map batch and side, shift, served): the HAT window-24
# step, SwinIR x4 serving at window 24 on the blob, MaxSR's 289² step, window
# 33, and window 16 (the 9-16 family) unchanged
B5_ROUTES = [(24, 180, 6, 32, 72, 12, False, "window_attention_large_mma_bf16", "fused_window_attention_block_large"),
             (24, 180, 6, 1, 264, 12, True, "window_attention_large_mma_bf16", "fused_window_attention_block_large"),
             (17, 128, 4, 1, 289, 0, False, "window_attention_large_mma_bf16", "fused_window_attention_block_large"),
             (33, 128, 4, 2, 66, 16, False, "window_attention_large_mma_bf16", "fused_window_attention_block_large"),
             (16, 180, 6, 32, 64, 8, False, "window_attention16_mma_bf16", "fused_window_attention_block_ws16")]


@pytest.mark.parametrize("ws,c,heads,batch,side,shift,served,entry,name", B5_ROUTES)
def test_b5_large_routes_keep_their_entry_and_counter(monkeypatch, ws, c, heads, batch, side, shift, served, entry,
                                                      name):
    lib = _stand_in(monkeypatch)
    f32, n = torch.float32, ws * ws
    npad = wa_module.padded_tokens(ws)
    vec = [_meta(c, dt=f32), _meta(c, dt=f32)]
    if served:  # the blob: the weights, then the f32 bias in fragment order
        blob = _meta(wa_module._fwd_pack_index(c, heads).size + 2 * heads * npad * npad)
        ops = [*vec, blob, _meta(3 * c, dt=f32), None, _meta(c, dt=f32), None]
    else:
        ops = [*vec, _meta(c, 3 * c), _meta(3 * c, dt=f32), _meta(c, c), _meta(c, dt=f32), _meta(heads, n, n)]
    engagement.reset()
    out = wa_module.fused_window_attention_block(_meta(batch, side, side, c), *ops, heads=heads, window_size=ws,
                                                 shift=shift, drop_path=None if served else _meta(batch, dt=f32))
    assert tuple(out.shape) == (batch, side, side, c) and out.dtype == torch.bfloat16
    assert [k for k, _ in lib.calls if not k.endswith("_scratch")] == [entry]
    assert engagement.counters() == {name: 1} and engagement.entries() == {name: {entry: 1}}
    engagement.reset()


# (bw, nq, nk, d, bias dtype, entry, counter): the HAT window-24 step's and
# window 32's OCA geometries, ragged ones in either bias dtype, and window
# 16's (the whole-unit entry) unchanged
B12_ROUTES = [(288, 576, 1296, 30, torch.bfloat16, "oca_core_fwd_large_mma_bf16", "oca_core_fwd_large"),
              (8, 1024, 2304, 30, torch.bfloat16, "oca_core_fwd_large_mma_bf16", "oca_core_fwd_large"),
              (5, 100, 700, 12, torch.float32, "oca_core_fwd_large_mma_bf16", "oca_core_fwd_large"),
              (5, 100, 700, 12, torch.bfloat16, "oca_core_fwd_large_mma_bf16", "oca_core_fwd_large"),
              (512, 256, 576, 30, torch.bfloat16, "oca_core_fwd_mma_bf16", "oca_core_fwd")]


@pytest.mark.parametrize("bw,nq,nk,d,bdt,entry,name", B12_ROUTES)
def test_oca_core_fwd_large_routes_keep_their_entry_and_counter(monkeypatch, bw, nq, nk, d, bdt, entry, name):
    lib = _stand_in(monkeypatch)
    heads = 6 if d == 30 else 3
    q, k = _meta(bw, nq, heads, d).transpose(1, 2), _meta(bw, nk, heads, d).transpose(1, 2)
    engagement.reset()
    out = oca_module.oca_core_fwd(q, k, k, _meta(heads, nq, nk, dt=bdt))
    assert tuple(out.shape) == (bw, heads, nq, d)
    launches = [(k_, a) for k_, a in lib.calls if not k_.endswith("_scratch")]
    assert [k_ for k_, _ in launches] == [entry]
    assert launches[0][1][6] == int(bdt == torch.bfloat16)  # the bias is read in the dtype it came in
    sizing = [a for k_, a in lib.calls if k_.endswith("_scratch")]
    # the large entry's scratch holds the bias in fragment order, sized for its dtype
    assert [len(a) for a in sizing] == [7 if name.endswith("_large") else 6]
    if name.endswith("_large"):
        assert sizing[0][5] == int(bdt == torch.bfloat16)
    assert engagement.counters() == {name: 1} and engagement.entries() == {name: {entry: 1}}
    engagement.reset()


@pytest.mark.parametrize("ws", [24, 20, 32])
def test_ocab_above_576_keys_keeps_its_entry_and_counter(monkeypatch, ws):
    """B10 at HAT x4's widths above 576 keys (window 24: 1296 keys; 20: 900,
    rows that take no 16-byte copies; 32: 2304), on the serving blob: one
    launch of ``ocab_mma_bf16`` under ``fused_ocab_block``."""
    lib = _stand_in(monkeypatch)
    c, heads, hidden, f32 = 180, 6, 360, torch.float32
    owin = ws + ws // 2
    blob = _meta(ocab_module.packed_ocab_elems(c, heads, hidden))
    ops = [_meta(c, dt=f32), _meta(c, dt=f32), blob, _meta(3 * c, dt=f32), None, _meta(c, dt=f32),
           _meta(heads, ws * ws, owin * owin), _meta(c, dt=f32), _meta(c, dt=f32), None, _meta(hidden, dt=f32), None,
           _meta(c, dt=f32)]
    engagement.reset()
    out = ocab_module.fused_ocab_block(_meta(1, 2 * ws, 2 * ws, c), *ops, heads=heads, window_size=ws,
                                       overlap_ratio=0.5)
    assert tuple(out.shape) == (1, 2 * ws, 2 * ws, c)
    assert [k for k, _ in lib.calls if not k.endswith(("_scratch", "_elems"))] == ["ocab_mma_bf16"]
    assert engagement.entries() == {"fused_ocab_block": {"ocab_mma_bf16": 1}}
    engagement.reset()
