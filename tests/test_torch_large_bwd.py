"""The attention core's backward above window 16 (``csrc/lb_core.cuh``: B9's
large family and B13's) as the CPU can see it: the block partition of its
passes, held to its rules (each score tile formed twice, every sum with
one owner and a fixed order), the scratch it sizes against the source's
constants, and the routes on meta tensors through a stand-in library.
The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import collections
import re
from pathlib import Path

import pytest
import torch

from studiosr_tpu_torch.ops.cuda import attn_bwd as attn_module
from studiosr_tpu_torch.ops.cuda import engagement, large_bwd
from studiosr_tpu_torch.ops.cuda import oca_core as oca_module
from studiosr_tpu_torch.ops.cuda._launch import STREAM

CORE = Path(__file__).resolve().parents[1] / "studiosr_tpu_torch" / "csrc" / "lb_core.cuh"

# (label, partition): the HAT window-24 step (288 windows of 6 heads; B9 576
# x 576, B13 576 x 1296), MaxSR's step at a 289² crop (289 windows of 4
# heads, 289 tokens in 5 tiles), window 33 (1089 tokens, 18 tiles: two query
# parts), HAT's window-32 OCA geometry (1024 x 2304: two parts), a ragged
# B13 (100 queries, 700 keys, head dim 12: two tiles, 11 chunks at DP 16),
# and B13 at HAT's window 64 (4096 x 9216 on 3 windows: one window's dq
# partials pass the cap, so a batch is one window and its eight parts go in
# two runs)
CASES = [
    ("b9 hat step ws24", lambda: attn_module.large_partition(288, 180, 6, 24)),
    ("b13 hat step ws24", lambda: oca_module.large_partition(288, 6, 576, 1296, 30)),
    ("b9 maxsr 289", lambda: attn_module.large_partition(289, 128, 4, 17)),
    ("b9 window 33", lambda: attn_module.large_partition(12, 128, 4, 33)),
    ("b13 hat ws32", lambda: oca_module.large_partition(8, 6, 1024, 2304, 30)),
    ("b13 ragged", lambda: oca_module.large_partition(5, 3, 100, 700, 12)),
    ("b13 hat ws64", lambda: oca_module.large_partition(3, 6, 4096, 9216, 30)),
]


@pytest.mark.parametrize("label,make", CASES, ids=[c[0] for c in CASES])
def test_each_tile_is_formed_twice_and_every_sum_has_one_owner(label, make):
    part = make()
    p = part["plan"]
    tiles = {(w, h, r, c) for w in range(p.windows) for h in range(p.heads) for r in range(p.qt) for c in range(p.kt)}
    # formation 1: each tile once, a block's chunks in order
    formed1 = collections.Counter(t for block in part["stats"] for t in block)
    assert set(formed1) == tiles and set(formed1.values()) == {1}
    for block in part["stats"]:
        assert [t[3] for t in block] == sorted(t[3] for t in block)
    # formation 2: each tile once; a block's windows in order, all in its batch
    formed2 = collections.Counter(t for _, work in part["main"] for t in work)
    assert set(formed2) == tiles and set(formed2.values()) == {1}
    assert all(formed1[t] + formed2[t] == 2 for t in tiles)
    for (b, g, h, pp, c), work in part["main"]:
        ws = [t[0] for t in work]
        assert ws == sorted(ws) and all(b * p.wb <= w < (b + 1) * p.wb for w in ws)
        assert all(t[1] == h and t[3] == c and pp * p.qmax <= t[2] < (pp + 1) * p.qmax for t in work)
    # each batch's runs of parts cover the parts once, in order
    assert all([pp for p0, p1 in runs for pp in range(p0, p1)] == list(range(p.parts)) for runs in part["runs"])
    # dq: each row's chunks, in chunk order
    assert set(part["dq"]) == {(w, h, r) for w, h, r, _ in tiles}
    assert all(chunks == list(range(p.kt)) for chunks in part["dq"].values())
    # dk / dv: one (batch, group) block set, its parts in order
    assert set(part["dkdv"]) == {(w, h, c) for w, h, _, c in tiles}
    for owners in part["dkdv"].values():
        assert [o[2] for o in owners] == list(range(p.parts)) and len({o[:2] for o in owners}) == 1
    # d bias: one slab a group, whatever the batches, summed in group order;
    # each slab takes its windows in order, each window once
    assert set(part["dbias"]) == {(h, r, c) for _, h, r, c in tiles}
    for slabs in part["dbias"].values():
        assert [g for g, _ in slabs] == list(range(p.groups))
        for _, ws in slabs:
            assert ws == sorted(ws)
        assert sorted(w for _, ws in slabs for w in ws) == list(range(p.windows))
    assert p.parts == -(-p.qt // p.qmax)
    assert (p.parts > 1) == (label in ("b9 window 33", "b13 hat ws32", "b13 hat ws64"))
    assert (p.pb < p.parts) == (label == "b13 hat ws64")


def test_plan_follows_the_source():
    """The mirror's constants are the source's, the slab and the rest fit a
    block's shared memory, and the HAT window-24 step's scratch is the
    formula's: statistics, a batch's dq partials, the slabs."""
    src = CORE.read_text()
    assert int(re.search(r"LB_SMEM = (\d+);", src).group(1)) == large_bwd.SMEM
    assert int(re.search(r"LB_DQP_FLOATS = (\d+)LL << (\d+);", src).group(1)) << 20 == large_bwd.DQP_FLOATS
    assert int(re.search(r"LB_MAX_GROUPS = (\d+);", src).group(1)) == large_bwd.MAX_GROUPS
    assert (large_bwd.qmax(32), large_bwd.qmax(16)) == (9, 10)
    for dp in (16, 32):
        q = large_bwd.qmax(dp)
        rest = large_bwd.main_rest(dp)
        assert q * 64 * 64 * 4 + rest <= large_bwd.SMEM < (q + 1) * 64 * 64 * 4 + rest
    b13 = large_bwd.plan(288, 6, 9, 21, 32)
    assert (b13.parts, b13.batches, b13.wb, b13.groups) == (1, 11, 27, 1)
    assert b13.f_elems == 288 * 6 * 9 * 64 * 3 + 27 * 6 * 9 * 21 * 64 * 32 + 1 * 6 * 576 * 1344
    assert oca_module.large_scratch(288, 6, 576, 1296, 30) == (288 * 6 * (2 * 9 + 2 * 21) * 64 * 32,
                                                               b13.f_elems + 6 * 9 * 21 * 64 * 64)
    b9 = attn_module.large_plan(288, 180, 6, 24)
    assert (b9.parts, b9.batches, b9.wb, b9.groups) == (1, 5, 58, 7)
    assert b9.f_elems == 288 * 6 * 9 * 64 * 3 + 58 * 6 * 81 * 64 * 32 + 7 * 6 * 576 * 576
    # a batch's dq partials stay within the cap (one part's where a window's pass it), and
    # the scratch past the statistics within a small multiple of d bias's heads x nq x nk
    # floats at every size: the slabs (one a group) do not grow with the batches
    for p in (b9, b13, large_bwd.plan(289, 4, 5, 5, 32), large_bwd.plan(12, 4, 18, 18, 32)):
        assert p.dqp_elems <= large_bwd.DQP_FLOATS and p.pb == p.parts
        assert p.groups * 8 <= max(8, p.wb) and p.batches * p.wb >= p.windows > (p.batches - 1) * p.wb


# Large geometries at batch 32 (HAT's windows 48 and 64: 96² and 128² crops,
# 128 windows; B9 nq = nk, B13 nk = (1.5 ws)²) and MaxSR adaptive on a 2048²
# map (windows of 46² tokens, 2116 windows, 4 heads): (windows, heads, QT,
# KT, batches, parts, part runs)
LARGE_PLANS = [("b9 hat ws48", 128, 6, 36, 36, 32, 4, 1), ("b13 hat ws48", 128, 6, 36, 81, 128, 4, 1),
               ("b9 hat ws64", 128, 6, 64, 64, 128, 8, 1), ("b13 hat ws64", 128, 6, 64, 144, 128, 8, 2),
               ("b9 maxsr 2048", 2116, 4, 34, 34, 303, 4, 1)]


@pytest.mark.parametrize("label,windows,heads,qt,kt,batches,parts,runs", LARGE_PLANS,
                         ids=[c[0] for c in LARGE_PLANS])
def test_scratch_stays_near_d_bias_at_large_geometries(label, windows, heads, qt, kt, batches, parts, runs):
    p = large_bwd.plan(windows, heads, qt, kt, 32)
    assert (p.batches, p.parts, -(-p.parts // p.pb)) == (batches, parts, runs)
    dbias = heads * qt * 64 * kt * 64  # floats of d bias, padded to whole tiles
    assert p.dbp_elems == p.groups * dbias and p.groups == 1
    assert p.dqp_elems <= max(large_bwd.DQP_FLOATS, heads * p.qmax * kt * 64 * 32)
    assert p.f_elems - p.stats_elems <= 2 * large_bwd.DQP_FLOATS + 2 * dbias
    assert p.stats_elems == windows * heads * qt * 64 * 3


class _FakeLibrary:
    """Stands in for the built kernel libraries: records the C entries a
    wrapper calls, answers the scratch entries with the mirrors' sizes and the
    packed layout's size as the built library does; every launch returns 0."""

    def __init__(self):
        self.calls = []

    def attn_bwd_mma_pack_elems(self, c, heads):
        return attn_module._pack_index(c, heads).size

    def oca_core_bwd_large_mma_scratch(self, bw, heads, nq, nk, d, t_elems, f_elems):
        self.calls.append(("oca_core_bwd_large_mma_scratch", (bw, heads, nq, nk, d)))
        t_elems._obj.value, f_elems._obj.value = oca_module.large_scratch(bw, heads, nq, nk, d)
        return 0

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


def _meta_call(device, entry, *args):
    return entry(*(0 if a is STREAM else a for a in args))


# (window, C, heads, map batch and side, entry, counter): the HAT window-24
# step, MaxSR's 289² step, window 33, and windows 16 and 8 unchanged
B9_ROUTES = [(24, 180, 6, 32, 72, "attn_bwd_large_mma_bf16", "attention_bwd_large"),
             (17, 128, 4, 1, 289, "attn_bwd_large_mma_bf16", "attention_bwd_large"),
             (33, 128, 4, 2, 66, "attn_bwd_large_mma_bf16", "attention_bwd_large"),
             (16, 180, 6, 32, 64, "attn_bwd16_mma_bf16", "attention_bwd_ws16"),
             (8, 180, 6, 32, 64, "attn_bwd_mma_bf16", "attention_bwd")]


@pytest.mark.parametrize("ws,c,heads,batch,side,entry,name", B9_ROUTES)
def test_attention_bwd_large_routes_keep_their_entry_and_counter(monkeypatch, ws, c, heads, batch, side, entry, name):
    from studiosr_tpu_torch.ops.cuda import _build

    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda name, signatures, restypes=None: lib)
    monkeypatch.setattr(attn_module, "call", _meta_call)
    n, f32, bf = ws * ws, torch.float32, torch.bfloat16
    meta = lambda *s, dt=bf: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    engagement.reset()
    x = meta(batch, side, side, c)
    grads = attn_module.attention_bwd(x, x, meta(c, dt=f32), meta(c, dt=f32), meta(c, 3 * c), meta(3 * c, dt=f32),
                                      meta(c, c), meta(c, dt=f32), meta(heads, n, n), heads=heads, window_size=ws,
                                      shift=ws // 2, drop_path=meta(batch, dt=f32))
    assert tuple(grads[-1].shape) == (heads, n, n) and grads[0].dtype == bf
    assert [k for k, _ in lib.calls if not k.endswith("_scratch")] == [entry]
    assert engagement.counters() == {name: 1} and engagement.entries() == {name: {entry: 1}}
    engagement.reset()


# (bw, nq, nk, entry, counter): the HAT window-24 step's and window 32's OCA
# geometries, a ragged one, and window 16's (the small family) unchanged
B13_ROUTES = [(288, 576, 1296, "oca_core_bwd_large_mma_bf16", "oca_core_bwd_large"),
              (8, 1024, 2304, "oca_core_bwd_large_mma_bf16", "oca_core_bwd_large"),
              (5, 100, 700, "oca_core_bwd_large_mma_bf16", "oca_core_bwd_large"),
              (512, 256, 576, "oca_core_bwd_mma_bf16", "oca_core_bwd")]


@pytest.mark.parametrize("bw,nq,nk,entry,name", B13_ROUTES)
def test_oca_core_bwd_large_routes_keep_their_entry_and_counter(monkeypatch, bw, nq, nk, entry, name):
    from studiosr_tpu_torch.ops.cuda import _build

    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda name, signatures, restypes=None: lib)
    monkeypatch.setattr(oca_module, "call", _meta_call)
    heads, d, bf = 6, 30, torch.bfloat16
    meta = lambda *s, dt=bf: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    q, k = meta(bw, nq, heads, d).transpose(1, 2), meta(bw, nk, heads, d).transpose(1, 2)
    engagement.reset()
    dq, dk, dv, dbias = oca_module.oca_core_bwd(q, k, k, meta(heads, nq, nk, dt=torch.float32), q)
    assert (tuple(dq.shape), tuple(dk.shape), tuple(dbias.shape)) == ((bw, heads, nq, d), (bw, heads, nk, d),
                                                                       (heads, nq, nk))
    assert [k for k, _ in lib.calls if not k.endswith("_scratch")] == [entry]
    assert engagement.counters() == {name: 1} and engagement.entries() == {name: {entry: 1}}
    if name.endswith("_large"):
        assert ("oca_core_bwd_large_mma_scratch", (bw, heads, nq, nk, d)) in lib.calls
    engagement.reset()
