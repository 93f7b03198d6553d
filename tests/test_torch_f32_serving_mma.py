"""B1 and the 3x3 conv's f32 routes written for the H100 (``csrc/swin_block_f32.cu``,
``csrc/conv3x3_f32.cuh`` on ``csrc/tf32x3.cuh``), on the CPU: the packed
layouts built element by element from dense weights against a numpy
reference (hi = TF32 rounding to nearest, ties away; lo = TF32 of the
residual); ``prepare_serving`` laying them out once in f32; the wrappers'
routing (launches on meta tensors through a fake library); the plain
versions with every product in 3xTF32 (``ops/cuda/tf32x3.py``, the kernels'
arithmetic) against f32 and f64; and the port's f32 fused SwinIR forward
against the JAX package's (Pallas in interpret mode).

Inputs come from numpy seeds and go to both packages. Tolerances: 3xTF32
against f32, the f32 kernels' rule on the card (max |k - p| <= 1e-4 max |p|
+ 1e-5); the forward against the JAX package, the port's SwinIR parity
tests' f32 tolerance (atol 5e-5, rtol 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.models.swinir import SwinIR as JaxSwinIR
from studiosr_tpu.serving import prepare_serving as jax_prepare_serving
from studiosr_tpu.serving import swinir_fast_forward as jax_swinir_fast_forward
from studiosr_tpu_torch import SwinFIR, SwinIR
from studiosr_tpu_torch.ops.cuda import engagement, tf32x3
from studiosr_tpu_torch.ops.cuda._launch import STREAM
from studiosr_tpu_torch.ops.cuda.conv3x3 import (
    conv3x3_plain, f32_mma_takes as conv_f32_takes, fused_cab_body, fused_conv3x3, fused_resblock,
    pack_conv3x3_f32_weights, packed_conv3x3_f32_shape, prepare_conv3x3_weights, prepare_fused_conv3x3_weights,
    unpack_conv3x3_f32_weights,
)
from studiosr_tpu_torch.ops.cuda.swin_block import (
    _f32_elements, f32_mma_takes as b1_f32_takes, fused_swin_block, pack_swin_block, pack_swin_f32,
    pack_swin_weights, swin_block_plain, swin_f32_stages, swin_pack_stages, unpack_swin_f32,
)
from studiosr_tpu_torch.ops.cuda.upsampler import fused_upsample_s, fused_upsample_x4, pack_tail
from studiosr_tpu_torch.serving import prepare_serving, swinir_fast_forward
from studiosr_tpu_torch.zoo import load_jax_params

torch.set_num_threads(2)

ATOL, RTOL = 5e-5, 1e-4  # f32 forwards against the JAX package, as tests/test_torch_swinir.py
PERM8 = [0, 2, 4, 6, 1, 3, 5, 7]  # a packed 8-row group's row i holds unit PERM8[i]


def np_tf32(a: np.ndarray) -> np.ndarray:
    """TF32 rounding of f32 values, to nearest with ties away from zero (cvt.rna):
    the magnitude's 13 low bits rounded off."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def image_pos(k, n):
    """Where element (k, n) of a 32 x 96 stage lies in its image (tfw_image)."""
    return (n // 8) * 256 + (k // 4) * 32 + (n % 8) * 4 + k % 4


def _check_planes(hi: np.ndarray, lo: np.ndarray, want: np.ndarray) -> None:
    """hi is tf32(want), lo is tf32(want - hi), bit for bit."""
    want_hi = np_tf32(want)
    np.testing.assert_array_equal(hi.view(np.uint32), want_hi.view(np.uint32))
    np.testing.assert_array_equal(lo.view(np.uint32), np_tf32(want - want_hi).view(np.uint32))


# -- the packed layouts, element by element ------------------------------------------------


@pytest.mark.parametrize("cin,cout", [(180, 180), (64, 256), (64, 576), (20, 40), (7, 33)])
def test_f32_conv_packed_layout_follows_its_rule_element_by_element(cin, cout):
    """Image (N tile j, chunk c, tap) of the packed weights holds, at
    tfw_image(k, n), w[tap, 32 c + k, 96 j + n] (zero past Cin and Cout):
    its hi plane tf32(w), its lo plane tf32(w - hi); unpacking gives hi + lo."""
    rng = np.random.default_rng(cin + cout)
    w = rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
    packed = pack_conv3x3_f32_weights(torch.from_numpy(w)).numpy()
    nt, nch = -(-cout // 96), -(-cin // 32)
    assert packed.shape == packed_conv3x3_f32_shape(cin, cout) == (nt, nch, 9, 2, 3072)
    full = np.zeros((9, nch * 32, nt * 96), np.float32)
    full[:, :cin, :cout] = w.reshape(9, cin, cout)
    k, n = np.meshgrid(np.arange(32), np.arange(96), indexing="ij")
    pos = image_pos(k, n)
    for j in range(nt):
        for c in range(nch):
            for tap in range(9):
                want = np.zeros(3072, np.float32)
                want[pos] = full[tap, 32 * c + k, 96 * j + n]
                _check_planes(packed[j, c, tap, 0], packed[j, c, tap, 1], want)
    back = unpack_conv3x3_f32_weights(torch.from_numpy(packed), cin, cout).numpy()
    np.testing.assert_array_equal(back, np_tf32(w) + np_tf32(w - np_tf32(w)))


def _b1_dense(c, heads, hidden, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(c, 3 * c), f(c, c), f(heads, 64, 64), f(c, hidden), f(hidden, c)


@pytest.mark.parametrize("c,heads,hidden", [(180, 6, 360), (32, 2, 64), (60, 6, 120), (24, 2, 37)])
def test_b1_f32_packed_blob_follows_its_rule_element_by_element(c, heads, hidden):
    """Stage by stage (per head: q|k|v by 32 LN channels, proj by output
    tile; per 96 hidden units: fc1 by 32 LN channels, fc2 by 32 units and
    output tile) each 32 x 96 block's hi and lo images, proj's and fc2's
    rows permuted inside each 8-row group, then each head's bias in
    score-fragment order; unpacking gives the weights back as hi + lo."""
    wqkv, wproj, bias, w1, w2 = _b1_dense(c, heads, hidden, c + hidden)
    packed = pack_swin_f32(*map(torch.from_numpy, (wqkv, wproj, bias, w1, w2)), heads).numpy()
    assert packed.size == _f32_elements(c, heads, hidden)
    d = c // heads
    k, n = np.meshgrid(np.arange(32), np.arange(96), indexing="ij")
    unit = (k // 8) * 8 + np.array(PERM8)[k % 8]

    def at(m, rows, cols):
        ok = (rows < m.shape[0]) & (cols < m.shape[1])
        return np.where(ok, m[np.minimum(rows, m.shape[0] - 1), np.minimum(cols, m.shape[1] - 1)], 0)

    stages = swin_f32_stages(c, heads, hidden)
    for s, (kind, i, ks, t) in enumerate(stages):
        if kind == "qkv":
            part, j = n // 32, n % 32
            block = np.where(j < d, at(wqkv, 32 * ks + k, part * c + i * d + np.minimum(j, d - 1)), 0)
        elif kind == "proj":
            block = np.where(unit < d, at(wproj, i * d + np.minimum(unit, d - 1), 96 * t + n), 0)
        elif kind == "fc1":
            block = at(w1, 32 * ks + k, 96 * i + n)
        else:
            block = at(w2, 96 * i + 32 * ks + unit, 96 * t + n)
        want = np.zeros(3072, np.float32)
        want[image_pos(k, n)] = block
        _check_planes(packed[6144 * s:6144 * s + 3072], packed[6144 * s + 3072:6144 * (s + 1)], want)
    frags = packed[6144 * len(stages):].reshape(heads, 4, 8, 8, 4, 4)  # head, row tile, key tile, g, t, e
    h_, wr, nt, g, t, e = np.meshgrid(*map(np.arange, frags.shape), indexing="ij")
    np.testing.assert_array_equal(frags, bias[h_, 16 * wr + g + 8 * (e // 2), 8 * nt + 2 * t + e % 2])
    back = unpack_swin_f32(torch.from_numpy(packed), c, heads, hidden)
    for got, want in zip(back, (wqkv, wproj, bias, w1, w2)):
        np.testing.assert_array_equal(got.numpy(), want if want is bias else np_tf32(want) + np_tf32(
            want - np_tf32(want)))


def test_b1_f32_stage_count_is_the_kernels():
    """``swin_f32_stages`` counts what ``Sb32Geom::stages`` does: heads (KS
    + NT) + chunks (KS + 3 NT), KS = pad32(C) / 32, NT = ceil(C / 96)."""
    for c, heads, hidden in [(180, 6, 360), (32, 2, 64), (192, 6, 96), (4, 1, 1)]:
        ks, nt, chunks = -(-c // 32), -(-c // 96), -(-hidden // 96)
        assert len(swin_f32_stages(c, heads, hidden)) == heads * (ks + nt) + chunks * (ks + 3 * nt)


# -- prepare_serving in f32 ---------------------------------------------------------------

SMALL = dict(embed_dim=32, depths=[2], num_heads=[2], mlp_ratio=2.0, device="cpu")


def test_prepare_serving_f32_packs_b1_b2_and_the_tail_at_window_8():
    """f32 at window 8: each Swin block's blob is ``pack_swin_f32`` of its
    dense weights (``wproj``, ``bias``, ``w1``, ``w2`` None), the RSTB conv
    and conv_after_body the f32 conv's images, the tail's wide convs too
    (conv_last, 3 colours, stays HWIO)."""
    model = SwinIR.build(scale=4, window_size=8, **SMALL)
    prep = prepare_serving(model.module, model.config, torch.float32)
    blk = model.module.layers[0].residual_group.blocks[1]
    ops = prep["blocks"][0][1]
    assert ops["wproj"] is None and ops["bias"] is None and ops["w1"] is None and ops["w2"] is None
    dense = [blk.attn.qkv.weight.detach().t(), blk.attn.proj.weight.detach().t(), None,
             blk.mlp.fc1.weight.detach().t(), blk.mlp.fc2.weight.detach().t()]
    back = unpack_swin_f32(ops["wqkv"], 32, 2, 64)
    for i in (0, 1, 3, 4):
        want = dense[i].contiguous()
        assert torch.equal(back[i], tf32x3.split(want)[0] + tf32x3.split(want)[1])
    conv = model.module.layers[0].conv
    w, b = prep["convs"][0]
    assert torch.equal(w, pack_conv3x3_f32_weights(prepare_conv3x3_weights(conv.weight, torch.float32)))
    assert torch.equal(b, conv.bias.detach().float())
    tail = prep["tail"]
    for i, name in ((0, "0"), (2, "2")):  # the num_feat 64 -> 256 convs
        hwio = prepare_conv3x3_weights(model.module.upsample._modules[name].weight, torch.float32)
        assert torch.equal(tail[i], pack_conv3x3_f32_weights(hwio)) and tail[i].shape == packed_conv3x3_f32_shape(64, 256)
    assert torch.equal(tail[4], prepare_conv3x3_weights(model.module.conv_last.weight, torch.float32))


@pytest.mark.parametrize("window", [4, 12])
def test_prepare_serving_f32_away_from_window_8_keeps_b5_b6_dense(window):
    """Away from window 8 f32 serving lays out B5's and B6's operands as
    before: dense (in, out) weights and the gathered bias."""
    model = SwinIR.build(scale=2, window_size=window, **SMALL)
    prep = prepare_serving(model.module, model.config, torch.float32)
    ops = prep["blocks"][0][0]
    assert set(ops) == {"attn", "mlp"}
    assert ops["attn"]["wqkv"].shape == (32, 96) and ops["attn"]["bias"].shape == (2, window**2, window**2)
    assert ops["mlp"]["w1"].shape == (32, 64) and ops["mlp"]["w2"].shape == (64, 32)


def test_prepare_serving_f32_packs_swinfir_sfb_convs():
    """SwinFIR's SFB spatial-branch pair is packed for the f32 conv in f32."""
    model = SwinFIR.build(scale=4, window_size=8, **SMALL)
    prep = prepare_serving(model.module, model.config, torch.float32)
    pair = prep["convs"][0]
    body = model.module.layers[0].conv.S.body._modules
    for key, name in (("s0", "0"), ("s2", "2")):
        assert torch.equal(pair[key], prepare_fused_conv3x3_weights(body[name].weight, torch.float32))
        assert pair[key].shape == packed_conv3x3_f32_shape(32, 32)


# -- the routing ------------------------------------------------------------------------


def _meta_call(device, entry, *args):
    """``_launch.call`` for operands on the meta device: no card to make
    current, stream 0."""
    return entry(*(0 if a is STREAM else a for a in args))


class _FakeLibrary:
    """Stands in for the built kernel libraries: records the C entries a
    wrapper calls and answers the packed blobs' sizes as the built
    libraries do; every launch returns status 0."""

    def __init__(self):
        self.calls = []

    def swin_block_mma_f32_elements(self, c, heads, hidden):
        return _f32_elements(c, heads, hidden)

    def swin_block_mma_elements(self, c, heads, hidden):
        return sum(nrows * ncols + (8192 if kind == "pb" else 0)
                   for kind, _, _, nrows, ncols in swin_pack_stages(c, heads, hidden))

    def cab_body_partials(self, h, w, c):
        return 1

    def cab_body_mma_tiles(self, h, w):
        return 1

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


def _fake(monkeypatch, *modules):
    from studiosr_tpu_torch.ops.cuda import _build

    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda name, signatures, restypes=None: lib)
    for module in modules:
        monkeypatch.setattr(module, "call", _meta_call)
    engagement.reset()
    return lib


def test_prepare_serving_f32_keeps_b1_dense_where_the_3xtf32_kernel_declines():
    """At window 8 with head dim 48 (C 96, 2 heads) f32 serving keeps B1's
    weights dense (in, out) and the gathered bias, the first-design kernel's
    operands."""
    model = SwinIR.build(scale=2, window_size=8, **dict(SMALL, embed_dim=96))
    ops = prepare_serving(model.module, model.config, torch.float32)["blocks"][0][0]
    assert ops["wqkv"].shape == (96, 288) and ops["wproj"].shape == (96, 96)
    assert ops["bias"].shape == (2, 64, 64) and ops["w1"].shape == (96, 192) and ops["w2"].shape == (192, 96)


@pytest.mark.parametrize("dtype,c,heads,kind", [
    (torch.float32, 32, 2, "f32"), (torch.float32, 60, 6, "f32"), (torch.bfloat16, 32, 2, "bf16"),
    (torch.float32, 184, 8, None), (torch.float32, 96, 2, None), (torch.float32, 90, 6, None),
    (torch.bfloat16, 96, 2, None),
])
def test_pack_swin_block_packs_for_the_kernel_that_takes_the_geometry(dtype, c, heads, kind):
    """The one B1 prep helper: the blob of the kernel of the weights' dtype
    where it takes the geometry, None where it does not (dense operands)."""
    rng = np.random.default_rng(c)
    hidden = 2 * c
    w = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for shape in
         ((c, 3 * c), (c, c), (heads, 64, 64), (c, hidden), (hidden, c))]
    w = [t if i == 2 else t.to(dtype) for i, t in enumerate(w)]
    got = pack_swin_block(*w, heads)
    if kind is None:
        assert got is None
    else:
        want = (pack_swin_f32 if kind == "f32" else pack_swin_weights)(*w, heads)
        # compared as bits: the bf16 blob holds the f32 bias bit for bit
        assert got.dtype == dtype and torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("dtype,scale,cin", [(torch.float32, 4, 4), (torch.float32, 3, 1), (torch.bfloat16, 4, 24),
                                             (torch.bfloat16, 2, 8)])
def test_pack_tail_leaves_tails_no_kernel_packs(dtype, scale, cin):
    """``pack_tail`` owns the tail's layout decision: f32 with s^2 Cin <= 16
    and bf16 at a Cin the bf16 kernels do not take come back as they are."""
    s = 2 if scale == 4 else scale
    ops = []
    for _ in range(2 if scale == 4 else 1):
        ops += [torch.zeros(3, 3, cin, s * s * cin, dtype=dtype), torch.zeros(s * s * cin)]
    ops += [torch.zeros(3, 3, cin, 3, dtype=dtype), torch.zeros(3)]
    got = pack_tail(ops, scale)
    assert len(got) == len(ops) and all(a is b for a, b in zip(got, ops))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype,c,heads,entry", [
    (torch.float32, 180, 6, "swin_block_mma_f32"),  # SwinIR / SwinFIR
    (torch.float32, 32, 2, "swin_block_mma_f32"),  # the trained fixtures
    (torch.float32, 176, 8, "swin_block_mma_f32"),  # head dim 22
    (torch.float32, 184, 8, "swin_block_f32"),  # C above 180: the older kernel, by rule
    (torch.float32, 96, 2, "swin_block_f32"),  # head dim 48
    (torch.bfloat16, 180, 6, "swin_block_mma_bf16"),  # bf16 keeps its route
])
def test_fused_swin_block_routes_f32_by_geometry(monkeypatch, dtype, c, heads, entry):
    """f32 B1 at window 8 with C a multiple of 4 up to 180 and head dims up
    to 32 launches ``swin_block_mma_f32`` on the packed blob (dense weights
    packed on the way), counted under ``fused_swin_block``."""
    import studiosr_tpu_torch.ops.cuda.swin_block as module

    lib = _fake(monkeypatch, module)
    hidden, f32 = 2 * c, torch.float32
    ops = dict(ln1_w=_meta(c), ln1_b=_meta(c), wqkv=_meta(c, 3 * c, dtype=dtype), bqkv=_meta(3 * c),
               wproj=_meta(c, c, dtype=dtype), bproj=_meta(c), bias=_meta(heads, 64, 64), ln2_w=_meta(c),
               ln2_b=_meta(c), w1=_meta(c, hidden, dtype=dtype), b1=_meta(hidden), w2=_meta(hidden, c, dtype=dtype),
               b2=_meta(c))
    x = _meta(2, 24, 16, c, dtype=dtype)
    out = fused_swin_block(x, **ops, heads=heads, window_size=8, shift=4)
    assert out.shape == x.shape and out.dtype == dtype
    launches = [(n, a) for n, a in lib.calls]
    assert [n for n, _ in launches] == [entry]
    if dtype == f32:
        assert b1_f32_takes(c, heads, hidden) == (entry == "swin_block_mma_f32")
    if entry == "swin_block_mma_f32":
        args = launches[0][1]
        assert args[11:19] == (2, 24, 16, c, heads, hidden, 4, _f32_elements(c, heads, hidden))
        assert len(args) == len(module._F32_SIGNATURES[entry])  # ctypes types every argument
        packed = pack_swin_f32(ops["wqkv"], ops["wproj"], ops["bias"], ops["w1"], ops["w2"], heads)
        fused_swin_block(x, **dict(ops, wqkv=packed, wproj=None, bias=None, w1=None, w2=None), heads=heads,
                         window_size=8)
        assert engagement.entries() == {"fused_swin_block": {entry: 2}}
    else:
        assert engagement.entries() == {"fused_swin_block": {entry: 1}}
    engagement.reset()


@pytest.mark.parametrize("dtype,cin,cout,entry", [
    (torch.float32, 180, 180, "conv3x3_mma_f32"),  # B2 on the main path
    (torch.float32, 7, 33, "conv3x3_mma_f32"),
    (torch.float32, 64, 3, "conv3x3_f32"),  # Cout <= 16 (conv_last) keeps the FMA kernel
    (torch.bfloat16, 180, 180, "conv3x3_mma_bf16"),  # bf16 keeps its route
])
def test_fused_conv3x3_routes_f32_by_cout(monkeypatch, dtype, cin, cout, entry):
    """f32 with Cout > 16 launches ``conv3x3_mma_f32`` on packed weights
    (HWIO packed on the way, packed ones as they are); Cout <= 16 keeps the
    FMA kernel on HWIO."""
    import studiosr_tpu_torch.ops.cuda.conv3x3 as module

    lib = _fake(monkeypatch, module)
    x = _meta(1, 9, 13, cin, dtype=dtype)
    w, b = _meta(3, 3, cin, cout, dtype=dtype), _meta(cout)
    out = fused_conv3x3(x, w, b, "lrelu0.2", False, _meta(1, 9, 13, cout, dtype=dtype))
    assert out.shape == (1, 9, 13, cout) and out.dtype == dtype
    assert [n for n, _ in lib.calls] == [entry]
    assert lib.calls[0][1][5:13] == (1, 9, 13, cin, cout, 2, pytest.approx(0.2), 0)
    if dtype == torch.float32:
        assert conv_f32_takes(cout) == (entry == "conv3x3_mma_f32")
    if entry == "conv3x3_mma_f32":
        fused_conv3x3(x, pack_conv3x3_f32_weights(w), b)
        assert engagement.entries() == {"fused_conv3x3": {entry: 2}}
        with pytest.raises(ValueError, match="shape"):  # packed for another Cin
            fused_conv3x3(x, pack_conv3x3_f32_weights(_meta(3, 3, cin + 40, cout)), b)
    engagement.reset()


@pytest.mark.parametrize("c,entry", [(180, "resblock_mma_f32"), (48, "resblock_mma_f32"), (8, "resblock_f32")])
def test_fused_resblock_routes_f32_by_width(monkeypatch, c, entry):
    """f32 B14 with C > 16 runs both passes on the f32 conv written for the
    H100 (``resblock_mma_f32``, packed weights); C <= 16 keeps two FMA
    passes on HWIO."""
    import studiosr_tpu_torch.ops.cuda.conv3x3 as module

    lib = _fake(monkeypatch, module)
    x, w, b = _meta(1, 9, 13, c), _meta(3, 3, c, c), _meta(c)
    out = fused_resblock(x, w, b, w, b, 0.5, "lrelu0.2")
    assert out.shape == x.shape
    assert [n for n, _ in lib.calls] == [entry]
    assert lib.calls[0][1][7:] == (1, 9, 13, c, 2, pytest.approx(0.2), pytest.approx(0.5), 0)
    assert engagement.entries() == {"fused_resblock": {entry: 1}}
    engagement.reset()


@pytest.mark.parametrize("scale,cin,entry", [
    (4, 64, "upsample_x4_mma_f32"), (2, 64, "upsample_s_mma_f32"), (3, 64, "upsample_s_mma_f32"),
    (4, 4, "upsample_x4_f32"),  # 4 Cin = 16: the FMA kernel, by rule
])
def test_fused_tails_route_f32_wide_passes(monkeypatch, scale, cin, entry):
    """An f32 tail whose wide convs have s^2 Cin > 16 launches the entry
    whose wide passes run the f32 conv written for the H100 (weights packed
    on the way; conv_last HWIO); ``pack_tail`` packs the wide convs in f32
    and leaves conv_last HWIO."""
    import studiosr_tpu_torch.ops.cuda.upsampler as module

    lib = _fake(monkeypatch, module)
    s = 2 if scale == 4 else scale
    convs = 2 if scale == 4 else 1
    ops = []
    for _ in range(convs):
        ops += [_meta(3, 3, cin, s * s * cin), _meta(s * s * cin)]
    ops += [_meta(3, 3, cin, 3), _meta(3)]
    x = _meta(1, 6, 5, cin)
    out = fused_upsample_x4(x, *ops) if scale == 4 else fused_upsample_s(x, *ops, s)
    assert out.shape == (1, 6 * scale, 5 * scale, 3)
    assert [n for n, _ in lib.calls] == [entry]
    if entry.endswith("mma_f32"):
        packed = pack_tail(ops, scale)
        assert all(t.shape == packed_conv3x3_f32_shape(cin, s * s * cin) for t in packed[:-2:2])
        assert packed[-2] is ops[-2]
        fused_upsample_x4(x, *packed) if scale == 4 else fused_upsample_s(x, *packed, s)
        name = "fused_upsample_x4" if scale == 4 else "fused_upsample_s"
        assert engagement.entries() == {name: {entry: 2}}
    engagement.reset()


def test_b11_f32_keeps_its_cab_kernel(monkeypatch):
    """B11's CAB trunk (GELU and the channel partials) runs its own entry in
    f32, ``cab_body_mma_f32`` (B2's f32 kernel in its CAB instantiation),
    not B2's conv entry; Cm above 64 keeps ``cab_body_f32``."""
    import studiosr_tpu_torch.ops.cuda.conv3x3 as module

    lib = _fake(monkeypatch, module)
    for c, cm, entry in ((180, 60, "cab_body_mma_f32"), (180, 72, "cab_body_f32")):
        lib.calls.clear()
        fused_cab_body(_meta(1, 8, 8, c), _meta(c), _meta(c), _meta(3, 3, c, cm), _meta(cm), _meta(3, 3, cm, c),
                       _meta(c))
        assert [n for n, _ in lib.calls if not n.endswith(("_tiles", "_partials"))] == [entry]
    engagement.reset()


# -- the 3xTF32 arithmetic ---------------------------------------------------------------


def _f32_limit(want: torch.Tensor) -> float:
    return 1e-4 * float(want.abs().max()) + 1e-5


@pytest.mark.parametrize("cin,cout,residual", [(40, 24, False), (24, 24, True)])
def test_conv_in_3xtf32_holds_f32(cin, cout, residual):
    """The f32 conv's products in 3xTF32 (an im2col product through
    ``tf32x3.matmul``) agree with the f32 conv and with f64 within the f32
    kernels' rule."""
    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.standard_normal((2, 7, 9, cin)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    extra = torch.from_numpy(rng.standard_normal((2, 7, 9, cout)).astype(np.float32))
    got = conv3x3_plain(x, pack_conv3x3_f32_weights(w), b, "lrelu0.1", residual, extra, mm=tf32x3.matmul)
    want = conv3x3_plain(x, w, b, "lrelu0.1", residual, extra)
    ref = conv3x3_plain(x.double(), w.double(), b.double(), "lrelu0.1", residual, extra.double())
    assert float((got - want).abs().max()) <= _f32_limit(want)
    assert float((got.double() - ref).abs().max()) <= _f32_limit(ref)
    assert float((got - want).abs().max()) > 0  # the products did go through 3xTF32


@pytest.mark.parametrize("shift", [0, 4])
def test_swin_block_in_3xtf32_holds_f32(shift):
    """The Swin block with every product in 3xTF32 (``mm=tf32x3.matmul``, on
    the packed blob) agrees with the f32 plain version and with f64 within
    the f32 kernels' rule, at C 32, 2 heads, a 16 x 24 map."""
    c, heads, hidden = 32, 2, 64
    rng = np.random.default_rng(shift)
    f = lambda *s, sc=1.0: torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32))  # noqa: E731
    ops = dict(ln1_w=1 + f(c, sc=0.1), ln1_b=f(c, sc=0.1), wqkv=f(c, 3 * c, sc=c**-0.5), bqkv=f(3 * c, sc=0.1),
               wproj=f(c, c, sc=c**-0.5), bproj=f(c, sc=0.1), bias=f(heads, 64, 64, sc=0.5), ln2_w=1 + f(c, sc=0.1),
               ln2_b=f(c, sc=0.1), w1=f(c, hidden, sc=c**-0.5), b1=f(hidden, sc=0.1),
               w2=f(hidden, c, sc=hidden**-0.5), b2=f(c, sc=0.1))
    x = f(2, 16, 24, c)
    kw = dict(heads=heads, window_size=8, shift=shift)
    packed = dict(ops, wqkv=pack_swin_f32(ops["wqkv"], ops["wproj"], ops["bias"], ops["w1"], ops["w2"], heads),
                  wproj=None, bias=None, w1=None, w2=None)
    got = swin_block_plain(x, **packed, **kw, mm=tf32x3.matmul)
    want = swin_block_plain(x, **ops, **kw)
    ref = swin_block_plain(x.double(), **{k: v.double() for k, v in ops.items()}, **kw).double()
    assert float((got - want).abs().max()) <= _f32_limit(want)
    assert float((got.double() - ref).abs().max()) <= _f32_limit(ref)


# -- the forward against the JAX package ---------------------------------------------------


def test_f32_fused_swinir_forward_matches_the_jax_package():
    """The port's f32 ``swinir_fast_forward`` on the weights ``prepare_serving``
    packs in f32 (B1's blob, B2's and the tail's images; on the CPU the plain
    versions multiply by hi + lo) against the JAX package's f32 fused forward
    (Pallas in interpret mode) at C 32, 2 heads, a 16 x 16 map."""
    kw = dict(scale=2, embed_dim=32, depths=[2], num_heads=[2], window_size=8, mlp_ratio=2.0)
    jax_model = JaxSwinIR.build(**kw)
    model = SwinIR.build(**kw, device="cpu")
    load_jax_params(model.module, jax_model.variables["params"])
    x = np.random.default_rng(7).random((1, 16, 16, 3)).astype(np.float32)
    jax_prep = jax_prepare_serving(jax_model.variables, jax_model.config, jnp.float32)
    want = jax_swinir_fast_forward(jax_model.variables, jnp.asarray(x), jax_model.config, interpret=True,
                                   prep=jax_prep)
    prep = prepare_serving(model.module, model.config, torch.float32)
    assert prep["blocks"][0][0]["wqkv"].dim() == 1 and prep["convs"][0][0].dim() == 5
    with torch.no_grad():
        got = swinir_fast_forward(model.module, torch.from_numpy(x), model.config, prep=prep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
