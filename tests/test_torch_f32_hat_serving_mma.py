"""B11 and B10 in f32 on the kernels written for the H100 (``csrc/cab_mma.cu``
``cab_body_mma_f32`` on ``csrc/conv3x3_f32.cuh``, ``csrc/ocab_f32.cu``
``ocab_mma_f32``), HAT's f32 serving forward, on the CPU: the wrappers'
routing by dtype and geometry (launches on meta tensors through a fake
library); the plain versions with every product in 3xTF32
(``ops/cuda/tf32x3.py``, the kernels' arithmetic) against the same functions
in f64 and against the Pallas kernels in interpret mode; plain mirrors of
the kernels' block partitions (B11's conv2 tiles and their fixed-order
channel sums, B10's attention blocks); and the first design's shared-memory
limit at windows from 9 (C11), computed from its layout functions.

Inputs come from numpy seeds and go to both packages. Tolerances: against
f64, the f32 kernels' rule on the card (max |k - p| <= 1e-4 max |p| +
1e-5); against the Pallas kernels, tests/test_torch_hat.py's (atol 5e-5,
rtol 1e-4; B11's sums, over H W pixels, atol scaled by the count).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from studiosr_tpu.ops.pallas.conv3x3 import fused_cab_body as jax_fused_cab_body
from studiosr_tpu.ops.pallas.ocab import fused_ocab_block as jax_fused_ocab_block
from studiosr_tpu_torch.ops.cuda import engagement, tf32x3
from studiosr_tpu_torch.ops.cuda import conv3x3 as conv_module
from studiosr_tpu_torch.ops.cuda import ocab as ocab_module
from studiosr_tpu_torch.ops.cuda import window_attention as wa_module
from studiosr_tpu_torch.ops.cuda._launch import STREAM
from studiosr_tpu_torch.ops.cuda.conv3x3 import (
    cab_body_plain, cab_f32_mma_takes, cab_f32_partition, fused_cab_body, pack_cab_f32_convs,
)
from studiosr_tpu_torch.ops.cuda.mlp_block import _f32_pack_index as mlp_f32_pack_index
from studiosr_tpu_torch.ops.cuda.ocab import (
    fused_ocab_block, ocab_f32_mma_takes, ocab_f32_partition, ocab_plain, overlap_window, packed_ocab_elems,
)
from studiosr_tpu_torch.ops.cuda.window_attention import _f32_fwd_pack_index
from studiosr_tpu_torch.ops.windows import gather_rel_bias, relative_position_index_oca

torch.set_num_threads(2)

ATOL, RTOL = 5e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _f(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(np.float32)


def _f32_close(got, want):
    """The f32 kernels' rule: max |got - want| <= 1e-4 max |want| + 1e-5."""
    got, want = got.double(), want.double()
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()) + 1e-5, err


def _meta_call(device, entry, *args):
    """``_launch.call`` for operands on the meta device, which reach the
    launch path without a card: no card to make current, stream 0."""
    return entry(*(0 if a is STREAM else a for a in args))


class _FakeLibrary:
    """Stands in for the built kernel libraries: records the C entries a
    wrapper calls and answers the packed layouts' sizes as the built
    libraries do; every launch returns status 0."""

    def __init__(self):
        self.calls = []

    def ocab_mma_pack_elems(self, c, heads, hidden):
        return packed_ocab_elems(c, heads, hidden)

    def ocab_mma_f32_pack_elems(self, c, heads, ws, pad, hidden):
        return _f32_fwd_pack_index(c, heads).size

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


def _fake(monkeypatch, module):
    from studiosr_tpu_torch.ops.cuda import _build

    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda name, signatures, restypes=None: lib)
    monkeypatch.setattr(module, "call", _meta_call)
    engagement.reset()
    return lib


def _launches(lib):
    return [(n, a) for n, a in lib.calls if not n.endswith(("_scratch", "_elems", "_tiles", "_partials"))]


# -- the routing -----------------------------------------------------------------------


@pytest.mark.parametrize("dtype,c,cm,packed,entry", [
    (torch.float32, 180, 60, False, "cab_body_mma_f32"),  # HAT x4 serving, HWIO packed per call
    (torch.float32, 180, 60, True, "cab_body_mma_f32"),  # packed at load time (prepare_hat_serving)
    (torch.float32, 24, 8, False, "cab_body_mma_f32"),  # the trained fixtures' width
    (torch.float32, 180, 72, False, "cab_body_f32"),  # Cm above 64: the first design
    (torch.float32, 30, 10, False, "cab_body_f32"),  # C not a multiple of 4
    (torch.bfloat16, 180, 60, False, "cab_body_mma_bf16"),  # bf16 unchanged
])
def test_b11_routes_f32_to_the_3xtf32_kernel(monkeypatch, dtype, c, cm, packed, entry):
    """B11 in f32 at C a multiple of 4 up to 256 and Cm up to 64 launches
    ``cab_body_mma_f32`` with the map's geometry, res_scale and every
    argument typed by ctypes, counted under ``fused_cab_body``; other f32
    geometries keep ``cab_body_f32``, bf16 its own entries."""
    lib = _fake(monkeypatch, conv_module)
    f32 = torch.float32
    meta = lambda *s, dt=dtype: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    w1, w2 = meta(3, 3, c, cm), meta(3, 3, cm, c)
    if packed:
        w1, w2 = pack_cab_f32_convs(w1, w2)
    y2, sums = fused_cab_body(meta(2, 9, 11, c), meta(c, dt=f32), meta(c, dt=f32), w1, meta(cm, dt=f32), w2,
                              meta(c, dt=f32), res_scale=0.5)
    assert y2.shape == (2, 9, 11, c) and y2.dtype == dtype and sums.shape == (2, c) and sums.dtype == f32
    launches = _launches(lib)
    assert [n for n, _ in launches] == [entry]
    assert launches[0][1][12:] == (2, 9, 11, c, cm, 0.5, 0)  # B, H, W, C, Cm, res_scale, the stream
    assert len(launches[0][1]) == len(conv_module._CAB_MMA_SIGNATURES["cab_body_mma_bf16"])
    assert (dtype == f32 and cab_f32_mma_takes(c, cm)) == (entry == "cab_body_mma_f32")
    assert engagement.entries() == {"fused_cab_body": {entry: 1}}
    engagement.reset()


@pytest.mark.parametrize("dtype,c,heads,ws,hidden,entry", [
    (torch.float32, 180, 6, 16, 360, "ocab_mma_f32"),  # HAT x4 serving: 256 queries, 576 keys
    (torch.float32, 180, 6, 12, 360, "ocab_mma_f32"),  # 144 queries (two slabs), 324 keys
    (torch.float32, 180, 6, 8, 360, "ocab_mma_f32"),  # the fixtures' window: 64 queries, 144 keys
    (torch.float32, 96, 2, 16, 192, "ocab_f32"),  # head dim 48: the first design
    (torch.float32, 180, 6, 16, 720, "ocab_f32"),  # hidden above 512
    (torch.float32, 180, 6, 24, 360, "ocab_f32"),  # 576 queries, 1296 keys
    (torch.bfloat16, 180, 6, 16, 360, "ocab_mma_bf16"),  # bf16 unchanged
])
def test_b10_routes_f32_to_the_3xtf32_kernels(monkeypatch, dtype, c, heads, ws, hidden, entry):
    """B10 in f32 where ``ocab_f32_mma_takes`` the geometry launches
    ``ocab_mma_f32`` with the map's geometry and the two index tables B5
    f32 and B6 f32 pack by, counted under ``fused_ocab_block``; other f32
    geometries keep ``ocab_f32``, bf16 its own entries."""
    lib = _fake(monkeypatch, ocab_module)
    owin, pad = overlap_window(ws, 0.5)
    f32 = torch.float32
    meta = lambda *s, dt=dtype: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    shape = (1, 2 * ws, 3 * ws, c)
    out = fused_ocab_block(meta(*shape), meta(c, dt=f32), meta(c, dt=f32), meta(c, 3 * c), meta(3 * c, dt=f32),
                           meta(c, c), meta(c, dt=f32), meta(heads, ws * ws, owin * owin, dt=f32), meta(c, dt=f32),
                           meta(c, dt=f32), meta(c, hidden), meta(hidden, dt=f32), meta(hidden, c), meta(c, dt=f32),
                           heads=heads, window_size=ws, overlap_ratio=0.5)
    assert out.shape == shape and out.dtype == dtype
    launches = _launches(lib)
    assert [n for n, _ in launches] == [entry]
    args = launches[0][1]
    assert args[2:10] == (*shape[:3], c, heads, ws, pad, hidden)
    if entry == "ocab_mma_f32":
        assert len(args) == len(ocab_module._SIGNATURES_F32[entry])
        assert args[24] == _f32_fwd_pack_index(c, heads).size and args[26] == mlp_f32_pack_index(c, hidden).size
    assert (dtype == f32 and ocab_f32_mma_takes(c, heads, ws, 0.5, hidden)) == (entry == "ocab_mma_f32")
    assert engagement.entries() == {"fused_ocab_block": {entry: 1}}
    engagement.reset()


def test_prepare_hat_serving_packs_b11_in_f32():
    """f32 serving packs each CAB's two convs at load time in the hi / lo
    images the f32 kernel reads (conv1 in 64-column tiles, conv2 in 96),
    hi + lo within 2^-21 of the weights; B10's stay dense (its entry packs
    them per call)."""
    from studiosr_tpu_torch import HAT
    from studiosr_tpu_torch.ops.cuda.conv3x3 import (
        pack_conv3x3_f32_weights, packed_conv3x3_f32_shape, unpack_conv3x3_f32_weights,
    )
    from studiosr_tpu_torch.serving.hat_fast import prepare_hat_serving

    model = HAT.build(scale=4, embed_dim=32, depths=[1], num_heads=[2], window_size=8, compress_ratio=4,
                      device="cpu")
    prep = prepare_hat_serving(model.module, model.config, torch.float32)
    cab, ocab = prep["blocks"][0][0]["cab"], prep["ocab"][0]
    c, cm = 32, 8
    assert cab_f32_mma_takes(c, cm)
    conv1 = model.module.layers[0].residual_group.blocks[0].conv_block.cab._modules["0"].weight
    hwio1 = conv1.detach().permute(2, 3, 1, 0).float()
    assert tuple(cab["w1"].shape) == packed_conv3x3_f32_shape(c, cm, 64)
    assert tuple(cab["w2"].shape) == packed_conv3x3_f32_shape(cm, c, 96)
    assert torch.equal(cab["w1"], pack_conv3x3_f32_weights(hwio1, 64))
    torch.testing.assert_close(unpack_conv3x3_f32_weights(cab["w1"], c, cm, 64), hwio1, rtol=2.0**-21, atol=0)
    assert tuple(ocab["wqkv"].shape) == (c, 3 * c) and ocab["wproj"] is not None


# -- 3xTF32 against f64 and the Pallas kernels ------------------------------------------


def _cab_operands(rng, c, cm):
    return [1 + _f(rng, c, scale=0.1), _f(rng, c, scale=0.1), _f(rng, 3, 3, c, cm, scale=(9 * c) ** -0.5),
            _f(rng, cm, scale=0.1), _f(rng, 3, 3, cm, c, scale=(9 * cm) ** -0.5), _f(rng, c, scale=0.1)]


def _cab64(x, ln_w, ln_b, w1, b1, w2, b2, res_scale):
    """B11 in f64: LN, conv1 + GELU, conv2, res_scale, the channel sums."""
    conv = lambda a, w, b: F.conv2d(a.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, padding=1).permute(0, 2, 3, 1)  # noqa: E731
    ln = F.layer_norm(x, (x.shape[-1],), ln_w, ln_b, 1e-5)
    y2 = res_scale * conv(F.gelu(conv(ln, w1, b1)), w2, b2)
    return y2, y2.sum(dim=(1, 2))


@pytest.mark.parametrize("shape,cm,res_scale", [((1, 24, 40, 180), 60, 1.0), ((2, 13, 21, 32), 10, 0.5)])
def test_b11_in_3xtf32_holds_f32_against_f64(shape, cm, res_scale):
    """The plain B11 with every product in 3xTF32 and the weights as the
    kernel reads them (hi + lo of :func:`pack_cab_f32_convs`) against the
    same function in f64, both outputs, at HAT's widths and a ragged map."""
    rng = np.random.default_rng(sum(shape) + cm)
    c = shape[-1]
    x = _f(rng, *shape)
    ops = [_t(a) for a in _cab_operands(rng, c, cm)]
    w1, w2 = pack_cab_f32_convs(ops[2], ops[4])
    got = cab_body_plain(_t(x), ops[0], ops[1], w1, ops[3], w2, ops[5], res_scale=res_scale, mm=tf32x3.matmul)
    want = _cab64(_t(x).double(), *[t.double() for t in ops], res_scale)
    for a, e in zip(got, want):
        assert a.shape == e.shape and a.dtype == torch.float32
        _f32_close(a, e)


def test_b11_in_3xtf32_matches_pallas():
    """At tests/test_torch_hat.py's B11 geometry (C 32, Cm 10, 2 x 16 x 24):
    the 3xTF32 plain version on packed f32 weights against the Pallas
    kernel in interpret mode."""
    rng = np.random.default_rng(11)
    c, cm = 32, 10
    x = _f(rng, 2, 16, 24, c)
    ops = _cab_operands(rng, c, cm)
    want_y, want_s = jax_fused_cab_body(jnp.asarray(x), *[jnp.asarray(a) for a in ops], interpret=True)
    w1, w2 = pack_cab_f32_convs(_t(ops[2]), _t(ops[4]))
    got_y, got_s = cab_body_plain(_t(x), _t(ops[0]), _t(ops[1]), w1, _t(ops[3]), w2, _t(ops[5]), mm=tf32x3.matmul)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=ATOL * 16 * 24, rtol=RTOL)


def _ocab_operands(rng, c, heads, ws, overlap, hidden):
    owin, _ = overlap_window(ws, overlap)
    table = _t(_f(rng, (ws + owin - 1) ** 2, heads, scale=0.05))
    bias = gather_rel_bias(table, relative_position_index_oca(ws, overlap), heads)
    return [_t(1 + _f(rng, c, scale=0.1)), _t(_f(rng, c, scale=0.1)), _t(_f(rng, c, 3 * c, scale=c**-0.5)),
            _t(_f(rng, 3 * c, scale=0.1)), _t(_f(rng, c, c, scale=c**-0.5)), _t(_f(rng, c, scale=0.1)),
            bias.float().contiguous(), _t(1 + _f(rng, c, scale=0.1)), _t(_f(rng, c, scale=0.1)),
            _t(_f(rng, c, hidden, scale=c**-0.5)), _t(_f(rng, hidden, scale=0.1)),
            _t(_f(rng, hidden, c, scale=hidden**-0.5)), _t(_f(rng, c, scale=0.1))]


def _ocab64(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2, *, heads, ws, overlap):
    """B10 in f64: q from each window, k and v from the zero-padded owin x
    owin window around it, softmax(q k^T / sqrt(d) + bias) v, proj and the
    residual, then the MLP tail."""
    b, h, w, c = x.shape
    owin, pad = overlap_window(ws, overlap)
    d = c // heads
    qkv = F.layer_norm(x, (c,), ln1_w, ln1_b, 1e-5) @ wqkv + bqkv
    q = qkv[..., :c].reshape(b, h // ws, ws, w // ws, ws, heads, d).permute(0, 1, 3, 5, 2, 4, 6)
    q = q.reshape(-1, heads, ws * ws, d) * d**-0.5
    kv = F.pad(qkv[..., c:], (0, 0, pad, pad, pad, pad)).unfold(1, owin, ws).unfold(2, owin, ws)
    kv = kv.permute(0, 1, 2, 4, 5, 3).reshape(-1, owin * owin, 2, heads, d)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    o = torch.softmax(q @ k.transpose(-1, -2) + bias, -1) @ v  # (windows, heads, ws^2, d)
    o = o.reshape(b, h // ws, w // ws, heads, ws, ws, d).permute(0, 1, 4, 2, 5, 3, 6).reshape(b, h, w, c)
    y = x + o @ wproj + bproj
    return y + F.gelu(F.layer_norm(y, (c,), ln2_w, ln2_b, 1e-5) @ w1 + b1) @ w2 + b2


@pytest.mark.parametrize("shape,c,heads,ws,overlap", [
    ((1, 32, 48, 32), 32, 2, 16, 0.5),  # HAT's window: 24 x 24 keys reaching outside the image everywhere
    ((1, 24, 36, 24), 24, 2, 12, 0.5),  # 144 queries (a ragged second slab), 18 x 18 keys
    ((2, 16, 24, 24), 24, 3, 8, 0.5),  # 12 x 12 keys: a ragged last key chunk
])
def test_b10_in_3xtf32_holds_f32_against_f64(shape, c, heads, ws, overlap):
    """The plain B10 with every product in 3xTF32 against the same block in
    f64, at HAT's windows 16, 12 and 8 (overlap 0.5, hidden 2C)."""
    assert ocab_f32_mma_takes(c, heads, ws, overlap, 2 * c)
    rng = np.random.default_rng(c + ws)
    x = _t(_f(rng, *shape))
    ops = _ocab_operands(rng, c, heads, ws, overlap, 2 * c)
    kw = dict(heads=heads, window_size=ws, overlap_ratio=overlap)
    got = ocab_plain(x, *ops, **kw, mm=tf32x3.matmul)
    want = _ocab64(x.double(), *[t.double() for t in ops], heads=heads, ws=ws, overlap=overlap)
    assert got.dtype == torch.float32
    _f32_close(got, want)


def test_b10_in_3xtf32_matches_pallas():
    """At tests/test_torch_hat.py's B10 geometry (C 24, 3 heads, window 8,
    overlap 1.0: 16 x 16 keys, 2 x 16 x 24): the 3xTF32 plain version
    against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(0)
    c, heads, ws, overlap = 24, 3, 8, 1.0
    assert ocab_f32_mma_takes(c, heads, ws, overlap, 2 * c)
    x = _f(rng, 2, 16, 24, c)
    ops = _ocab_operands(rng, c, heads, ws, overlap, 2 * c)
    want = jax_fused_ocab_block(jnp.asarray(x), *[jnp.asarray(t.numpy()) for t in ops], heads=heads, ws=ws,
                                overlap_ratio=overlap, interpret=True)
    got = ocab_plain(_t(x), *ops, heads=heads, window_size=ws, overlap_ratio=overlap, mm=tf32x3.matmul)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


# -- the kernels' partitions -------------------------------------------------------------


@pytest.mark.parametrize("b,h,w,c", [(1, 256, 256, 180), (2, 13, 21, 32), (1, 25, 17, 8)])
def test_b11_f32_tiles_cover_every_pixel_once_and_sum_to_the_channel_sums(b, h, w, c):
    """conv2's blocks (cab_f32_partition, 12 x 16 pixels each) cover the map
    once; each tile's column sums, summed over the tiles in order, give the
    channel sums of y2 (atol scaled by the pixel count, rtol 1e-5)."""
    tiles = cab_f32_partition(h, w)
    cover = torch.zeros(h, w, dtype=torch.int32)
    for y0, y1, x0, x1 in tiles:
        assert y1 - y0 <= 12 and x1 - x0 <= 16
        cover[y0:y1, x0:x1] += 1
    assert bool((cover == 1).all())
    y2 = _t(_f(np.random.default_rng(h + w), b, h, w, c))
    part = torch.stack([y2[:, y0:y1, x0:x1].sum(dim=(1, 2)) for y0, y1, x0, x1 in tiles], 1)  # (B, tiles, C)
    sums = torch.zeros(b, c)
    for i in range(len(tiles)):
        sums = sums + part[:, i]
    np.testing.assert_allclose(sums.numpy(), y2.double().sum(dim=(1, 2)).numpy(), atol=1e-6 * h * w, rtol=1e-5)


@pytest.mark.parametrize("windows,heads,ws,overlap", [(6, 6, 16, 0.5), (4, 2, 12, 0.5), (3, 3, 8, 1.0)])
def test_b10_f32_attention_blocks_cover_every_query_once(windows, heads, ws, overlap):
    """The attention pass's blocks (window, head, slab of 128 queries) take
    every (window, head, query) exactly once, each sweeping all of its
    window's ceil(owin^2 / 64) key chunks; the online softmax over those
    chunks, as the kernel runs it, gives the plain attention (atol 1e-6,
    rtol 1e-5)."""
    owin, _ = overlap_window(ws, overlap)
    nq, nk, d = ws * ws, owin * owin, 16
    seen = torch.zeros(windows, heads, nq, dtype=torch.int32)
    blocks = ocab_f32_partition(windows, heads, ws, overlap)
    for win, h, q0, q1, chunks in blocks:
        assert q1 - q0 <= 128 and chunks == -(-nk // 64)
        seen[win, h, q0:q1] += 1
    assert bool((seen == 1).all())
    rng = np.random.default_rng(windows + ws)
    q, k, v = (_t(_f(rng, windows, heads, n, d)) for n in (nq, nk, nk))
    bias = _t(_f(rng, heads, nq, nk))
    want = torch.softmax(q @ k.transpose(-1, -2) + bias, -1) @ v
    got = torch.empty_like(want)
    for win, h, q0, q1, chunks in blocks:
        m = torch.full((q1 - q0, 1), -torch.inf)
        l, o = torch.zeros(q1 - q0, 1), torch.zeros(q1 - q0, d)
        for ch in range(chunks):
            k0, k1 = 64 * ch, min(64 * ch + 64, nk)
            s = q[win, h, q0:q1] @ k[win, h, k0:k1].T + bias[h, q0:q1, k0:k1]
            mn = torch.maximum(m, s.max(-1, keepdim=True).values)
            p, sc = torch.exp(s - mn), torch.exp(m - mn)
            l, o, m = l * sc + p.sum(-1, keepdim=True), o * sc + p @ v[win, h, k0:k1], mn
        got[win, h, q0:q1] = o / l
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-5)


# -- C11: the first design's limit -------------------------------------------------------


def test_first_design_limit_comes_from_its_layouts():
    """The widest C of the first design at windows from 9 is the largest
    whose every pass fits a block's 232,448 bytes at head dim 64: 416 in f32
    (the attention pass: 231,424 bytes there, 239,616 at C 448), 828 in
    bf16. The C11 geometries (C 264 at head dim 22, C 256 at 64) fit; the
    restaged LN + q|k|v pass no longer bounds it (it held 237,824 bytes at C
    193 with its whole-K weight tiles)."""
    f32 = torch.float32
    assert wa_module.FIRST_MAX_C == {f32: 416, torch.bfloat16: 828}
    assert wa_module._first_design_smem(416, 64, f32) == 231_424 <= wa_module.SMEM_LIMIT
    assert wa_module._first_design_smem(448, 64, f32) == 239_616 > wa_module.SMEM_LIMIT
    for c, dp in ((264, 32), (256, 64)):
        assert wa_module._first_design_smem(c, dp, f32) <= wa_module.SMEM_LIMIT
