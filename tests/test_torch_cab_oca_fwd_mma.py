"""B11 and B12's bf16 routes written for the H100 (``csrc/cab_mma.cu``,
``csrc/oca_fwd_mma.cu``), on the CPU: B11's packed conv weights checked
element by element against their rule and unpacked back to the identity,
its pixel tiles and the fixed order its partials are summed in, and its
plain version on packed and HWIO weights (``res_scale`` included) against
the Pallas ``fused_cab_body`` in interpret mode; B12's operand images (its
pass 0) element by element, and the forward read back from them against the
Pallas ``oca_core_fwd`` in interpret mode; ``prepare_hat_serving``'s B11
layout; and both wrappers' routing by dtype and geometry (launches on meta
tensors through a fake library).

Inputs come from numpy seeds and go to both packages. Tolerances: B11 atol
2e-5, rtol 1e-4 in f32 (its channel sums the same rule scaled by the pixel
count), B12 the JAX package's tests/ops/test_oca_vjp.py (atol 1e-4, rtol
1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.ops.pallas.conv3x3 import fused_cab_body as jax_fused_cab_body
from studiosr_tpu.ops.pallas.oca_core import oca_core_fwd as jax_oca_core_fwd
from studiosr_tpu_torch import HAT
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.conv3x3 import (
    cab_body_plain, cab_f32_mma_takes, cab_mma_takes, cab_partition, fused_cab_body, pack_cab_convs,
    pack_cab_weights, packed_cab_shape, unpack_cab_weights,
)
from studiosr_tpu_torch.ops.cuda.oca_core import (
    counter, fwd_from_images, mma_takes, oca_core_fwd, pack_fwd_images,
)
from studiosr_tpu_torch.serving.hat_fast import prepare_hat_serving
from studiosr_tpu_torch.ops.cuda._launch import STREAM

torch.set_num_threads(2)


def _meta_call(device, entry, *args):
    """``_launch.call`` for operands on the meta device, which reach the
    launch path without a card: no card to make current, stream 0."""
    return entry(*(0 if a is STREAM else a for a in args))


ATOL_B11, RTOL_B11 = 2e-5, 1e-4
ATOL_B12, RTOL_B12 = 1e-4, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _f(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bf16_exact(a):
    """``a`` rounded to bf16 and back: values the packed bf16 layout holds exactly."""
    return _t(a).to(torch.bfloat16).float().numpy()


# -- B11's packed weights ----------------------------------------------------------------


def _expected_cab_pack(w: np.ndarray, nc: int) -> np.ndarray:
    """The packed weights built element by element from the rule: for each
    chunk of nc output columns, each tap and each chunk of 64 input channels,
    a K-major image of 64 rows x nc columns (core matrices of 8 columns x 8
    rows, 16 contiguous bytes a column's 8 rows): column n, input channel k
    of the slot at (k // 8) nc 8 + (n // 8) 64 + (n % 8) 8 + k % 8, holding
    w[tap, 64 kc + k, nc q + n], zero past Cin and Cout."""
    _, _, cin, cout = w.shape
    taps = w.reshape(9, cin, cout)
    nchunk, kch = -(-cout // nc), -(-cin // 64)
    out = np.zeros(nchunk * 9 * kch * 64 * nc, np.float32)
    slot = 0
    for q in range(nchunk):
        for tap in range(9):
            for kc in range(kch):
                for n in range(nc):
                    for k in range(64):
                        ci, co = 64 * kc + k, nc * q + n
                        if ci < cin and co < cout:
                            out[slot * 64 * nc + (k // 8) * nc * 8 + (n // 8) * 64 + (n % 8) * 8 + k % 8] = \
                                taps[tap, ci, co]
                slot += 1
    return out


@pytest.mark.parametrize("cin,cout,nc", [(180, 60, 64), (60, 180, 96), (24, 8, 64), (8, 24, 96)])
def test_b11_packed_layout_matches_its_rule_element_by_element(cin, cout, nc):
    """conv1 (C -> Cm, 64-column chunks) and conv2 (Cm -> C, 96) at HAT's
    widths and at the trained fixtures' narrow ones; unpacking gives the
    weights back."""
    w = _bf16_exact(_f(np.random.default_rng(cin + cout), 3, 3, cin, cout))
    packed = pack_cab_weights(_t(w), nc)
    assert packed.dtype == torch.bfloat16 and tuple(packed.shape) == packed_cab_shape(cin, cout, nc)
    np.testing.assert_array_equal(packed.float().numpy().reshape(-1), _expected_cab_pack(w, nc))
    np.testing.assert_array_equal(unpack_cab_weights(packed, cin, cout, nc).float().numpy(), w)


def test_b11_unpack_rejects_a_layout_that_does_not_fit():
    packed = pack_cab_weights(torch.zeros(3, 3, 180, 60), 64)
    with pytest.raises(ValueError, match="do not fit"):
        unpack_cab_weights(packed, 180, 60, 96)
    with pytest.raises(ValueError, match="do not fit"):
        unpack_cab_weights(packed, 120, 60, 64)


@pytest.mark.parametrize("c,cm,takes", [(180, 60, True), (24, 8, True), (192, 64, True), (200, 60, False),
                                        (181, 60, False), (180, 65, False)])
def test_b11_h100_geometry(c, cm, takes):
    """C even up to 192 (conv1's K: three 64-channel slots a tap), Cm up to
    64 (conv1's N)."""
    assert cab_mma_takes(c, cm) == takes


# -- B11's tiles and their partials --------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 37, 53, 16), (1, 16, 8, 6), (1, 5, 7, 4), (1, 64, 40, 8)])
def test_b11_tile_partials_summed_in_the_kernels_order_give_the_sums(shape):
    """The kernel's tiles cover each pixel once; each tile's f32 column sums
    of y2, summed as ``cb_sum_kernel`` sums them (eight interleaved runs of
    tiles, each in tile order, then the runs in order), give the sums."""
    b, h, w, c = shape
    tiles = cab_partition(h, w)
    cover = np.zeros((h, w), int)
    for y0, y1, x0, x1 in tiles:
        assert 0 <= y0 < y1 <= h and 0 <= x0 < x1 <= w and y1 - y0 <= 16 and x1 - x0 <= 8
        cover[y0:y1, x0:x1] += 1
    assert (cover == 1).all()
    rng = np.random.default_rng(sum(shape))
    x = _t(_f(rng, *shape))
    ops = [_t(a) for a in (1 + _f(rng, c, scale=0.1), _f(rng, c, scale=0.1), _f(rng, 3, 3, c, 4, scale=0.3),
                           _f(rng, 4, scale=0.1), _f(rng, 3, 3, 4, c, scale=0.3), _f(rng, c, scale=0.1))]
    y2, sums = cab_body_plain(x, *ops, res_scale=0.5)
    part = torch.stack([y2[:, y0:y1, x0:x1].sum(dim=(1, 2)) for y0, y1, x0, x1 in tiles], 1)  # (B, tiles, C)
    runs = [sum((part[:, t] for t in range(r, len(tiles), 8)), torch.zeros(b, c)) for r in range(8)]
    total = sum(runs, torch.zeros(b, c))
    np.testing.assert_allclose(total.numpy(), sums.numpy(), atol=1e-4, rtol=1e-5)


# -- B11's plain version against the Pallas kernel -------------------------------------------


@pytest.mark.parametrize("shape,cm,res_scale", [((2, 8, 16, 24), 8, 1.0), ((1, 16, 8, 16), 6, 0.5),
                                                ((1, 7, 12, 16), 5, 2.0)])
def test_b11_plain_on_packed_and_hwio_weights_matches_pallas(shape, cm, res_scale):
    """The CPU wrapper on packed and on HWIO weights against the Pallas
    ``fused_cab_body`` in interpret mode, res_scale 1 and not. At the odd
    height 7 the JAX wrapper takes its XLA route (the same function; its
    sums are of y2 in f32 there too)."""
    b, h, w, c = shape
    rng = np.random.default_rng(h * w + cm)
    x = _f(rng, *shape)
    ops = [1 + _f(rng, c, scale=0.1), _f(rng, c, scale=0.1), _bf16_exact(_f(rng, 3, 3, c, cm, scale=(9 * c) ** -0.5)),
           _f(rng, cm, scale=0.1), _bf16_exact(_f(rng, 3, 3, cm, c, scale=(9 * cm) ** -0.5)), _f(rng, c, scale=0.1)]
    want_y, want_s = jax_fused_cab_body(jnp.asarray(x), *[jnp.asarray(a) for a in ops], res_scale=res_scale,
                                        interpret=True)
    hwio = [_t(a) for a in ops]
    w1, w2 = pack_cab_convs(hwio[2], hwio[4])
    engagement.reset()
    for weights in ((hwio[2], hwio[4]), (w1, w2)):
        got_y, got_s = fused_cab_body(_t(x), hwio[0], hwio[1], weights[0], hwio[3], weights[1], hwio[5],
                                      res_scale=res_scale)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=ATOL_B11, rtol=RTOL_B11)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=ATOL_B11 * h * w, rtol=RTOL_B11)
    assert engagement.counters() == {}  # CPU tensors take the plain version


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prepare_hat_serving_packs_b11_in_bf16_only(dtype):
    """bf16 serving packs each CAB's two convs at load time for the H100
    kernel; f32 at this C (30, not a multiple of 4: cab_body.cu's route)
    keeps HWIO, the layout of cab_body.cu."""
    model = HAT.build(scale=4, embed_dim=30, depths=[1], num_heads=[2], window_size=8, compress_ratio=3,
                      device="cpu")
    prep = prepare_hat_serving(model.module, model.config, dtype)
    cab = prep["blocks"][0][0]["cab"]
    c, cm = 30, 10
    conv1 = model.module.layers[0].residual_group.blocks[0].conv_block.cab._modules["0"].weight
    hwio1 = conv1.detach().permute(2, 3, 1, 0).to(dtype)
    assert list(cab) == ["ln_w", "ln_b", "w1", "b1", "w2", "b2"]
    if dtype == torch.bfloat16:
        assert tuple(cab["w1"].shape) == packed_cab_shape(c, cm, 64)
        assert tuple(cab["w2"].shape) == packed_cab_shape(cm, c, 96)
        assert torch.equal(unpack_cab_weights(cab["w1"], c, cm, 64), hwio1)
    else:
        assert not cab_f32_mma_takes(c, cm)
        assert tuple(cab["w1"].shape) == (3, 3, c, cm) and tuple(cab["w2"].shape) == (3, 3, cm, c)
        assert torch.equal(cab["w1"], hwio1)


# -- B12's images and the forward read from them ----------------------------------------------


def _strided(rng, bw, heads, n, d, scale=1.0):
    """A (bw, heads, n, d) view over (bw, n, heads, d) storage, as the OCAB's."""
    return _t(_f(rng, bw, n, heads, d, scale=scale)).transpose(1, 2)


@pytest.mark.parametrize("bw,heads,nq,nk,d", [(2, 2, 64, 144, 16), (1, 3, 100, 70, 30), (2, 1, 256, 576, 8),
                                              (1, 2, 130, 200, 7)])
def test_b12_operand_images_match_their_rule_element_by_element(bw, heads, nq, nk, d):
    """Pass 0's images: per (window, head) unit, q in ceil(nq / 64) tiles and
    k in ceil(nk / 64) chunks with position p, column j at (p // 8) DP 8 + (j
    // 8) 64 + (p % 8) 8 + j % 8, then v in ceil(nk / 64) chunks with position
    p, column j at (j // 8) 512 + (p // 8) 64 + (j % 8) 8 + p % 8; 64 tokens x
    DP (16 at d <= 16, else 32) a tile, zero past the tokens and past d. q's
    token t of a tile sits at position t; k's and v's key t = 16 tq + 2 nt + e
    of a chunk at position 8 nt + 2 tq + e."""
    rng = np.random.default_rng(bw + nq + nk + d)
    q, k, v = _strided(rng, bw, heads, nq, d), _strided(rng, bw, heads, nk, d), _strided(rng, bw, heads, nk, d)
    img = pack_fwd_images(q, k, v).numpy()
    dp = 16 if d <= 16 else 32
    qt, kt = -(-nq // 64), -(-nk // 64)
    assert img.shape == (bw * heads, (qt + 2 * kt) * 64 * dp)
    want = np.zeros_like(img)
    tile = 0
    for t, n, token_major, keys in ((q, nq, False, False), (k, nk, False, True), (v, nk, True, True)):
        a = t.numpy()
        for ti in range(-(-n // 64)):
            for tok in range(64):
                p = 8 * ((tok % 16) // 2) + 2 * (tok // 16) + tok % 2 if keys else tok
                for j in range(dp):
                    if token_major:
                        pos = (j // 8) * 512 + (p // 8) * 64 + (j % 8) * 8 + p % 8
                    else:
                        pos = (p // 8) * dp * 8 + (j // 8) * 64 + (p % 8) * 8 + j % 8
                    if 64 * ti + tok < n and j < d:
                        want[:, tile * 64 * dp + pos] = a[:, :, 64 * ti + tok, j].reshape(-1)
            tile += 1
    np.testing.assert_array_equal(img, want)


@pytest.mark.parametrize("bw,heads,nq,nk,d", [(2, 2, 64, 144, 30), (2, 6, 256, 576, 30), (3, 2, 64, 144, 16)])
def test_b12_forward_from_its_images_matches_pallas(bw, heads, nq, nk, d):
    """The forward read back from pass 0's images, and ``oca_core_fwd``'s
    plain version on the OCAB's strided views, against the Pallas
    ``oca_core_fwd`` in interpret mode: d 30 at 64 | 144 tokens and at HAT's
    256 | 576 with 6 heads, and the trained fixtures' d 16; scores of a few
    units, so the row max matters."""
    rng = np.random.default_rng(bw + nq + nk + d)
    q = _strided(rng, bw, heads, nq, d, 2 * d**-0.5)
    k, v = _strided(rng, bw, heads, nk, d), _strided(rng, bw, heads, nk, d)
    bias = _t(_f(rng, heads, nq, nk, scale=2.0))
    want = np.asarray(jax_oca_core_fwd(*[jnp.asarray(t.contiguous().numpy()) for t in (q, k, v, bias)],
                                       interpret=True))
    img = pack_fwd_images(q, k, v)
    np.testing.assert_allclose(fwd_from_images(img, bias, bw, heads, nq, nk, d).numpy(), want, atol=ATOL_B12,
                               rtol=RTOL_B12)
    engagement.reset()
    np.testing.assert_allclose(oca_core_fwd(q, k, v, bias).numpy(), want, atol=ATOL_B12, rtol=RTOL_B12)
    assert engagement.counters() == {}


def test_b12_forward_from_images_sees_a_misplaced_element():
    """The read-back is no identity: moving one element of a v chunk to
    another column changes the forward."""
    rng = np.random.default_rng(1)
    q, k, v = _strided(rng, 1, 1, 64, 16), _strided(rng, 1, 1, 64, 16), _strided(rng, 1, 1, 64, 16)
    bias = _t(_f(rng, 1, 64, 64))
    img = pack_fwd_images(q, k, v)
    good = fwd_from_images(img, bias, 1, 1, 64, 64, 16)
    a, b = 2 * 64 * 16 + 3, 2 * 64 * 16 + 3 + 512  # v's token 3 in columns 0 and 8
    img[0, [a, b]] = img[0, [b, a]].clone()
    assert not torch.allclose(fwd_from_images(img, bias, 1, 1, 64, 64, 16), good)


# -- the wrappers' routing ------------------------------------------------------------------


class _FakeLibrary:
    """Stands in for the built kernel libraries: records the C entries a
    wrapper calls; every call returns 0 (and computes nothing), so tile
    counts and scratch sizes come back 0."""

    def __init__(self):
        self.calls = []

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
    return [name for name, _ in lib.calls if not name.endswith(("_scratch", "_tiles", "_partials"))]


@pytest.mark.parametrize("dtype,c,cm,packed,entry", [
    (torch.bfloat16, 180, 60, False, "cab_body_mma_bf16"),  # HAT serving, HWIO packed per call
    (torch.bfloat16, 180, 60, True, "cab_body_mma_bf16"),  # weights packed at load time
    (torch.bfloat16, 24, 8, False, "cab_body_mma_bf16"),  # the trained fixtures' width
    (torch.bfloat16, 200, 60, False, "cab_body_bf16"),  # C above 192: the older kernel, by rule
    (torch.bfloat16, 180, 72, False, "cab_body_bf16"),  # Cm above 64
    (torch.float32, 180, 60, False, "cab_body_mma_f32"),  # HAT's f32 serving: the 3xTF32 kernel
])
def test_fused_cab_body_routes_by_dtype_and_geometry(monkeypatch, dtype, c, cm, packed, entry):
    """bf16 with C even up to 192 and Cm up to 64, and f32 with C a multiple
    of 4 up to 256 and Cm up to 64, go to the kernels written for the H100,
    with ``res_scale`` handed on; each launch counts under ``fused_cab_body``
    and its C entry."""
    import studiosr_tpu_torch.ops.cuda.conv3x3 as module

    lib = _fake(monkeypatch, module)
    f32 = torch.float32
    meta = lambda *s, dt=dtype: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    w1, w2 = meta(3, 3, c, cm), meta(3, 3, cm, c)
    if packed:
        w1, w2 = pack_cab_convs(w1, w2)
    y2, sums = fused_cab_body(meta(2, 9, 11, c), meta(c, dt=f32), meta(c, dt=f32), w1, meta(cm, dt=f32), w2,
                              meta(c, dt=f32), res_scale=0.25)
    assert y2.shape == (2, 9, 11, c) and y2.dtype == dtype and sums.shape == (2, c) and sums.dtype == f32
    assert _launches(lib) == [entry]
    assert lib.calls[-1][1][-2:] == (0.25, 0)  # res_scale, the stream
    assert (cab_mma_takes(c, cm) if dtype == torch.bfloat16 else cab_f32_mma_takes(c, cm)) == ("mma" in entry)
    assert engagement.entries() == {"fused_cab_body": {entry: 1}}
    engagement.reset()


@pytest.mark.parametrize("dtype,heads,nq,nk,d,bias_dtype,entry", [
    (torch.bfloat16, 6, 256, 576, 30, torch.bfloat16, "oca_core_fwd_mma_bf16"),  # HAT's step: its bias in bf16
    (torch.bfloat16, 6, 256, 576, 30, torch.float32, "oca_core_fwd_mma_bf16"),
    (torch.bfloat16, 2, 64, 144, 16, torch.float32, "oca_core_fwd_mma_bf16"),  # the trained fixtures' window 8
    (torch.bfloat16, 2, 64, 144, 48, torch.float32, "oca_core_fwd_bf16"),  # head dim above 32: the older kernel
    (torch.bfloat16, 2, 64, 640, 16, torch.bfloat16, "oca_core_fwd_large_mma_bf16"),  # more than 576 keys
    (torch.float32, 6, 256, 576, 30, torch.float32, "oca_core_fwd_f32"),
])
def test_oca_core_fwd_routes_by_dtype_and_geometry(monkeypatch, dtype, heads, nq, nk, d, bias_dtype, entry):
    """bf16 with a head dim up to 32 goes to the forward written for the
    H100 (its large entry above 256 queries or 576 keys), which reads a bf16
    bias as it is (flag 1) and any other in f32; other bf16 geometries and
    f32 take the older kernel with the bias in f32; the output is the OCAB's
    transposed view; each launch counts under ``oca_core_fwd`` (above 256
    queries or 576 keys ``oca_core_fwd_large``) and its C entry."""
    import studiosr_tpu_torch.ops.cuda.oca_core as module

    lib = _fake(monkeypatch, module)
    bw = 3
    view = lambda n: torch.empty(bw, n, heads, d, dtype=dtype, device="meta").transpose(1, 2)  # noqa: E731
    out = oca_core_fwd(view(nq), view(nk), view(nk), torch.empty(heads, nq, nk, dtype=bias_dtype, device="meta"))
    assert out.shape == (bw, heads, nq, d) and out.dtype == dtype
    assert out.stride() == (nq * heads * d, d, heads * d, 1)  # (bw, nq, heads, d) storage
    assert _launches(lib) == [entry]
    assert (dtype == torch.bfloat16 and mma_takes(heads, nq, nk, d)) == (entry == "oca_core_fwd_mma_bf16")
    assert (dtype == torch.bfloat16 and d <= 32 and counter("", nq, nk) == "_large") == ("large" in entry)
    if "mma" in entry:
        assert lib.calls[-1][1][6] == int(bias_dtype == torch.bfloat16)
    assert engagement.entries() == {counter("oca_core_fwd", nq, nk): {entry: 1}}
    engagement.reset()
