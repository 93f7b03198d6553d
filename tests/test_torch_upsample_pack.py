"""The load-time layouts of B3's and B4's bf16 kernels, on the CPU.

The pixel-shuffle convs' weights (``pack_shuffle_conv_weights``: columns in
(i, j, c) order, chunks of NC columns, each (chunk, tap) the image of a
wgmma ring slot) and conv_last's (``pack_conv_last_weights``: mma.m16n8k16
B fragments in lane order) are built here index by index from the rule the
kernels read them by, and unpacked back to HWIO. The wrappers on CPU
tensors given packed weights are held against the JAX package's Pallas
tails in interpret mode on the same (bf16-representable) weights, and
``tail_operands`` packs in bf16 and, for the f32 conv written for the H100,
the pixel-shuffle convs in f32 (conv_last stays HWIO).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.ops.pallas.upsampler import fused_upsample_s as jax_fused_upsample_s
from studiosr_tpu.ops.pallas.upsampler import fused_upsample_x4 as jax_fused_upsample_x4
from studiosr_tpu_torch import HAT, SwinIR
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.conv3x3 import pack_conv3x3_f32_weights, prepare_conv3x3_weights
from studiosr_tpu_torch.ops.cuda.upsampler import (
    fused_upsample_s, fused_upsample_x4, mma_geometry_error, pack_conv_last_weights, pack_shuffle_conv_weights,
    pack_tail, unpack_conv_last_weights, unpack_shuffle_conv_weights, upsample_s_plain, upsample_x4_plain,
)
from studiosr_tpu_torch.serving.swinir_fast import tail_operands

torch.set_num_threads(2)

ATOL, RTOL = 5e-5, 1e-4
CHUNK = {2: 128, 3: 96}  # columns of a ring slot (csrc/upsampler.cu UpChunk)


def _bf16_weights(gen, *shape):
    return (torch.randn(*shape, generator=gen) * 0.1).to(torch.bfloat16)


def _shuffle_packed_by_rule(w, s):
    """Every element of the packed layout from the rule: column n = (i s +
    j) Cin + c holds torch's output channel c s^2 + i s + j; element (n, k)
    of chunk q, tap t sits at [q, t, k // 8, n % NC // 8, n % 8, k % 8];
    columns past s^2 Cin and input channels past Cin (up to 64) are zero."""
    cin, cout = w.shape[2], w.shape[3]
    nc = CHUNK[s]
    nchunk = -(-cout // nc)
    out = torch.zeros(nchunk, 9, 8, nc // 8, 8, 8, dtype=torch.bfloat16)
    for q, t, k, nn in itertools.product(range(nchunk), range(9), range(cin), range(nc)):
        n = q * nc + nn
        if n < cout:
            p, c = divmod(n, cin)
            out[q, t, k // 8, nn // 8, nn % 8, k % 8] = w[t // 3, t % 3, k, c * s * s + p]
    return out


def _last_packed_by_rule(w):
    """Element [tap, ks, g, t, e] is B[k][n] of mma.m16n8k16's fragment for
    lane 4 g + t: k = 16 ks + 2 t + 8 (e // 2) + e % 2, n = g; zero past
    n_colors."""
    cin, n_colors = w.shape[2], w.shape[3]
    out = torch.zeros(9, cin // 16, 8, 4, 4, dtype=torch.bfloat16)
    for tap, ks, g, t, e in itertools.product(range(9), range(cin // 16), range(8), range(4), range(4)):
        if g < n_colors:
            out[tap, ks, g, t, e] = w[tap // 3, tap % 3, 16 * ks + 2 * t + 8 * (e // 2) + e % 2, g]
    return out


@pytest.mark.parametrize("cin,s", [(16, 2), (16, 3), (32, 2), (32, 3)])
def test_shuffle_conv_packer_follows_the_rule_element_by_element(cin, s):
    w = _bf16_weights(torch.Generator().manual_seed(cin + s), 3, 3, cin, s * s * cin)
    packed = pack_shuffle_conv_weights(w, s)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert torch.equal(packed, _shuffle_packed_by_rule(w, s))


@pytest.mark.parametrize("cin", [16, 48, 64])
@pytest.mark.parametrize("n_colors", [1, 3, 8])
def test_conv_last_packer_follows_the_rule_element_by_element(cin, n_colors):
    w = _bf16_weights(torch.Generator().manual_seed(cin + n_colors), 3, 3, cin, n_colors)
    packed = pack_conv_last_weights(w)
    assert packed.shape == (9, cin // 16, 8, 4, 4) and packed.is_contiguous()
    assert torch.equal(packed, _last_packed_by_rule(w))


@pytest.mark.parametrize("cin,s", [(16, 2), (16, 3), (48, 3), (64, 2), (64, 3)])
def test_unpack_inverts_pack(cin, s):
    gen = torch.Generator().manual_seed(cin * s)
    w = _bf16_weights(gen, 3, 3, cin, s * s * cin)
    assert torch.equal(unpack_shuffle_conv_weights(pack_shuffle_conv_weights(w, s), cin, s), w)
    w2 = _bf16_weights(gen, 3, 3, cin, 3)
    assert torch.equal(unpack_conv_last_weights(pack_conv_last_weights(w2), 3), w2)


def test_the_shuffle_columns_make_one_subpixel_plane_a_stretch():
    """At Cin 64, x2: packed column 64 p + c (p = 2 i + j) of chunk 0 is
    torch's channel 4 c + p, so the first 128 columns are planes (0, 0) and
    (0, 1)."""
    w = torch.arange(9 * 64 * 256, dtype=torch.float32).reshape(3, 3, 64, 256).to(torch.bfloat16)
    hwio = w.float()
    packed = pack_shuffle_conv_weights(w, 2).float()
    for n in (0, 1, 63, 64, 65, 127):
        p, c = divmod(n, 64)
        assert packed[0, 4, 0, n // 8, n % 8, 0] == hwio[1, 1, 0, 4 * c + p]


def test_packers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="Cout"):
        pack_shuffle_conv_weights(torch.zeros(3, 3, 16, 60), 2)
    with pytest.raises(ValueError, match="do not fit"):
        unpack_shuffle_conv_weights(torch.zeros(1, 9, 8, 16, 8, 8), 16, 3)
    with pytest.raises(ValueError, match="Cin 80"):
        pack_shuffle_conv_weights(torch.zeros(3, 3, 80, 320), 2)
    assert mma_geometry_error(64, 3) == ""
    assert "Cin 24" in mma_geometry_error(24, 3) and "Cin 80" in mma_geometry_error(80, 3)
    assert "n_colors 9" in mma_geometry_error(64, 9)


def _numpy_tail(rng, cin, convs, cout, shape):
    f = lambda *s: (rng.standard_normal(s, dtype=np.float32) * 0.1).astype(np.float32)  # noqa: E731
    ops = []
    for _ in range(convs):
        ops += [f(3, 3, cin, cout), f(cout)]
    ops += [f(3, 3, cin, 3), f(3)]
    # weights bf16-representable, so packed bf16 and f32 HWIO carry the same values
    ops = [np.asarray(torch.from_numpy(a).to(torch.bfloat16).float()) if a.ndim == 4 else a for a in ops]
    return rng.standard_normal(shape, dtype=np.float32), ops


@pytest.mark.parametrize("batch", [1, 2])
def test_x4_wrapper_on_packed_weights_matches_pallas(batch):
    x, ops = _numpy_tail(np.random.default_rng(batch), 16, 2, 64, (batch, 16, 16, 16))
    want = jax_fused_upsample_x4(jnp.asarray(x), *[jnp.asarray(a) for a in ops], interpret=True)
    assert want is not None
    engagement.reset()
    got = fused_upsample_x4(torch.from_numpy(x), *pack_tail([torch.from_numpy(a) for a in ops], 4))
    assert engagement.counters() == {}  # a CPU tensor takes the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("s", [2, 3])
def test_s_wrapper_on_packed_weights_matches_pallas(s):
    x, ops = _numpy_tail(np.random.default_rng(s), 16, 1, s * s * 16, (1, 16, 24, 16))
    want = jax_fused_upsample_s(*[jnp.asarray(a) for a in [x, *ops]], s=s, interpret=True)
    got = fused_upsample_s(torch.from_numpy(x), *pack_tail([torch.from_numpy(a) for a in ops], s), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=RTOL)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_plain_versions_take_packed_and_hwio_weights_alike(scale):
    gen = torch.Generator().manual_seed(scale)
    convs, s = (2, 2) if scale == 4 else (1, scale)
    ops = []
    for _ in range(convs):
        ops += [_bf16_weights(gen, 3, 3, 16, s * s * 16), torch.randn(s * s * 16, generator=gen)]
    ops += [_bf16_weights(gen, 3, 3, 16, 3), torch.randn(3, generator=gen)]
    x = torch.randn(1, 7, 5, 16, generator=gen).to(torch.bfloat16)
    if scale == 4:
        assert torch.equal(upsample_x4_plain(x, *pack_tail(ops, 4)), upsample_x4_plain(x, *ops))
    else:
        assert torch.equal(upsample_s_plain(x, *pack_tail(ops, s), s), upsample_s_plain(x, *ops, s))


@pytest.mark.parametrize("name,scale", [("swinir", 2), ("swinir", 3), ("swinir", 4), ("hat", 4)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tail_operands_pack_for_bf16_and_leave_f32_hwio(name, scale, dtype):
    kw = dict(scale=scale, embed_dim=32, depths=[1], num_heads=[2], window_size=8, device="cpu")
    module = (SwinIR if name == "swinir" else HAT).build(**kw).module
    tail = tail_operands(module, scale, dtype)
    convs = [module.upsample._modules[k] for k in (("0", "2") if scale == 4 else ("0",))]
    s = 2 if scale == 4 else scale
    for i, conv in enumerate(convs):
        hwio = prepare_conv3x3_weights(conv.weight, dtype)
        w, b = tail[2 * i], tail[2 * i + 1]
        assert torch.equal(b, conv.bias.detach().float())
        if dtype == torch.bfloat16:
            assert w.dim() == 6 and torch.equal(w, pack_shuffle_conv_weights(hwio, s))
        else:  # f32: the 3xTF32 conv's images (s^2 64 > 16); conv_last stays HWIO
            assert w.dim() == 5 and torch.equal(w, pack_conv3x3_f32_weights(hwio))
    last = prepare_conv3x3_weights(module.conv_last.weight, dtype)
    want_last = pack_conv_last_weights(last) if dtype == torch.bfloat16 else last
    assert torch.equal(tail[-2], want_last) and tail[-2].dtype == dtype
