"""The port's CUDA kernels against their plain versions, on the card.

Small and ragged shapes that the main path does not reach: maps that are
not tile multiples, batches of two, narrow channel counts. Every test skips
without a CUDA device. JAX is not needed, so on the card run

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

f32 kernels are held to max|k - p| <= 1e-4 max|p| + 1e-5 (TF32 off), bf16
kernels to a relative L2 error of 1e-2 against the plain version in f32
on the same bf16-rounded inputs, as chip_smoke.py does.
"""

import numpy as np
import pytest
import torch

from studiosr_tpu_torch import HAT, SwinIR, resolve_device
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.attn_bwd import attention_bwd, attention_bwd_plain, f32_mma_takes
from studiosr_tpu_torch.ops.cuda.conv3x3 import (
    cab_body_plain, conv3x3_plain, fused_cab_body, fused_conv3x3, pack_conv3x3_f32_weights, pack_conv3x3_weights,
)
from studiosr_tpu_torch.ops.cuda.mlp_block import fused_mlp_block, mlp_block_plain, pack_mlp_block
from studiosr_tpu_torch.ops.cuda.mlp_bwd import mlp_bwd, mlp_bwd_plain
from studiosr_tpu_torch.ops.cuda.ocab import (
    fused_ocab_block, ocab_mma_takes, ocab_plain, overlap_window, pack_ocab_block,
)
from studiosr_tpu_torch.ops.cuda.swin_block import fused_swin_block, swin_block_plain
from studiosr_tpu_torch.ops.cuda.upsampler import (
    fused_upsample_s, fused_upsample_x4, pack_tail, upsample_s_plain, upsample_x4_plain,
)
from studiosr_tpu_torch.ops.cuda.window_attention import (
    fused_window_attention_block, pack_window_attention, window_attention_plain, window_family,
)

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")


def _randn(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


def _assert_close(got, want, dtype):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-5
    else:
        assert float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)) <= 1e-2


def _block_operands(gen, c, heads, hidden, ws=8):
    n = ws * ws
    return [
        1 + _randn(gen, c, scale=0.1), _randn(gen, c, scale=0.1),
        _randn(gen, c, 3 * c, scale=c**-0.5), _randn(gen, 3 * c, scale=0.1),
        _randn(gen, c, c, scale=c**-0.5), _randn(gen, c, scale=0.1),
        _randn(gen, heads, n, n, scale=0.5),
        1 + _randn(gen, c, scale=0.1), _randn(gen, c, scale=0.1),
        _randn(gen, c, hidden, scale=c**-0.5), _randn(gen, hidden, scale=0.1),
        _randn(gen, hidden, c, scale=hidden**-0.5), _randn(gen, c, scale=0.1),
    ]


# B1 (bf16: ``csrc/swin_block_mma.cu``, f32: ``csrc/swin_block_f32.cu``): C 180 with
# 6 heads of 30 (the main path's width), C 32 with 2 of 16 (the trained
# fixtures), d 8 (C 16), d 12 with an odd count of 8-column output tiles (C
# 24), d 10 (C 60); batch 2, H != W, shift 0 and 4, odd window counts (the
# last window pair of the bf16 kernel half empty).
SWIN_BLOCK_CASES = [
    (32, 2, (2, 16, 24), 0), (32, 2, (2, 16, 24), 4), (180, 6, (1, 24, 16), 4), (180, 6, (2, 16, 24), 0),
    (180, 6, (1, 24, 24), 4), (16, 2, (1, 8, 24), 4), (24, 2, (2, 24, 8), 4), (60, 6, (1, 16, 16), 4),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,heads,shape,shift", SWIN_BLOCK_CASES)
def test_swin_block_kernel_matches_plain(dev, dtype, c, heads, shape, shift):
    gen = torch.Generator().manual_seed(c + shift)
    ops = _block_operands(gen, c, heads, 2 * c)
    x = _randn(gen, *shape, c).to(dev, dtype)
    # weights in the map's dtype, LayerNorm weights, biases and the rel-pos bias in f32
    ops = [t.to(dev, dtype if i in (2, 4, 9, 11) else torch.float32) for i, t in enumerate(ops)]
    engagement.reset()
    got = fused_swin_block(x, *ops, heads=heads, window_size=8, shift=shift)
    entry = "swin_block_mma_bf16" if dtype == torch.bfloat16 else "swin_block_mma_f32"  # f32: every case C <= 180
    assert engagement.entries() == {"fused_swin_block": {entry: 1}}
    want = swin_block_plain(x.float(), *[t.float() for t in ops], heads=heads, window_size=8, shift=shift)
    _assert_close(got, want, dtype)


# f32 B1 at geometries the 3xTF32 kernel declines keeps ``swin_block.cu``'s
# first design, by rule (``f32_mma_takes``): C above 180 (184, 8 heads of 23;
# 192, 6 of 32), head dim above 32 (96, 2 of 48), C not a multiple of 4 (90,
# 6 of 15); H != W, batch 2, shift 0 and 4.
SWIN_BLOCK_F32_FIRST_DESIGN_CASES = [
    (184, 8, (1, 16, 24), 0), (184, 8, (1, 24, 16), 4), (192, 6, (1, 16, 8), 4), (96, 2, (2, 16, 24), 4),
    (96, 2, (1, 24, 16), 0), (90, 6, (1, 16, 24), 4),
]


@pytest.mark.parametrize("c,heads,shape,shift", SWIN_BLOCK_F32_FIRST_DESIGN_CASES)
def test_swin_block_f32_first_design_matches_plain(dev, c, heads, shape, shift):
    gen = torch.Generator().manual_seed(c + shift)
    ops = [t.to(dev) for t in _block_operands(gen, c, heads, 2 * c)]
    x = _randn(gen, *shape, c).to(dev)
    engagement.reset()
    got = fused_swin_block(x, *ops, heads=heads, window_size=8, shift=shift)
    assert engagement.entries() == {"fused_swin_block": {"swin_block_f32": 1}}
    want = swin_block_plain(x, *ops, heads=heads, window_size=8, shift=shift)
    _assert_close(got, want, torch.float32)


@pytest.mark.parametrize("c,heads,shape,shift", [(180, 6, (1, 24, 16), 4), (32, 2, (2, 16, 24), 0)])
def test_swin_block_packed_weights_match_dense_bitwise(dev, c, heads, shape, shift):
    """The blob packed once (what serving holds) gives the same bits as
    dense weights packed per call, and the C library counts the blob's
    elements as the Python packer lays them out."""
    from studiosr_tpu_torch.ops.cuda import _build
    from studiosr_tpu_torch.ops.cuda.swin_block import _MMA_RESTYPES, _MMA_SIGNATURES, pack_swin_weights

    gen = torch.Generator().manual_seed(c)
    ops = [t.to(dev, torch.bfloat16 if i in (2, 4, 9, 11) else torch.float32)
           for i, t in enumerate(_block_operands(gen, c, heads, 2 * c))]
    x = _randn(gen, *shape, c).to(dev, torch.bfloat16)
    packed = pack_swin_weights(ops[2], ops[4], ops[6], ops[9], ops[11], heads)
    lib = _build.load("swin_block_mma", _MMA_SIGNATURES, _MMA_RESTYPES)
    assert lib.swin_block_mma_elements(c, heads, 2 * c) == packed.numel()
    dense = fused_swin_block(x, *ops, heads=heads, window_size=8, shift=shift)
    ops[2], ops[4], ops[6], ops[9], ops[11] = packed, None, None, None, None
    engagement.reset()
    got = fused_swin_block(x, *ops, heads=heads, window_size=8, shift=shift)
    assert engagement.entries() == {"fused_swin_block": {"swin_block_mma_bf16": 1}}
    assert torch.equal(got, dense)


@pytest.mark.parametrize("c,heads,why", [(240, 8, "C 240"), (96, 2, "head dim 48"), (90, 6, "C 90")])
def test_swin_block_bf16_raises_on_geometries_it_does_not_take(dev, c, heads, why):
    gen = torch.Generator().manual_seed(0)
    ops = [t.to(dev, torch.bfloat16 if i in (2, 4, 9, 11) else torch.float32)
           for i, t in enumerate(_block_operands(gen, c, heads, 2 * c))]
    engagement.reset()
    with pytest.raises(NotImplementedError, match=why):
        fused_swin_block(torch.zeros(1, 8, 8, c, device=dev, dtype=torch.bfloat16), *ops, heads=heads, window_size=8)
    assert engagement.counters() == {}


@pytest.mark.parametrize("c,heads,shape,shift", [(180, 6, (1, 24, 16), 4), (180, 6, (1, 24, 24), 0),
                                                  (32, 2, (2, 16, 24), 4), (32, 2, (2, 16, 24), 0)])
def test_swin_block_f32_packed_weights_match_dense_bitwise(dev, c, heads, shape, shift):
    """f32 B1 on the blob packed once (what serving holds) gives the bits of
    dense weights packed per call, through ``swin_block_mma_f32``, and the C
    library counts the blob's elements as the Python packer lays them out."""
    from studiosr_tpu_torch.ops.cuda import _build
    from studiosr_tpu_torch.ops.cuda.swin_block import _F32_RESTYPES, _F32_SIGNATURES, pack_swin_f32

    gen = torch.Generator().manual_seed(c + shift)
    ops = [t.to(dev) for t in _block_operands(gen, c, heads, 2 * c)]
    x = _randn(gen, *shape, c).to(dev)
    packed = pack_swin_f32(ops[2], ops[4], ops[6], ops[9], ops[11], heads)
    lib = _build.load("swin_block_f32", _F32_SIGNATURES, _F32_RESTYPES)
    assert lib.swin_block_mma_f32_elements(c, heads, 2 * c) == packed.numel()
    dense = fused_swin_block(x, *ops, heads=heads, window_size=8, shift=shift)
    ops[2], ops[4], ops[6], ops[9], ops[11] = packed, None, None, None, None
    engagement.reset()
    got = fused_swin_block(x, *ops, heads=heads, window_size=8, shift=shift)
    assert engagement.entries() == {"fused_swin_block": {"swin_block_mma_f32": 1}}
    assert torch.equal(got, dense)
    assert torch.equal(fused_swin_block(x, *ops, heads=heads, window_size=8, shift=shift), got)  # launch to launch


def test_f32_h100_entries_refuse_geometries_they_do_not_take(dev):
    """The 3xTF32 entries refuse what their routing rules send elsewhere:
    B1 at C above 180 or a head dim above 32 (no blob size), a window
    geometry off 8; the f32 conv at Cout <= 16, a residual with Cin != Cout
    and weights off 16 bytes; the wrappers never hand them such launches."""
    from studiosr_tpu_torch.ops.cuda import _build
    from studiosr_tpu_torch.ops.cuda.conv3x3 import _RESTYPES, _SIGNATURES
    from studiosr_tpu_torch.ops.cuda.swin_block import _F32_RESTYPES, _F32_SIGNATURES

    b1 = _build.load("swin_block_f32", _F32_SIGNATURES, _F32_RESTYPES)
    assert b1.swin_block_mma_f32_elements(184, 8, 368) == -1
    assert b1.swin_block_mma_f32_elements(96, 2, 192) == -1
    assert b1.swin_block_mma_f32_elements(90, 6, 180) == -1
    buf = torch.zeros(1 << 20, device=dev)
    p = buf.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    elements = b1.swin_block_mma_f32_elements(32, 2, 64)
    for h, w, shift in ((12, 16, 0), (16, 16, 8)):  # H not a multiple of 8; shift 8
        assert b1.swin_block_mma_f32(p, p, p, *[p] * 8, 1, h, w, 32, 2, 64, shift, elements, stream) != 0
    assert b1.swin_block_mma_f32(p, p, p, *[p] * 8, 1, 16, 16, 32, 2, 64, 0, elements - 1, stream) != 0
    conv = _build.load("conv3x3", _SIGNATURES, _RESTYPES)
    assert conv.conv3x3_mma_f32_elements(180, 180) == 2 * 6 * 9 * 2 * 3072
    assert conv.conv3x3_mma_f32(p, p, p, None, p, 1, 8, 8, 32, 16, 0, 0.0, 0, stream) != 0  # Cout 16
    assert conv.conv3x3_mma_f32(p, p, p, None, p, 1, 8, 8, 32, 48, 0, 0.0, 1, stream) != 0  # residual, Cin != Cout
    assert conv.conv3x3_mma_f32(p, p + 4, p, None, p, 1, 8, 8, 32, 48, 0, 0.0, 0, stream) != 0  # weights off 16 B
    torch.cuda.synchronize()


# B2 (bf16: ``csrc/conv3x3_mma.cuh``; f32: ``conv3x3_f32.cuh`` at Cout > 16,
# ``conv3x3.cuh`` below): Cin 180, 20 (a partial 16-channel stage) and 3;
# Cout 3, 12, 48, 70, 180 and 200 (two blocks of 192); maps that are not
# tile multiples, odd widths; each
# activation with the residual and the extra map; ``offset`` 1 starts x and
# extra one element into their storage, so no pixel row is 4-byte aligned.
CONV_CASES = [
    (8, 12, None, False, False, (2, 13, 21), 0), (20, 70, "relu", False, True, (2, 13, 21), 0),
    (12, 12, "lrelu0.2", True, True, (2, 13, 21), 0), (64, 3, None, False, False, (2, 13, 21), 0),
    (180, 180, "lrelu", False, True, (2, 13, 21), 0), (180, 180, None, True, True, (1, 19, 37), 0),
    (180, 180, "relu", True, True, (2, 9, 21), 0), (180, 180, "lrelu0.2", True, True, (1, 17, 33), 0),
    (20, 20, "lrelu", True, True, (2, 13, 21), 0), (20, 48, "relu", False, True, (1, 11, 19), 0),
    (180, 3, None, False, False, (1, 13, 27), 0), (180, 70, "lrelu0.1", False, True, (2, 9, 15), 0),
    (20, 180, None, False, True, (1, 8, 17), 0), (32, 200, "relu", False, True, (1, 9, 19), 0),
    (3, 180, None, False, False, (1, 10, 13), 0), (180, 180, "relu", True, True, (1, 7, 25), 1),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,cout,activation,residual,with_extra,shape,offset", CONV_CASES)
def test_conv3x3_kernel_matches_plain(dev, dtype, cin, cout, activation, residual, with_extra, shape, offset):
    gen = torch.Generator().manual_seed(cin * cout + shape[2])

    def mapped(c):
        flat = _randn(gen, offset + shape[0] * shape[1] * shape[2] * c).to(dev, dtype)
        return flat[offset:].view(*shape, c)

    x = mapped(cin)
    w = _randn(gen, 3, 3, cin, cout, scale=(9 * cin) ** -0.5).to(dev, dtype)
    b = _randn(gen, cout, scale=0.1).to(dev)
    extra = mapped(cout) if with_extra else None
    engagement.reset()
    got = fused_conv3x3(x, w, b, activation, residual, extra)
    entry = "conv3x3_mma_bf16" if dtype == torch.bfloat16 else "conv3x3_mma_f32" if cout > 16 else "conv3x3_f32"
    assert engagement.entries() == {"fused_conv3x3": {entry: 1}}
    want = conv3x3_plain(x.float(), w.float(), b, activation, residual, None if extra is None else extra.float())
    _assert_close(got, want, dtype)
    if dtype == torch.bfloat16:  # the serving layout: packed once, the same bits
        assert torch.equal(fused_conv3x3(x, pack_conv3x3_weights(w), b, activation, residual, extra), got)
    elif cout > 16:
        assert torch.equal(fused_conv3x3(x, pack_conv3x3_f32_weights(w), b, activation, residual, extra), got)


# B3 and B4 (bf16: the kernels of ``csrc/upsampler.cu`` written for the H100,
# f32: conv3x3.cuh's passes): Cin 16, 32, 48 and the models' 64; maps that
# no 16 x 16 conv tile or 8 x 32 conv_last tile divides, H != W, batch 2,
# and HAT's 256 x 256. In bf16 the weights packed once (``pack_tail``, the
# serving layout) give the bits of HWIO weights packed per call.
UPSAMPLE_X4_SHAPES = [(1, 12, 10, 16), (2, 8, 8, 64), (2, 37, 53, 64), (1, 20, 9, 32), (1, 256, 256, 64)]
UPSAMPLE_S_CASES = [
    (2, (1, 12, 10, 16)), (3, (1, 12, 10, 16)), (2, (2, 37, 53, 64)), (3, (2, 37, 53, 64)), (3, (1, 8, 8, 64)),
    (2, (2, 9, 20, 48)), (3, (1, 20, 9, 32)), (2, (1, 256, 256, 64)), (3, (1, 256, 256, 64)),
]


def _tail_operands(gen, cin, cout, dev, dtype, convs=1):
    ops = []
    for _ in range(convs):
        ops += [_randn(gen, 3, 3, cin, cout, scale=(9 * cin) ** -0.5), _randn(gen, cout, scale=0.1)]
    ops += [_randn(gen, 3, 3, cin, 3, scale=(9 * cin) ** -0.5), _randn(gen, 3, scale=0.1)]
    return [t.to(dev, dtype if t.dim() == 4 else torch.float32) for t in ops]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", UPSAMPLE_X4_SHAPES)
def test_upsample_x4_kernel_matches_plain(dev, dtype, shape):
    gen = torch.Generator().manual_seed(shape[-1] + shape[1])
    cin = shape[-1]
    x = _randn(gen, *shape).to(dev, dtype)
    ops = _tail_operands(gen, cin, 4 * cin, dev, dtype, convs=2)
    engagement.reset()
    got = fused_upsample_x4(x, *ops)
    entry = "upsample_x4_mma_bf16" if dtype == torch.bfloat16 else "upsample_x4_mma_f32"  # f32: 4 Cin > 16
    assert engagement.entries() == {"fused_upsample_x4": {entry: 1}}
    assert tuple(got.shape) == (shape[0], 4 * shape[1], 4 * shape[2], 3)
    want = upsample_x4_plain(x.float(), *[t.float() for t in ops])
    _assert_close(got, want, dtype)
    assert torch.equal(fused_upsample_x4(x, *pack_tail(ops, 4)), got)  # the serving layout: the same bits


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,shape", UPSAMPLE_S_CASES)
def test_upsample_s_kernel_matches_plain(dev, dtype, s, shape):
    """B4: ragged maps (not tile multiples), batch 2, narrow Cin."""
    gen = torch.Generator().manual_seed(s * shape[-1] + shape[1])
    cin = shape[-1]
    x = _randn(gen, *shape).to(dev, dtype)
    ops = _tail_operands(gen, cin, s * s * cin, dev, dtype)
    engagement.reset()
    got = fused_upsample_s(x, *ops, s)
    assert engagement.counters() == {"fused_upsample_s": 1}
    entry = "upsample_s_mma_bf16" if dtype == torch.bfloat16 else "upsample_s_mma_f32"  # f32: s^2 Cin > 16
    assert engagement.entries() == {"fused_upsample_s": {entry: 1}}
    assert tuple(got.shape) == (shape[0], s * shape[1], s * shape[2], 3)
    want = upsample_s_plain(x.float(), *[t.float() for t in ops], s)
    _assert_close(got, want, dtype)
    assert torch.equal(fused_upsample_s(x, *pack_tail(ops, s), s), got)  # the serving layout: the same bits


@pytest.mark.parametrize("scale,shape", [(4, (1, 12, 10, 4)), (2, (2, 9, 20, 4)), (3, (1, 20, 9, 1))])
def test_upsample_f32_narrow_tails_keep_the_fma_kernel(dev, scale, shape):
    """f32 tails with s^2 Cin <= 16 run every pass on conv3x3.cuh's FMA
    kernel (``upsample_x4_f32``, ``upsample_s_f32``), by rule; ``pack_tail``
    leaves their weights HWIO."""
    gen = torch.Generator().manual_seed(scale * shape[-1] + shape[1])
    cin, s = shape[-1], 2 if scale == 4 else scale
    x = _randn(gen, *shape).to(dev)
    ops = _tail_operands(gen, cin, s * s * cin, dev, torch.float32, convs=2 if scale == 4 else 1)
    assert all(a is b for a, b in zip(pack_tail(ops, scale), ops))
    engagement.reset()
    got = fused_upsample_x4(x, *ops) if scale == 4 else fused_upsample_s(x, *ops, scale)
    name = "fused_upsample_x4" if scale == 4 else "fused_upsample_s"
    assert engagement.entries() == {name: {name[6:] + "_f32": 1}}
    assert tuple(got.shape) == (shape[0], scale * shape[1], scale * shape[2], 3)
    want = upsample_x4_plain(x, *ops) if scale == 4 else upsample_s_plain(x, *ops, scale)
    _assert_close(got, want, torch.float32)


def test_upsample_bf16_raises_on_geometries_it_does_not_take(dev):
    x = torch.zeros(1, 8, 8, 24, device=dev, dtype=torch.bfloat16)
    ops = _tail_operands(torch.Generator().manual_seed(0), 24, 96, dev, torch.bfloat16, convs=2)
    with pytest.raises(ValueError, match="Cin 24"):
        fused_upsample_x4(x, *ops)
    x = torch.zeros(1, 8, 8, 16, device=dev, dtype=torch.bfloat16)
    ops = _tail_operands(torch.Generator().manual_seed(0), 16, 64, dev, torch.bfloat16)
    wide = torch.zeros(3, 3, 16, 9, device=dev, dtype=torch.bfloat16), torch.zeros(9, device=dev)
    with pytest.raises(ValueError, match="n_colors 9"):
        fused_upsample_s(x, *ops[:2], *wide, 2)


# Every bf16 tail launch of a served model (SwinIR x2 / x3 / x4, HAT x2 / x3
# / x4, SwinFIR x4) goes through the kernels written for the H100, one launch
# a forward, on the weights serving packed at load time.
SERVED_TAILS = [("swinir", 2), ("swinir", 3), ("swinir", 4), ("hat", 2), ("hat", 3), ("hat", 4), ("swinfir", 4)]


@pytest.mark.parametrize("name,scale", SERVED_TAILS)
def test_served_bf16_tails_take_the_h100_kernels(dev, name, scale):
    from studiosr_tpu_torch import SwinFIR

    kw = dict(scale=scale, embed_dim=32, depths=[2, 2], num_heads=[2, 2], window_size=8, device=dev)
    model = {"swinir": SwinIR, "hat": HAT, "swinfir": SwinFIR}[name].build(**kw).half().enable_fused(True)
    images = [np.random.default_rng(i).integers(0, 256, (20, 28, 3), dtype=np.uint8) for i in range(2)]
    engagement.reset()
    outs = [model.inference(im) for im in images]
    tail, entry = ("fused_upsample_x4", "upsample_x4_mma_bf16") if scale == 4 else (
        "fused_upsample_s", "upsample_s_mma_bf16")
    assert engagement.counters()[tail] == 2
    assert engagement.entries()[tail] == {entry: 2}
    assert all(out.shape == (20 * scale, 28 * scale, 3) for out in outs)


@pytest.mark.parametrize("scale", [2, 3])
def test_small_swinir_x2_x3_fused_matches_plain_on_the_card(dev, scale):
    model = SwinIR.build(scale=scale, embed_dim=16, depths=[2, 2], num_heads=[2, 2], window_size=8, mlp_ratio=2.0,
                         device=dev)
    images = [np.random.default_rng(i).integers(0, 256, (20, 28, 3), dtype=np.uint8) for i in range(2)]
    plain = model.enable_fused(False).inference_batch(images)
    engagement.reset()
    fused = model.enable_fused(True).inference_batch(images)
    assert engagement.counters() == {"fused_swin_block": 4, "fused_conv3x3": 3, "fused_upsample_s": 1}
    for got, want in zip(fused, plain):
        diff = np.abs(got.astype(int) - want.astype(int))
        assert got.shape == (20 * scale, 28 * scale, 3) and diff.max() <= 1 and (diff > 0).mean() < 0.01


# Training kernels: ragged maps (several window rows, not square), batch 2,
# one drop-path scale 0, the full width and narrow ones. The last map has
# 544 windows, more than the 256 blocks of B8's per-window pass: each block
# then takes two or three windows and sums their bias-gradient partials.
TRAIN_CASES = [
    (32, 2, (2, 16, 24), 0), (32, 2, (2, 24, 16), 4), (180, 6, (2, 16, 24), 4), (16, 2, (2, 8, 16), 4),
    (32, 2, (2, 128, 136), 4),
]


def _train_operands(gen, c, heads, dev, dtype):
    """Attention operands with weights in ``dtype`` and the rest f32 (the
    wrappers take either), plus drop-path scales (0, 1.25)."""
    ops = _block_operands(gen, c, heads, 2 * c)[:7]
    ops = [t.to(dev, dtype if i in (2, 4) else torch.float32) for i, t in enumerate(ops)]
    return ops, torch.tensor([0.0, 1.25], device=dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,heads,shape,shift", TRAIN_CASES)
def test_window_attention_kernel_matches_plain(dev, dtype, c, heads, shape, shift):
    gen = torch.Generator().manual_seed(c + shift + 1)
    ops, dp = _train_operands(gen, c, heads, dev, dtype)
    x = _randn(gen, *shape, c).to(dev, dtype)
    kw = dict(heads=heads, window_size=8, shift=shift, drop_path=dp)
    got = fused_window_attention_block(x, *ops, **kw)
    want = window_attention_plain(x.float(), *[t.float() for t in ops], **kw)
    _assert_close(got, want, dtype)
    assert torch.equal(got[0], x[0])  # a dropped sample passes through exactly


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,rows_per_sample", [(32, 384), (180, 192), (16, 100)])
def test_mlp_block_kernel_matches_plain(dev, dtype, c, rows_per_sample):
    gen = torch.Generator().manual_seed(c + 2)
    ops = _block_operands(gen, c, 2, 2 * c)[7:]
    ops = [t.to(dev, dtype if i in (2, 4) else torch.float32) for i, t in enumerate(ops)]
    x = _randn(gen, 2 * rows_per_sample, c).to(dev, dtype)
    dp = torch.tensor([1.25, 0.0], device=dev)
    got = fused_mlp_block(x, *ops, drop_path=dp, rows_per_sample=rows_per_sample)
    want = mlp_block_plain(x.float(), *[t.float() for t in ops], drop_path=dp, rows_per_sample=rows_per_sample)
    _assert_close(got, want, dtype)
    assert torch.equal(got[rows_per_sample:], x[rows_per_sample:])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,heads,shape,shift", TRAIN_CASES)
def test_attention_bwd_kernel_matches_plain(dev, dtype, c, heads, shape, shift):
    gen = torch.Generator().manual_seed(c + shift + 3)
    ops, dp = _train_operands(gen, c, heads, dev, dtype)
    x = _randn(gen, *shape, c).to(dev, dtype)
    g = _randn(gen, *shape, c).to(dev, dtype)
    kw = dict(heads=heads, window_size=8, shift=shift, drop_path=dp)
    engagement.reset()
    got = attention_bwd(x, g, *ops, **kw)
    entry = "attn_bwd_mma_bf16" if dtype == torch.bfloat16 else "attn_bwd_mma_f32"
    assert engagement.entries() == {"attention_bwd": {entry: 1}}
    want = attention_bwd_plain(x.float(), g.float(), *[t.float() for t in ops], **kw)
    for a, e in zip(got, want):
        _assert_close(a, e, dtype)
    assert torch.equal(got[0][0], g[0])  # a dropped sample: dx = g


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,rows,rows_per_sample", [(32, 768, 384), (180, 384, 192), (16, 200, 100), (24, 300, 0)])
def test_mlp_bwd_kernel_matches_plain(dev, dtype, c, rows, rows_per_sample):
    gen = torch.Generator().manual_seed(c + 4)
    ops = _block_operands(gen, c, 2, 2 * c)[7:12]
    ops = [t.to(dev, dtype if i in (2, 4) else torch.float32) for i, t in enumerate(ops)]
    x = _randn(gen, rows, c).to(dev, dtype)
    g = _randn(gen, rows, c).to(dev, dtype)
    dp = torch.tensor([1.25, 0.0], device=dev) if rows_per_sample else None
    kw = dict(drop_path=dp, rows_per_sample=rows_per_sample)
    got = mlp_bwd(x, g, *ops, **kw)
    want = mlp_bwd_plain(x.float(), g.float(), *[t.float() for t in ops], **kw)
    for a, e in zip(got, want):
        _assert_close(a, e, dtype)
    if dp is not None:
        assert torch.equal(got[0][rows_per_sample:], g[rows_per_sample:])


def test_training_kernels_are_deterministic(dev):
    gen = torch.Generator().manual_seed(5)
    ops, dp = _train_operands(gen, 180, 6, dev, torch.bfloat16)
    x = _randn(gen, 2, 16, 24, 180).to(dev, torch.bfloat16)
    g = _randn(gen, 2, 16, 24, 180).to(dev, torch.bfloat16)
    kw = dict(heads=6, window_size=8, shift=4, drop_path=dp)
    for a, b in zip(attention_bwd(x, g, *ops, **kw), attention_bwd(x, g, *ops, **kw)):
        assert torch.equal(a, b)


# B8 and B7 in f32 on the kernels written for the H100 (attn_bwd_mma_f32,
# mlp_bwd_mma_f32: 3xTF32 products): SwinFIR's C 180 / 6 heads, MaxSR's 128 /
# 4 and the fixtures' 32 / 2 at windows 8, 5 and 2 with and without the
# shift and drop-path scales, batch 2; the MLP at hidden 360, 512, 64 and 37
# (not a multiple of 4): every output against the plain version at the f32
# rule, two launches the same bits, each launch through its entry.
F32_ATTN_CASES = [(c, heads, ws, shift, drop) for c, heads in ((180, 6), (128, 4), (32, 2))
                  for ws, shift, drop in ((8, 4, True), (8, 0, False), (5, 2, True), (2, 1, False))]
F32_MLP_CASES = [(180, 360, 8192, 4096), (128, 512, 1000, 500), (32, 64, 768, 0), (20, 37, 300, 150)]


@pytest.mark.parametrize("c,heads,ws,shift,drop", F32_ATTN_CASES)
def test_attention_bwd_f32_kernel_matches_plain(dev, c, heads, ws, shift, drop):
    gen = torch.Generator().manual_seed(c + ws + shift)
    ops = [t.to(dev) for t in _block_operands(gen, c, heads, 2 * c, ws=ws)[:7]]
    x = _randn(gen, 2, 2 * ws, 3 * ws, c).to(dev)
    g = _randn(gen, 2, 2 * ws, 3 * ws, c, scale=1e-3).to(dev)
    kw = dict(heads=heads, window_size=ws, shift=shift,
              drop_path=torch.tensor([0.0, 1.25], device=dev) if drop else None)
    engagement.reset()
    grads = attention_bwd(x, g, *ops, **kw)
    again = attention_bwd(x, g, *ops, **kw)
    assert engagement.entries() == {"attention_bwd": {"attn_bwd_mma_f32": 2}}
    for a, e in zip(grads, attention_bwd_plain(x, g, *ops, **kw)):
        assert a.shape == e.shape
        _assert_close(a, e, torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # no atomics: bitwise repeatable
    if drop:
        assert torch.equal(grads[0][0], g[0])  # a dropped sample: dx = g


@pytest.mark.parametrize("c,hidden,rows,rows_per_sample", F32_MLP_CASES)
def test_mlp_bwd_f32_kernel_matches_plain(dev, c, hidden, rows, rows_per_sample):
    gen = torch.Generator().manual_seed(c + hidden)
    ops = [t.to(dev) for t in _block_operands(gen, c, 2, hidden)[7:12]]
    x = _randn(gen, rows, c).to(dev)
    g = _randn(gen, rows, c, scale=1e-3).to(dev)
    dp = torch.tensor([1.25, 0.0], device=dev) if rows_per_sample else None
    kw = dict(drop_path=dp, rows_per_sample=rows_per_sample)
    engagement.reset()
    got = mlp_bwd(x, g, *ops, **kw)
    again = mlp_bwd(x, g, *ops, **kw)
    assert engagement.entries() == {"mlp_bwd": {"mlp_bwd_mma_f32": 2}}
    for a, e in zip(got, mlp_bwd_plain(x, g, *ops, **kw)):
        _assert_close(a, e, torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if dp is not None:
        assert torch.equal(got[0][rows_per_sample:], g[rows_per_sample:])


def test_f32_backward_entries_refuse_geometries_they_do_not_take(dev):
    """The f32 entries answer -1 for a packed layout they do not take and
    refuse a launch at such a geometry before they read an operand (a
    wrapper raises on a status that is not 0)."""
    from studiosr_tpu_torch.ops.cuda import _build
    from studiosr_tpu_torch.ops.cuda import attn_bwd as ab, mlp_bwd as mb
    from studiosr_tpu_torch.ops.cuda._launch import STREAM, call

    alib = _build.load("attn_bwd_f32", ab._SIGNATURES_F32, ab._RESTYPES_F32)
    mlib = _build.load("mlp_bwd_f32", mb._SIGNATURES_F32, mb._RESTYPES_F32)
    assert call(dev, alib.attn_bwd_mma_f32_pack_elems, 180, 6) == ab._f32_pack_index(180, 6).size
    assert call(dev, mlib.mlp_bwd_mma_f32_pack_elems, 180, 360) == mb._f32_pack_index(180, 360).size
    assert call(dev, alib.attn_bwd_mma_f32_pack_elems, 90, 6) == -1  # C not a multiple of 4
    assert call(dev, alib.attn_bwd_mma_f32_pack_elems, 96, 2) == -1  # head dim 48
    assert call(dev, mlib.mlp_bwd_mma_f32_pack_elems, 260, 520) == -1  # C above 256
    nulls = [None] * 8
    for ws, c, heads in ((9, 180, 6), (8, 90, 6), (8, 96, 2)):  # window 9, C 90, head dim 48
        assert call(dev, alib.attn_bwd_mma_f32, None, None, None, 2, 8 * ws, 8 * ws, c, heads, ws, 0, *nulls, 0,
                    *nulls[:6], None, 0, STREAM) != 0
    assert call(dev, mlib.mlp_bwd_mma_f32, None, None, None, 64, 90, 180, *nulls[:6], 0, None, 0, *nulls[:5], None,
                0, STREAM) != 0


# B5 and B6 in f32 on the kernels written for the H100 (window_attention_mma_f32,
# mlp_block_mma_f32, mlp_block_extra_mma_f32: 3xTF32 products): SwinFIR's C
# 180 / 6 heads, MaxSR's 128 / 4 and the fixtures' 32 / 2 at windows 8, 5 and
# 2 with and without the shift and drop-path scales, batch 2; the MLP at
# hidden 360, 512, 64 and 37, C 256, ragged row counts, with drop-path and
# with HAT's CAB join: the output against the plain version at the f32
# rule, two launches the same bits, each launch through its entry.
F32_FWD_MLP_CASES = [(180, 360, 8192, 4096, "drop_path"), (128, 512, 1000, 500, "drop_path"), (32, 64, 767, 0, None),
                     (20, 37, 300, 150, "drop_path"), (256, 512, 640, 0, None), (180, 360, 777, 0, "extra"),
                     (128, 512, 4096, 0, "extra")]


@pytest.mark.parametrize("c,heads,ws,shift,drop", F32_ATTN_CASES)
def test_window_attention_f32_kernel_matches_plain(dev, c, heads, ws, shift, drop):
    gen = torch.Generator().manual_seed(c + ws + shift + 7)
    ops = [t.to(dev) for t in _block_operands(gen, c, heads, 2 * c, ws=ws)[:7]]
    x = _randn(gen, 2, 2 * ws, 3 * ws, c).to(dev)
    kw = dict(heads=heads, window_size=ws, shift=shift,
              drop_path=torch.tensor([0.0, 1.25], device=dev) if drop else None)
    engagement.reset()
    got = fused_window_attention_block(x, *ops, **kw)
    again = fused_window_attention_block(x, *ops, **kw)
    assert engagement.entries() == {"fused_window_attention_block": {"window_attention_mma_f32": 2}}
    _assert_close(got, window_attention_plain(x, *ops, **kw), torch.float32)
    assert torch.equal(got, again)  # no atomics: bitwise repeatable
    if drop:
        assert torch.equal(got[0], x[0])  # a dropped sample passes through exactly


@pytest.mark.parametrize("c,hidden,rows,rows_per_sample,mode", F32_FWD_MLP_CASES)
def test_mlp_block_f32_kernel_matches_plain(dev, c, hidden, rows, rows_per_sample, mode):
    gen = torch.Generator().manual_seed(c + hidden + rows)
    ops = [t.to(dev) for t in _block_operands(gen, c, 2, hidden)[7:]]
    x = _randn(gen, rows, c).to(dev)
    kw, name, entry = {}, "fused_mlp_block", "mlp_block_mma_f32"
    if mode == "drop_path":
        kw = dict(drop_path=torch.tensor([1.25, 0.0], device=dev), rows_per_sample=rows_per_sample)
    elif mode == "extra":
        kw = dict(extra=_randn(gen, rows, c).to(dev), extra_scale=_randn(gen, c, scale=0.5).to(dev))
        name, entry = "fused_mlp_block_extra", "mlp_block_extra_mma_f32"
    engagement.reset()
    got = fused_mlp_block(x, *ops, **kw)
    again = fused_mlp_block(x, *ops, **kw)
    assert engagement.entries() == {name: {entry: 2}}
    _assert_close(got, mlp_block_plain(x, *ops, **kw), torch.float32)
    assert torch.equal(got, again)
    if mode == "drop_path":
        assert torch.equal(got[rows_per_sample:], x[rows_per_sample:])


def test_f32_forward_entries_refuse_geometries_they_do_not_take(dev):
    """The f32 forward entries answer -1 for a packed layout they do not take
    and refuse a launch at such a geometry before they read an operand (a
    wrapper raises on a status that is not 0)."""
    from studiosr_tpu_torch.ops.cuda import _build
    from studiosr_tpu_torch.ops.cuda import mlp_block as mbk, window_attention as wa
    from studiosr_tpu_torch.ops.cuda._launch import STREAM, call

    alib = _build.load("window_attention_f32", wa._SIGNATURES_F32, wa._RESTYPES_F32)
    mlib = _build.load("mlp_block_f32", mbk._SIGNATURES_F32, mbk._RESTYPES_F32)
    assert call(dev, alib.window_attention_mma_f32_pack_elems, 180, 6) == wa._f32_fwd_pack_index(180, 6).size
    assert call(dev, mlib.mlp_block_mma_f32_pack_elems, 180, 360) == mbk._f32_pack_index(180, 360).size
    assert call(dev, alib.window_attention_mma_f32_pack_elems, 90, 6) == -1  # C not a multiple of 4
    assert call(dev, alib.window_attention_mma_f32_pack_elems, 96, 2) == -1  # head dim 48
    assert call(dev, mlib.mlp_block_mma_f32_pack_elems, 260, 520) == -1  # C above 256
    assert call(dev, mlib.mlp_block_mma_f32_pack_elems, 64, 576) == -1  # hidden above 512
    nulls = [None] * 9
    for ws, c, heads in ((9, 180, 6), (8, 90, 6), (8, 96, 2)):  # window 9, C 90, head dim 48
        assert call(dev, alib.window_attention_mma_f32, None, None, 2, 8 * ws, 8 * ws, c, heads, ws, 0, *nulls, 0,
                    None, 0, STREAM) != 0
    assert call(dev, mlib.mlp_block_mma_f32, None, None, 64, 90, 180, *nulls[:7], 0, None, 0, None, 0, STREAM) != 0
    assert call(dev, mlib.mlp_block_extra_mma_f32, None, None, 64, 64, 576, *nulls, 0, None, 0, STREAM) != 0


def test_wrappers_raise_on_operands_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 8, 8, 4, device=dev)
    w, b = torch.zeros(3, 3, 4, 4, device=dev), torch.zeros(4, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv3x3(x.transpose(1, 2), w, b)
    with pytest.raises(TypeError):
        fused_conv3x3(x.half(), w.half(), b)
    with pytest.raises(TypeError):
        fused_conv3x3(x, w.bfloat16(), b)
    gen = torch.Generator().manual_seed(0)
    ops = [t.to(dev) for t in _block_operands(gen, 32, 2, 64, ws=4)]
    with pytest.raises(NotImplementedError, match="window size"):
        fused_swin_block(torch.zeros(1, 8, 8, 32, device=dev), *ops, heads=2, window_size=4)


def test_small_swinir_fused_matches_plain_on_the_card(dev):
    model = SwinIR.build(scale=4, embed_dim=16, depths=[2, 2], num_heads=[2, 2], window_size=8, mlp_ratio=2.0,
                         device=dev)
    images = [np.random.default_rng(i).integers(0, 256, (20, 28, 3), dtype=np.uint8) for i in range(2)]
    plain = model.enable_fused(False).inference_batch(images)
    engagement.reset()
    fused = model.enable_fused(True).inference_batch(images)
    assert engagement.counters() == {"fused_swin_block": 4, "fused_conv3x3": 3, "fused_upsample_x4": 1}
    for got, want in zip(fused, plain):
        diff = np.abs(got.astype(int) - want.astype(int))
        assert got.shape == (80, 112, 3) and diff.max() <= 1 and (diff > 0).mean() < 0.01


# HAT serving kernels (B11, B5 at window 16, B6 with extra, B10): maps that
# are not tile multiples, batch 2, C 32 with 2 heads and the full width,
# and maps of exactly one window, where every OCAB key window reaches
# outside the image.


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,cm,shape", [(32, 10, (2, 13, 21)), (180, 60, (1, 24, 40)), (16, 5, (1, 16, 16))])
def test_cab_body_kernel_matches_plain(dev, dtype, c, cm, shape):
    gen = torch.Generator().manual_seed(c + cm)
    x = _randn(gen, *shape, c).to(dev, dtype)
    ops = [1 + _randn(gen, c, scale=0.1), _randn(gen, c, scale=0.1), _randn(gen, 3, 3, c, cm, scale=(9 * c) ** -0.5),
           _randn(gen, cm, scale=0.1), _randn(gen, 3, 3, cm, c, scale=(9 * cm) ** -0.5), _randn(gen, c, scale=0.1)]
    ops = [t.to(dev, dtype if t.dim() == 4 else torch.float32) for t in ops]
    got = fused_cab_body(x, *ops)
    want = cab_body_plain(x.float(), *[t.float() for t in ops])
    for a, e in zip(got, want):
        _assert_close(a, e, dtype)
    again = fused_cab_body(x, *ops)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])  # no atomics: bitwise repeatable


def _cab_operands(gen, c, cm, dev, dtype):
    ops = [1 + _randn(gen, c, scale=0.1), _randn(gen, c, scale=0.1), _randn(gen, 3, 3, c, cm, scale=(9 * c) ** -0.5),
           _randn(gen, cm, scale=0.1), _randn(gen, 3, 3, cm, c, scale=(9 * cm) ** -0.5), _randn(gen, c, scale=0.1)]
    return [t.to(dev, dtype if t.dim() == 4 else torch.float32) for t in ops]


# B11 in bf16 on the kernel written for the H100 (``csrc/cab_mma.cu``): HAT
# serving's 256 x 256 x 180 (Cm 60), a ragged batch of two, the trained
# fixtures' narrow widths (C 24, Cm 8), C 120 (two K chunks), odd Cm and a
# map narrower than a tile; res_scale 1 and not.
H100_CAB_CASES = [((1, 256, 256, 180), 60, 1.0), ((2, 37, 53, 180), 60, 0.5), ((1, 20, 28, 24), 8, 1.0),
                  ((2, 13, 21, 32), 10, 1.0), ((1, 16, 40, 120), 40, 2.0), ((1, 5, 7, 16), 5, 1.0)]


@pytest.mark.parametrize("shape,cm,res_scale", H100_CAB_CASES)
def test_cab_body_h100_kernel_matches_plain(dev, shape, cm, res_scale):
    """Against the plain version in f32; the weights packed at load time give
    the bits of HWIO weights; two launches the same bits (no atomic sums)."""
    from studiosr_tpu_torch.ops.cuda.conv3x3 import pack_cab_convs

    c = shape[-1]
    gen = torch.Generator().manual_seed(sum(shape) + cm)
    x = _randn(gen, *shape).to(dev, torch.bfloat16)
    ops = _cab_operands(gen, c, cm, dev, torch.bfloat16)
    w1, w2 = pack_cab_convs(ops[2], ops[4])
    engagement.reset()
    got = fused_cab_body(x, *ops, res_scale=res_scale)
    again = fused_cab_body(x, *ops, res_scale=res_scale)
    packed = fused_cab_body(x, ops[0], ops[1], w1, ops[3], w2, ops[5], res_scale=res_scale)
    assert engagement.entries() == {"fused_cab_body": {"cab_body_mma_bf16": 3}}
    want = cab_body_plain(x.float(), *[t.float() for t in ops], res_scale=res_scale)
    for a, e in zip(got, want):
        assert a.shape == e.shape
        _assert_close(a, e, torch.bfloat16)
    assert all(torch.equal(a, b) and torch.equal(a, p) for a, b, p in zip(got, again, packed))


def test_cab_body_routes_by_dtype_and_geometry(dev):
    """f32, and bf16 outside the H100 kernel's geometry (C 200, Cm 72, odd
    C), take cab_body.cu; res_scale reaches both routes."""
    gen = torch.Generator().manual_seed(5)
    engagement.reset()
    for dtype, c, cm in ((torch.float32, 32, 10), (torch.bfloat16, 200, 20), (torch.bfloat16, 32, 72),
                         (torch.bfloat16, 33, 10)):
        x = _randn(gen, 1, 9, 11, c).to(dev, dtype)
        ops = _cab_operands(gen, c, cm, dev, dtype)
        got = fused_cab_body(x, *ops, res_scale=0.25)
        want = cab_body_plain(x.float(), *[t.float() for t in ops], res_scale=0.25)
        for a, e in zip(got, want):
            _assert_close(a, e, dtype)
    assert engagement.entries() == {"fused_cab_body": {"cab_body_f32": 1, "cab_body_bf16": 3}}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "c,heads,shape,shift",
    [(32, 2, (2, 32, 48), 8), (32, 2, (1, 16, 16), 0), (180, 6, (1, 32, 32), 8), (16, 2, (2, 16, 32), 8)],
)
def test_window_attention16_kernel_matches_plain(dev, dtype, c, heads, shape, shift):
    gen = torch.Generator().manual_seed(c + shift + 16)
    ops = _block_operands(gen, c, heads, 2 * c, ws=16)[:7]
    ops = [t.to(dev, dtype if i in (2, 4) else torch.float32) for i, t in enumerate(ops)]
    x = _randn(gen, *shape, c).to(dev, dtype)
    dp = torch.tensor([1.25, 0.0][: shape[0]], device=dev)
    kw = dict(heads=heads, window_size=16, shift=shift, drop_path=dp)
    engagement.reset()
    got = fused_window_attention_block(x, *ops, **kw)
    assert engagement.counters() == {"fused_window_attention_block_ws16": 1}
    want = window_attention_plain(x.float(), *[t.float() for t in ops], **kw)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,rows", [(32, 300), (180, 256), (16, 100)])
def test_mlp_block_extra_kernel_matches_plain(dev, dtype, c, rows):
    gen = torch.Generator().manual_seed(c + rows)
    ops = _block_operands(gen, c, 2, 2 * c)[7:]
    ops = [t.to(dev, dtype if i in (2, 4) else torch.float32) for i, t in enumerate(ops)]
    x = _randn(gen, rows, c).to(dev, dtype)
    extra = _randn(gen, rows, c).to(dev, dtype)
    escale = _randn(gen, c, scale=0.5).to(dev)
    engagement.reset()
    got = fused_mlp_block(x, *ops, extra=extra, extra_scale=escale)
    assert engagement.counters() == {"fused_mlp_block_extra": 1}
    want = mlp_block_plain(x.float(), *[t.float() for t in ops], extra=extra.float(), extra_scale=escale)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "c,heads,shape,ws,overlap",
    [
        (32, 2, (2, 32, 48), 16, 0.5), (32, 2, (1, 16, 16), 16, 0.5), (180, 6, (1, 32, 32), 16, 0.5),
        (24, 3, (2, 16, 24), 8, 1.0), (24, 3, (1, 8, 8), 8, 0.5),
    ],
)
def test_ocab_kernel_matches_plain(dev, dtype, c, heads, shape, ws, overlap):
    """The last case has 12 x 12 key windows: 144 keys, not a multiple of
    the kernel's 64-key chunks."""
    gen = torch.Generator().manual_seed(c + ws)
    owin, _ = overlap_window(ws, overlap)
    blk = _block_operands(gen, c, heads, 2 * c, ws=ws)
    ops = blk[:6] + [_randn(gen, heads, ws * ws, owin * owin, scale=0.5)] + blk[7:]
    ops = [t.to(dev, dtype if i in (2, 4, 9, 11) else torch.float32) for i, t in enumerate(ops)]
    x = _randn(gen, *shape, c).to(dev, dtype)
    kw = dict(heads=heads, window_size=ws, overlap_ratio=overlap)
    engagement.reset()
    got = fused_ocab_block(x, *ops, **kw)
    assert engagement.counters() == {"fused_ocab_block": 1}
    want = ocab_plain(x.float(), *[t.float() for t in ops], **kw)
    _assert_close(got, want, dtype)


# B10 in bf16 on the kernels written for the H100 (``csrc/ocab_mma.cu``):
# HAT's 180 / 6 at window 16, overlap 0.5 (24 x 24 key windows reaching
# outside the image at every border window) at 32 x 32, 48 x 32 and batch 2;
# the trained fixtures' window 8 with 12 x 12 key windows (144 keys: the
# last chunk part padding) and overlap 1 (16 x 16); HAT x4 serving's map.
H100_OCAB_CASES = [(180, 6, (1, 32, 32), 16, 0.5), (180, 6, (1, 48, 32), 16, 0.5), (180, 6, (2, 32, 48), 16, 0.5),
                   (32, 2, (2, 16, 24), 8, 0.5), (24, 3, (2, 16, 24), 8, 1.0), (180, 6, (1, 256, 256), 16, 0.5)]


@pytest.mark.parametrize("c,heads,shape,ws,overlap", H100_OCAB_CASES)
def test_ocab_h100_kernel_matches_plain(dev, c, heads, shape, ws, overlap):
    """On the blob serving packs and a bf16 bias, against the plain version
    in f32 on the dense weights and the same bias values; dense weights give
    the blob's bits; two launches the same bits."""
    gen = torch.Generator().manual_seed(c + ws + shape[0])
    owin, _ = overlap_window(ws, overlap)
    blk = _block_operands(gen, c, heads, 2 * c, ws=ws)
    ops = blk[:6] + [_randn(gen, heads, ws * ws, owin * owin, scale=0.5)] + blk[7:]
    ops = [t.to(dev, torch.bfloat16 if i in (2, 4, 6, 9, 11) else torch.float32) for i, t in enumerate(ops)]
    served = list(ops)
    served[2], served[4], served[9], served[11] = pack_ocab_block(ops[2], ops[4], ops[9], ops[11], heads), None, None, None
    x = _randn(gen, *shape, c).to(dev, torch.bfloat16)
    kw = dict(heads=heads, window_size=ws, overlap_ratio=overlap)
    engagement.reset()
    got = fused_ocab_block(x, *served, **kw)
    again = fused_ocab_block(x, *served, **kw)
    dense = fused_ocab_block(x, *ops, **kw)
    assert engagement.entries() == {"fused_ocab_block": {"ocab_mma_bf16": 3}}
    _assert_close(got, ocab_plain(x.float(), *[t.float() for t in ops], **kw), torch.bfloat16)
    assert torch.equal(got, again) and torch.equal(got, dense)


def test_ocab_routes_by_dtype_and_geometry(dev):
    """f32, and bf16 outside the H100 kernels' geometry (head dim 48), take
    ``csrc/ocab.cu``; bf16 inside it ``csrc/ocab_mma.cu``; packed weights
    outside it raise."""
    gen = torch.Generator().manual_seed(4)
    engagement.reset()
    for dtype, c, heads in ((torch.float32, 32, 2), (torch.bfloat16, 96, 2), (torch.bfloat16, 32, 2)):
        blk = _block_operands(gen, c, heads, 2 * c, ws=8)
        ops = blk[:6] + [_randn(gen, heads, 64, 256, scale=0.5)] + blk[7:]
        ops = [t.to(dev, dtype if i in (2, 4, 9, 11) else torch.float32) for i, t in enumerate(ops)]
        x = _randn(gen, 1, 16, 24, c).to(dev, dtype)
        kw = dict(heads=heads, window_size=8, overlap_ratio=1.0)
        _assert_close(fused_ocab_block(x, *ops, **kw), ocab_plain(x.float(), *[t.float() for t in ops], **kw), dtype)
    assert engagement.entries() == {"fused_ocab_block": {"ocab_f32": 1, "ocab_bf16": 1, "ocab_mma_bf16": 1}}
    blob = pack_ocab_block(ops[2], ops[4], ops[9], ops[11], 2)
    with pytest.raises(ValueError, match="packed weights"):
        fused_ocab_block(x.float(), *ops[:2], blob, ops[3], None, *ops[5:9], None, ops[10], None, ops[12], **kw)


def test_small_hat_fused_matches_plain_on_the_card(dev):
    """Batch 1 folds the CAB join into B6; batch 2 joins in plain ops."""
    model = HAT.build(scale=4, embed_dim=30, depths=[2, 2], num_heads=[2, 2], window_size=16, device=dev)
    images = [np.random.default_rng(i).integers(0, 256, (20, 28, 3), dtype=np.uint8) for i in range(2)]
    plain = model.enable_fused(False).inference_batch(images)
    engagement.reset()
    fused = model.enable_fused(True).inference_batch(images)
    assert engagement.counters() == {
        "fused_cab_body": 4, "fused_window_attention_block_ws16": 4, "fused_mlp_block": 4, "fused_ocab_block": 2,
        "fused_conv3x3": 3, "fused_upsample_x4": 1,
    }
    engagement.reset()
    single = model.inference(images[0])
    assert engagement.counters()["fused_mlp_block_extra"] == 4
    for got, want in zip(fused + [single], plain + plain[:1]):
        diff = np.abs(got.astype(int) - want.astype(int))
        assert got.shape == (80, 112, 3) and diff.max() <= 1 and (diff > 0).mean() < 0.01


@pytest.mark.parametrize("scale", [2, 3])
def test_small_hat_window8_fused_matches_plain_on_the_card(dev, scale):
    """HAT at the trained fixtures' geometry: window 8 (B5's ws-8 kernel
    with HAT's operands), embed 32, 2 heads (head dim 16), overlap 0.5
    (12 x 12 OCAB key windows: 144 keys), CAB 32 -> 10 -> 32; the x2 / x3
    tail through B4."""
    model = HAT.build(scale=scale, embed_dim=32, depths=[2, 2], num_heads=[2, 2], window_size=8, device=dev)
    image = np.random.default_rng(scale).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    plain = model.enable_fused(False).inference(image)
    engagement.reset()
    fused = model.enable_fused(True).inference(image)
    assert engagement.counters() == {
        "fused_cab_body": 4, "fused_window_attention_block": 4, "fused_mlp_block_extra": 4, "fused_ocab_block": 2,
        "fused_conv3x3": 3, "fused_upsample_s": 1,
    }
    diff = np.abs(fused.astype(int) - plain.astype(int))
    assert fused.shape == (20 * scale, 28 * scale, 3) and diff.max() <= 1 and (diff > 0).mean() < 0.01


# HAT training kernels: B9 (the window-16 attention backward) on maps of 2
# windows by 3, batch 3 with a 0 drop-path scale, head dims 30, 16 and 24;
# B12 / B13 at the path's geometry (256 queries, 576 keys, d 30), the
# trained fixtures' (64, 144, d 16) and a ragged one (100, 200, d 24), on
# the transposed views the OCAB hands them, with logits large enough that
# the row max matters; an odd head dim (bf16 rows the mma kernels do not
# stage) and one past 32 take the shared-memory kernels in bf16 too.
B9_CASES = [(180, 6, (3, 32, 48), 8), (32, 2, (3, 32, 48), 0), (48, 2, (2, 16, 32), 8), (96, 2, (2, 16, 32), 8)]
OCA_CASES = [(3, 6, 256, 576, 30), (3, 2, 64, 144, 16), (2, 3, 100, 200, 24), (2, 2, 64, 144, 15)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,heads,shape,shift", B9_CASES)
def test_attention_bwd_ws16_kernel_matches_plain(dev, dtype, c, heads, shape, shift):
    gen = torch.Generator().manual_seed(c + shift + 9)
    ops = _block_operands(gen, c, heads, 2 * c, ws=16)[:7]
    ops = [t.to(dev, dtype if i in (2, 4) else torch.float32) for i, t in enumerate(ops)]
    x = _randn(gen, *shape, c).to(dev, dtype)
    g = _randn(gen, *shape, c).to(dev, dtype)
    dp = torch.tensor([0.0, 1.25, 1 / 0.9][: shape[0]], device=dev)
    kw = dict(heads=heads, window_size=16, shift=shift, drop_path=dp)
    engagement.reset()
    got = attention_bwd(x, g, *ops, **kw)
    # bf16 head dims above 32 take the older bf16 kernel, by the wrapper's rule
    entry = "attn_bwd16_f32" if dtype == torch.float32 else (
        "attn_bwd16_mma_bf16" if c // heads <= 32 else "attn_bwd16_bf16")
    assert engagement.entries() == {"attention_bwd_ws16": {entry: 1}}
    want = attention_bwd_plain(x.float(), g.float(), *[t.float() for t in ops], **kw)
    for a, e in zip(got, want):
        _assert_close(a, e, dtype)
    assert torch.equal(got[0][0], g[0])  # a dropped sample: dx = g
    again = attention_bwd(x, g, *ops, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: bitwise repeatable


# The bf16 kernels written for the H100 (csrc/attn_bwd_mma.cu) at MaxSR's
# geometry (C 128, 4 heads of 32, zero qkv bias) and at SwinIR's / HAT's,
# on maps with H != W and more windows than the attention pass has blocks
# (its window groups then hold several windows each): against the plain
# version, a dropped sample passed through bit for bit, the same bits over
# two calls, and the entry each launch took.
H100_BWD_CASES = [(128, 4, (2, 16, 24), 4, 8), (128, 4, (2, 32, 48), 8, 16), (180, 6, (3, 128, 136), 4, 8),
                  (180, 6, (2, 96, 112), 8, 16), (32, 2, (3, 24, 8), 0, 8), (64, 2, (2, 16, 48), 0, 16)]


@pytest.mark.parametrize("c,heads,shape,shift,ws", H100_BWD_CASES)
def test_attention_bwd_h100_kernels_match_plain(dev, c, heads, shape, shift, ws):
    gen = torch.Generator().manual_seed(c + shape[1] + ws)
    ops = _block_operands(gen, c, heads, 2 * c, ws=ws)[:7]
    ops = [t.to(dev, torch.bfloat16 if i in (2, 4) else torch.float32) for i, t in enumerate(ops)]
    if c in (64, 128):
        ops[3] = torch.zeros_like(ops[3])  # MaxSR's projections have no bias
        ops[6] = ops[6].to(torch.bfloat16)  # a bf16 rel-pos bias, as the bf16 step gathers it, read as it is
    x = _randn(gen, *shape, c).to(dev, torch.bfloat16)
    g = _randn(gen, *shape, c).to(dev, torch.bfloat16)
    dp = torch.tensor([0.0, 1 / 0.9, 1.25][: shape[0]], device=dev)
    kw = dict(heads=heads, window_size=ws, shift=shift, drop_path=dp)
    engagement.reset()
    got = attention_bwd(x, g, *ops, **kw)
    again = attention_bwd(x, g, *ops, **kw)
    name, entry = ("attention_bwd_ws16", "attn_bwd16_mma_bf16") if ws == 16 else ("attention_bwd", "attn_bwd_mma_bf16")
    assert engagement.entries() == {name: {entry: 2}}
    want = attention_bwd_plain(x.float(), g.float(), *[t.float() for t in ops], **kw)
    for a, e in zip(got, want):
        assert a.shape == e.shape
        _assert_close(a, e, torch.bfloat16)
    assert torch.equal(got[0][0], g[0])  # a dropped sample: dx = g
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: bitwise repeatable


# The bf16 kernels written for the H100 for B5 (csrc/window_attention_mma.cu)
# at the paths' shapes (batch 32 of 64 x 64 maps at both windows, HAT x4
# serving's 256 x 256 map), at H != W with an odd window count and at head
# dims 8, 12, 16, 24 and 32 (MaxSR's C 128: zero qkv bias, a bf16 bias read as
# it is), with and without drop-path, at both shifts: against the plain
# version, a dropped sample passed through bit for bit, the dense weights and
# the serving blob (pack_window_attention) giving the same bits, and the
# entry each launch took.
H100_FWD_CASES = [
    (180, 6, (32, 64, 64), 4, 8, True), (180, 6, (32, 64, 64), 8, 16, True), (180, 6, (1, 256, 256), 8, 16, False),
    (180, 6, (1, 24, 40), 4, 8, True), (180, 6, (3, 48, 80), 0, 16, True), (16, 2, (2, 16, 24), 4, 8, True),
    (24, 2, (2, 32, 16), 8, 16, False), (32, 2, (2, 24, 24), 0, 8, False), (48, 2, (2, 16, 48), 8, 16, True),
    (128, 4, (2, 32, 48), 4, 8, True), (128, 4, (2, 32, 48), 8, 16, False),
]


@pytest.mark.parametrize("c,heads,shape,shift,ws,with_dp", H100_FWD_CASES)
def test_window_attention_h100_kernels_match_plain(dev, c, heads, shape, shift, ws, with_dp):
    gen = torch.Generator().manual_seed(c + shape[1] + ws + shift)
    ops = _block_operands(gen, c, heads, 2 * c, ws=ws)[:7]
    ops = [t.to(dev, torch.bfloat16 if i in (2, 4) else torch.float32) for i, t in enumerate(ops)]
    if c == 128:
        ops[3] = torch.zeros_like(ops[3])  # MaxSR's projections have no bias
        ops[6] = ops[6].to(torch.bfloat16)  # a bf16 rel-pos bias, as the bf16 step gathers it
    x = _randn(gen, *shape, c).to(dev, torch.bfloat16)
    dp = None
    if with_dp:
        dp = torch.full((shape[0],), 1 / 0.9, device=dev)
        dp[0] = 0.0
    kw = dict(heads=heads, window_size=ws, shift=shift, drop_path=dp)
    blob = pack_window_attention(ops[2], ops[4], ops[6].float(), heads)
    engagement.reset()
    got = fused_window_attention_block(x, *ops, **kw)
    packed = fused_window_attention_block(x, ops[0], ops[1], blob, ops[3], None, ops[5], None, **kw)
    name, entry = (("fused_window_attention_block_ws16", "window_attention16_mma_bf16") if ws == 16 else
                   ("fused_window_attention_block", "window_attention_mma_bf16"))
    assert engagement.entries() == {name: {entry: 2}}
    want = window_attention_plain(x.float(), *[t.float() for t in ops], **kw)
    _assert_close(got, want, torch.bfloat16)
    assert torch.equal(got, packed)
    if with_dp:
        assert torch.equal(got[0], x[0])  # a dropped sample passes through exactly


# B5, B8 and B9 at every square window from 2 to 16: windows 2-8 take one
# 64-row tile a window (the small family, counted under the window-8 keys),
# 9-16 two to four (the large family, ``_ws16``), a window of N = ws^2
# tokens padded to whole tiles. bf16 at head dim 32 (the kernels written for
# the H100), f32 at head dim 16 (the f32 kernels written for the H100 at
# windows 2-8, the older ones above), bf16 at head dim 48 (the older), on
# maps of 2 x 3 windows with the shift ws // 2 and a 0 drop-path scale:
# against the plain versions, the serving blob giving the dense weights'
# bits, the backward's bits repeatable, and the entry each launch took.
ANY_WINDOW_CASES = [(ws, torch.bfloat16, 64, 2) for ws in range(2, 17)] + [
    (ws, torch.float32, 32, 2) for ws in range(2, 17)] + [(5, torch.bfloat16, 96, 2), (12, torch.bfloat16, 96, 2)]


@pytest.mark.parametrize("ws,dtype,c,heads", ANY_WINDOW_CASES)
def test_window_kernels_take_every_window_from_2_to_16(dev, ws, dtype, c, heads):
    _check_window_kernels(dev, ws, dtype, c, heads)


# Above 16 (N > 256, five 64-token chunks and more: the streaming family,
# ``_large``): windows 17, 24 and 33 in both directions and on both routes,
# bf16 at head dim 32 (the kernels written for the H100), bf16 at head dim 64
# and f32 (the older kernels), as above.
LARGE_WINDOW_CASES = [(ws, dtype, c, 2) for ws in (17, 24, 33)
                      for dtype, c in ((torch.bfloat16, 64), (torch.bfloat16, 128), (torch.float32, 32))]


@pytest.mark.parametrize("ws,dtype,c,heads", LARGE_WINDOW_CASES)
def test_window_kernels_take_every_window_above_16(dev, ws, dtype, c, heads):
    _check_window_kernels(dev, ws, dtype, c, heads)


# The forward above window 16 on lf_core.cuh's pipelined core. B5 at windows
# 17, 24 and 33, C 128 / 4 heads and 180 / 6, shift ws / 2 (the windows of
# the last window row and column masked, the others not) and 0, with
# drop-path, a bf16 bias; MaxSR's 289² map at window 17 (289 tokens in five
# tiles, two blocks a unit, the second one tile short), unshifted: against
# the plain version, two launches the same bits, each through the entry.
LF_B5_CASES = [(ws, c, heads, (2, 2 * ws, 3 * ws), shift) for ws in (17, 24, 33) for c, heads in ((128, 4), (180, 6))
               for shift in (0, ws // 2)] + [(17, 128, 4, (1, 289, 289), 0)]


@pytest.mark.parametrize("ws,c,heads,shape,shift", LF_B5_CASES)
def test_window_attention_large_core_matches_plain_and_repeats(dev, ws, c, heads, shape, shift):
    gen = torch.Generator().manual_seed(ws + c + shift + shape[1])
    ops = [t.to(dev, torch.bfloat16 if i in (2, 4, 6) else torch.float32)
           for i, t in enumerate(_block_operands(gen, c, heads, 2 * c, ws=ws)[:7])]
    x = _randn(gen, *shape, c).to(dev, torch.bfloat16)
    dp = torch.full((shape[0],), 1.25, device=dev)
    dp[0] = 0.0
    kw = dict(heads=heads, window_size=ws, shift=shift, drop_path=dp)
    engagement.reset()
    y = fused_window_attention_block(x, *ops, **kw)
    again = fused_window_attention_block(x, *ops, **kw)
    assert engagement.entries() == {"fused_window_attention_block_large": {"window_attention_large_mma_bf16": 2}}
    _assert_close(y, window_attention_plain(x.float(), *[t.float() for t in ops], **kw), torch.bfloat16)
    assert torch.equal(y, again)  # one owner a row, no atomics: bitwise repeatable
    assert torch.equal(y[0], x[0])  # a dropped sample passes through exactly


def test_window_attention_large_core_serves_the_packed_f32_blob(dev):
    """SwinIR x4 serving at window 24 (C 180, 6 heads, shift 12, no
    drop-path) on a 2 x 3 window map: the blob (the f32 bias in fragment
    order, three stages a block) against the plain version, two launches
    and the dense weights with the same f32 bias giving the same bits."""
    ws, c, heads = 24, 180, 6
    gen = torch.Generator().manual_seed(2400)
    ops = [t.to(dev, torch.bfloat16 if i in (2, 4) else torch.float32)
           for i, t in enumerate(_block_operands(gen, c, heads, 2 * c, ws=ws)[:7])]
    x = _randn(gen, 1, 2 * ws, 3 * ws, c).to(dev, torch.bfloat16)
    kw = dict(heads=heads, window_size=ws, shift=ws // 2, drop_path=None)
    blob = pack_window_attention(ops[2], ops[4], ops[6], heads)
    engagement.reset()
    served = fused_window_attention_block(x, ops[0], ops[1], blob, ops[3], None, ops[5], None, **kw)
    again = fused_window_attention_block(x, ops[0], ops[1], blob, ops[3], None, ops[5], None, **kw)
    dense = fused_window_attention_block(x, *ops, **kw)
    assert engagement.entries() == {"fused_window_attention_block_large": {"window_attention_large_mma_bf16": 3}}
    _assert_close(served, window_attention_plain(x.float(), *[t.float() for t in ops], **kw), torch.bfloat16)
    assert torch.equal(served, again) and torch.equal(served, dense)


# B12's large entry and B10 above 576 keys on the same core, the bias put in
# fragment order first: B12 at HAT's window-24 OCA geometry (576 x 1296, more
# windows than SMs) and ragged (100 x 700, d 12: a partial last chunk and
# query tile, bf16 rows of 1400 bytes) with either bias dtype, and 300 x
# 100 (the large entry below 576 keys); B10 at window 24 (1296 keys) and 20
# (900), HAT's widths, on the blob: against the plain versions, two launches
# the same bits.
LF_OF_CASES = [(140, 2, 576, 1296, 30, torch.bfloat16), (140, 2, 576, 1296, 30, torch.float32),
               (5, 3, 100, 700, 12, torch.float32), (5, 3, 100, 700, 12, torch.bfloat16),
               (4, 2, 300, 100, 16, torch.float32)]


@pytest.mark.parametrize("bw,heads,nq,nk,d,bias_dtype", LF_OF_CASES)
def test_oca_core_fwd_large_core_matches_plain_and_repeats(dev, bw, heads, nq, nk, d, bias_dtype):
    from studiosr_tpu_torch.ops.cuda.oca_core import oca_core_fwd, oca_core_plain

    gen = torch.Generator().manual_seed(bw + nq + nk)
    q, k, v, bias, _ = _oca_case(gen, bw, heads, nq, nk, d, dev, torch.bfloat16)
    bias = bias.to(bias_dtype)
    engagement.reset()
    out = oca_core_fwd(q, k, v, bias)
    again = oca_core_fwd(q, k, v, bias)
    assert engagement.entries() == {"oca_core_fwd_large": {"oca_core_fwd_large_mma_bf16": 2}}
    _assert_close(out, oca_core_plain(q.float(), k.float(), v.float(), bias.float()), torch.bfloat16)
    assert torch.equal(out, again)


@pytest.mark.parametrize("ws", [24, 20])
def test_ocab_above_576_keys_core_matches_plain_and_repeats(dev, ws):
    c, heads = 180, 6
    gen = torch.Generator().manual_seed(ws + 7)
    owin, _ = overlap_window(ws, 0.5)
    blk = _block_operands(gen, c, heads, 2 * c, ws=ws)
    ops = blk[:6] + [_randn(gen, heads, ws * ws, owin * owin, scale=0.5)] + blk[7:]
    ops = [t.to(dev, torch.bfloat16 if i in (2, 4, 6, 9, 11) else torch.float32) for i, t in enumerate(ops)]
    x = _randn(gen, 1, 2 * ws, 3 * ws, c).to(dev, torch.bfloat16)
    kw = dict(heads=heads, window_size=ws, overlap_ratio=0.5)
    served = list(ops)
    served[2], served[4], served[9], served[11] = pack_ocab_block(ops[2], ops[4], ops[9], ops[11], heads), None, None, None
    engagement.reset()
    got = fused_ocab_block(x, *served, **kw)
    again = fused_ocab_block(x, *served, **kw)
    assert engagement.entries() == {"fused_ocab_block": {"ocab_mma_bf16": 2}}
    _assert_close(got, ocab_plain(x.float(), *[t.float() for t in ops], **kw), torch.bfloat16)
    assert torch.equal(got, again)


def _check_window_kernels(dev, ws, dtype, c, heads):
    from studiosr_tpu_torch.ops.cuda.window_attention import FAMILY_STEM, mma_takes

    gen = torch.Generator().manual_seed(100 + ws + c)
    ops = _block_operands(gen, c, heads, 2 * c, ws=ws)[:7]
    ops = [t.to(dev, dtype if i in (2, 4) else torch.float32) for i, t in enumerate(ops)]
    shape = (2, 2 * ws, 3 * ws)
    x = _randn(gen, *shape, c).to(dev, dtype)
    g = _randn(gen, *shape, c).to(dev, dtype)
    dp = torch.tensor([0.0, 1.25], device=dev)
    kw = dict(heads=heads, window_size=ws, shift=ws // 2, drop_path=dp)
    mma = dtype == torch.bfloat16 and mma_takes(c, heads)
    suffix = window_family(ws)
    fam = FAMILY_STEM[suffix]
    engagement.reset()
    y = fused_window_attention_block(x, *ops, **kw)
    grads = attention_bwd(x, g, *ops, **kw)
    again = attention_bwd(x, g, *ops, **kw)
    kind = "_mma_bf16" if mma else ("_bf16" if dtype == torch.bfloat16 else "_f32")
    # f32 at windows 2-8 (head dims up to 32): the f32 kernels written for the H100, both directions
    if dtype == torch.float32 and f32_mma_takes(c, heads, ws):
        kind = "_mma_f32"
    assert engagement.entries() == {"fused_window_attention_block" + suffix: {f"window_attention{fam}{kind}": 1},
                                    "attention_bwd" + suffix: {f"attn_bwd{fam}{kind}": 2}}
    _assert_close(y, window_attention_plain(x.float(), *[t.float() for t in ops], **kw), dtype)
    assert torch.equal(y[0], x[0])  # a dropped sample passes through exactly
    want = attention_bwd_plain(x.float(), g.float(), *[t.float() for t in ops], **kw)
    for a, e in zip(grads, want):
        assert a.shape == e.shape
        _assert_close(a, e, dtype)
    assert torch.equal(grads[0][0], g[0])  # a dropped sample: dx = g
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # no atomics: bitwise repeatable
    if mma:
        blob = pack_window_attention(ops[2], ops[4], ops[6], heads)
        packed = fused_window_attention_block(x, ops[0], ops[1], blob, ops[3], None, ops[5], None, **kw)
        assert torch.equal(y, packed)


# B9's large family on lb_core.cuh's two-formation core (the C entry
# attn_bwd_large_mma_bf16): windows 17, 24 and 33 (one and two query parts),
# C 128 / 4 heads and 180 / 6, shift 0 and ws / 2, with and without
# drop-path, on maps of 2 x 3 windows, batch 2: every output against the
# plain version, two launches the same bits, each launch through the entry.
# And window 48 at C 128 / 4 heads (four query parts; the 12 windows in two
# batches, the d-bias slabs carried from the first to the second).
LB_B9_CASES = [(ws, c, heads, shift, dp) for ws in (17, 24, 33) for c, heads in ((128, 4), (180, 6))
               for shift in (0, ws // 2) for dp in (False, True)] + [(48, 128, 4, 24, True)]


@pytest.mark.parametrize("ws,c,heads,shift,drop", LB_B9_CASES)
def test_attention_bwd_large_two_formation_core_matches_plain(dev, ws, c, heads, shift, drop):
    gen = torch.Generator().manual_seed(ws + c + shift)
    ops = [t.to(dev, torch.bfloat16 if i in (2, 4) else torch.float32)
           for i, t in enumerate(_block_operands(gen, c, heads, 2 * c, ws=ws)[:7])]
    x = _randn(gen, 2, 2 * ws, 3 * ws, c).to(dev, torch.bfloat16)
    g = _randn(gen, 2, 2 * ws, 3 * ws, c).to(dev, torch.bfloat16)
    kw = dict(heads=heads, window_size=ws, shift=shift,
              drop_path=torch.tensor([0.0, 1.25], device=dev) if drop else None)
    engagement.reset()
    grads = attention_bwd(x, g, *ops, **kw)
    again = attention_bwd(x, g, *ops, **kw)
    assert engagement.entries() == {"attention_bwd_large": {"attn_bwd_large_mma_bf16": 2}}
    want = attention_bwd_plain(x.float(), g.float(), *[t.float() for t in ops], **kw)
    for a, e in zip(grads, want):
        assert a.shape == e.shape
        _assert_close(a, e, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # no atomics: bitwise repeatable


# B13's large family on the same core (oca_core_bwd_large_mma_bf16) at HAT's
# window-24 and window-32 OCA geometries (576 x 1296, 1024 x 2304: one and
# two query parts) with more windows than SMs, 2 heads of 30, and at windows
# 48 and 64 with 6 heads (2304 x 5184 on 3 windows: a batch a window, the
# d-bias slabs carried across three batches; 4096 x 9216 on 2: the eight
# query parts in two runs as well): against the plain version, two launches
# the same bits, a bf16 bias read as it is giving the f32 bias's bits.
LB_B13_CASES = [(140, 2, 576, 1296, 30), (136, 2, 1024, 2304, 30), (3, 6, 2304, 5184, 30), (2, 6, 4096, 9216, 30)]


@pytest.mark.parametrize("bw,heads,nq,nk,d", LB_B13_CASES)
def test_oca_core_bwd_large_two_formation_core_matches_plain(dev, bw, heads, nq, nk, d):
    from studiosr_tpu_torch.ops.cuda.oca_core import oca_core_bwd, oca_core_bwd_plain

    gen = torch.Generator().manual_seed(bw + nq)
    q, k, v, bias, g = _oca_case(gen, bw, heads, nq, nk, d, dev, torch.bfloat16)
    bias = bias.to(torch.bfloat16).float()  # values a bf16 bias holds exactly
    engagement.reset()
    grads = oca_core_bwd(q, k, v, bias, g)
    again = oca_core_bwd(q, k, v, bias, g)
    b16 = oca_core_bwd(q, k, v, bias.to(torch.bfloat16), g)
    assert engagement.entries() == {"oca_core_bwd_large": {"oca_core_bwd_large_mma_bf16": 3}}
    want = oca_core_bwd_plain(q.float(), k.float(), v.float(), bias, g.float())
    for a, e in zip(grads, want):
        assert a.shape == e.shape
        _assert_close(a, e, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # no atomic sums: bitwise repeatable
    assert all(torch.equal(a, b) for a, b in zip(grads, b16))


def test_large_scratch_matches_the_mirror(dev):
    """B13's large entry sizes its scratch as ``oca_core.large_scratch`` (the
    images, lb_core.cuh's plan) at this card's SM count."""
    import ctypes

    from studiosr_tpu_torch.ops.cuda import _build
    from studiosr_tpu_torch.ops.cuda import oca_core as oca_module

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _build.load("oca_bwd_mma", oca_module._SIGNATURES_MMA)
    for geom in ((288, 6, 576, 1296, 30), (8, 6, 1024, 2304, 30), (5, 3, 100, 700, 12), (128, 6, 2304, 5184, 30),
                 (2, 6, 4096, 9216, 30)):
        t, f = ctypes.c_longlong(), ctypes.c_longlong()
        assert lib.oca_core_bwd_large_mma_scratch(*geom, ctypes.byref(t), ctypes.byref(f)) == 0
        assert (t.value, f.value) == oca_module.large_scratch(*geom, sms=sms)


@pytest.mark.parametrize("dtype", DTYPES)
def test_window_kernels_raise_above_window_16(dev, dtype):
    """Windows above 16 launch the streaming family now; the wrappers raise
    only past KERNEL_WINDOW_MAX (256), where the (heads, N, N) f32 bias alone
    outgrows the card, naming the windows the kernels take, before any
    launch (the operands are not looked at)."""
    gen = torch.Generator().manual_seed(17)
    ops = [t.to(dev, dtype if i in (2, 4) else torch.float32) for i, t in
           enumerate(_block_operands(gen, 32, 2, 64, ws=4)[:7])]
    x = torch.zeros(1, 257, 257, 32, device=dev, dtype=dtype)
    kw = dict(heads=2, window_size=257, shift=0, drop_path=None)
    engagement.reset()
    with pytest.raises(NotImplementedError, match="window sizes 2-256"):
        fused_window_attention_block(x, *ops, **kw)
    with pytest.raises(NotImplementedError, match="window sizes 2-256"):
        attention_bwd(x, x, *ops, **kw)
    assert engagement.counters() == {}


# B7's bf16 kernel written for the H100 (csrc/mlp_bwd_mma.cu) at the paths'
# rows (batch 32 of 64 x 64, C 180, hidden 360), at row counts that leave a
# ragged last tile, at C 16, 24, 32, 48 and 128 and at hidden 384, with and
# without drop-path: every output against the plain version, a dropped
# sample's dx equal to g, and two launches giving the same bits (the weight
# gradients' partials summed in a fixed order).
H100_MLP_CASES = [(180, 360, 32 * 4096, 4096), (180, 360, 1000, 500), (32, 64, 777, 0), (16, 32, 200, 100),
                  (24, 48, 300, 150), (48, 96, 130, 65), (128, 256, 640, 320), (128, 384, 256, 0)]


@pytest.mark.parametrize("c,hidden,rows,rows_per_sample", H100_MLP_CASES)
def test_mlp_bwd_h100_kernel_matches_plain(dev, c, hidden, rows, rows_per_sample):
    gen = torch.Generator().manual_seed(c + hidden + rows)
    ops = _block_operands(gen, c, 2, hidden)[7:12]
    ops = [t.to(dev, torch.bfloat16 if i in (2, 4) else torch.float32) for i, t in enumerate(ops)]
    x = _randn(gen, rows, c).to(dev, torch.bfloat16)
    g = _randn(gen, rows, c).to(dev, torch.bfloat16)
    dp = None
    if rows_per_sample:
        dp = torch.full((rows // rows_per_sample,), 1 / 0.9, device=dev)
        dp[0] = 0.0
    kw = dict(drop_path=dp, rows_per_sample=rows_per_sample)
    engagement.reset()
    got = mlp_bwd(x, g, *ops, **kw)
    again = mlp_bwd(x, g, *ops, **kw)
    assert engagement.entries() == {"mlp_bwd": {"mlp_bwd_mma_bf16": 2}}
    want = mlp_bwd_plain(x.float(), g.float(), *[t.float() for t in ops], **kw)
    for a, e in zip(got, want):
        assert a.shape == e.shape
        _assert_close(a, e, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: bitwise repeatable
    if dp is not None:
        assert torch.equal(got[0][:rows_per_sample], g[:rows_per_sample])  # a dropped sample: dx = g


def _oca_case(gen, bw, heads, nq, nk, d, dev, dtype):
    """q, k, v as transposed views of (bw, tokens, heads, d) tensors, as the
    OCAB makes them; scores of a few units, so the row max matters."""
    def view(n, scale):
        return _randn(gen, bw, n, heads, d, scale=scale).to(dev, dtype).transpose(1, 2)

    q, k, v, g = view(nq, 2 * d**-0.5), view(nk, 1.0), view(nk, 1.0), view(nq, 1.0)
    bias = _randn(gen, heads, nq, nk, scale=2.0).to(dev)
    return q, k, v, bias, g


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bw,heads,nq,nk,d", OCA_CASES)
def test_oca_core_kernels_match_plain(dev, dtype, bw, heads, nq, nk, d):
    from studiosr_tpu_torch.ops.cuda.oca_core import oca_core_bwd, oca_core_bwd_plain, oca_core_fwd, oca_core_plain

    gen = torch.Generator().manual_seed(nq + d)
    q, k, v, bias, g = _oca_case(gen, bw, heads, nq, nk, d, dev, dtype)
    engagement.reset()
    out = oca_core_fwd(q, k, v, bias)
    grads = oca_core_bwd(q, k, v, bias, g)
    assert engagement.counters() == {"oca_core_fwd": 1, "oca_core_bwd": 1}
    _assert_close(out, oca_core_plain(q.float(), k.float(), v.float(), bias), dtype)
    want = oca_core_bwd_plain(q.float(), k.float(), v.float(), bias, g.float())
    for a, e in zip(grads, want):
        assert a.shape == e.shape
        _assert_close(a, e, dtype)
    again = oca_core_bwd(q.contiguous(), k.contiguous(), v.contiguous(), bias, g.contiguous())
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # strides do not change a bit; no atomics


# B13 in bf16 on the kernel written for the H100 (``csrc/oca_bwd_mma.cu``):
# HAT's training step (512 windows, 6 heads, 256 | 576 tokens, d 30), a
# window count that is not a whole number of the main pass's groups, the
# trained fixtures' 64 | 144 at d 16, ragged tiles at d 24, an odd d and
# an odd count of query tiles (three, padded to four).
H100_OCA_CASES = [(512, 6, 256, 576, 30), (37, 6, 256, 576, 30), (16, 2, 64, 144, 16), (5, 3, 200, 300, 24),
                  (3, 2, 100, 70, 7), (4, 2, 150, 100, 16)]


@pytest.mark.parametrize("bw,heads,nq,nk,d", H100_OCA_CASES)
def test_oca_core_bwd_h100_kernel_matches_plain(dev, bw, heads, nq, nk, d):
    from studiosr_tpu_torch.ops.cuda.oca_core import oca_core_bwd, oca_core_bwd_plain

    gen = torch.Generator().manual_seed(bw + nq + nk + d)
    q, k, v, bias, g = _oca_case(gen, bw, heads, nq, nk, d, dev, torch.bfloat16)
    engagement.reset()
    got = oca_core_bwd(q, k, v, bias, g)
    again = oca_core_bwd(q, k, v, bias, g)
    assert engagement.entries() == {"oca_core_bwd": {"oca_core_bwd_mma_bf16": 2}}
    want = oca_core_bwd_plain(q.float(), k.float(), v.float(), bias, g.float())
    for a, e in zip(got, want):
        assert a.shape == e.shape
        _assert_close(a, e, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomic sums: bitwise repeatable


# B13 in f32 on the kernel written for the H100 (``csrc/oca_bwd_f32.cu``):
# HAT's windows 8, 12 and 16 (64 | 144, 144 | 324, 256 | 576 at d 30) on the
# OCAB's transposed views, HAT's f32 step (512 windows), 37 windows (not a
# whole number of the main pass's groups), the trained fixtures' d 16, an odd
# d and a ragged geometry; above window 16 (576 | 1296) the first design.
H100_OCA_F32_CASES = [(6, 6, 64, 144, 30), (6, 6, 144, 324, 30), (6, 6, 256, 576, 30), (512, 6, 256, 576, 30),
                      (37, 6, 256, 576, 30), (16, 2, 64, 144, 16), (3, 2, 100, 70, 7), (5, 3, 200, 300, 24),
                      (2, 2, 576, 1296, 30)]


@pytest.mark.parametrize("bw,heads,nq,nk,d", H100_OCA_F32_CASES)
def test_oca_core_bwd_f32_h100_kernel_matches_plain(dev, bw, heads, nq, nk, d):
    """Against the plain version at the f32 rule; d bias (and every output)
    the same bits over two launches; up to 256 queries and 576 keys through
    ``oca_core_bwd_mma_f32``, above them ``oca_core_bwd_f32`` under
    ``oca_core_bwd_large``."""
    from studiosr_tpu_torch.ops.cuda.oca_core import counter, oca_core_bwd, oca_core_bwd_plain

    gen = torch.Generator().manual_seed(bw + nq + nk + d)
    q, k, v, bias, g = _oca_case(gen, bw, heads, nq, nk, d, dev, torch.float32)
    engagement.reset()
    got = oca_core_bwd(q, k, v, bias, g)
    again = oca_core_bwd(q, k, v, bias, g)
    name = counter("oca_core_bwd", nq, nk)
    entry = "oca_core_bwd_f32" if name.endswith("_large") else "oca_core_bwd_mma_f32"
    assert engagement.entries() == {name: {entry: 2}}
    want = oca_core_bwd_plain(q, k, v, bias, g)
    for a, e in zip(got, want):
        assert a.shape == e.shape
        _assert_close(a, e, torch.float32)
    assert got[0].transpose(1, 2).is_contiguous() and got[1].transpose(1, 2).is_contiguous()
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomic sums: bitwise repeatable


# B6 and B6 ``extra`` in bf16 on the kernel written for the H100
# (``csrc/mlp_block_mma.cu``): C 180 / hidden 360 at the training step's
# rows (batch 32 of 64 x 64) and at HAT serving's 65,536 with the join, ragged
# row counts, narrow widths and hidden 384; drop-path scales with a 0 (that
# sample passes through exactly); the weights packed once (the serving blob)
# against dense ones bit for bit; two launches the same bits.
H100_MLP_FWD_CASES = [(180, 360, 32 * 4096, 4096, None), (180, 360, 65536, 0, "extra"),
                      (180, 360, 1000, 500, None), (180, 360, 777, 0, "extra"), (32, 64, 300, 150, None),
                      (16, 32, 200, 0, "extra"), (128, 384, 130, 65, None), (60, 120, 100, 0, None)]


@pytest.mark.parametrize("c,hidden,rows,rows_per_sample,mode", H100_MLP_FWD_CASES)
def test_mlp_block_h100_kernel_matches_plain(dev, c, hidden, rows, rows_per_sample, mode):
    gen = torch.Generator().manual_seed(c + hidden + rows)
    ops = _block_operands(gen, c, 2, hidden)[7:]
    ops = [t.to(dev, torch.bfloat16 if i in (2, 4) else torch.float32) for i, t in enumerate(ops)]
    x = _randn(gen, rows, c).to(dev, torch.bfloat16)
    kw = {}
    if mode == "extra":
        kw = dict(extra=_randn(gen, rows, c).to(dev, torch.bfloat16), extra_scale=_randn(gen, c, scale=0.5).to(dev))
    elif rows_per_sample:
        dp = torch.full((rows // rows_per_sample,), 1 / 0.9, device=dev)
        dp[0] = 0.0
        kw = dict(drop_path=dp, rows_per_sample=rows_per_sample)
    name, entry = ("fused_mlp_block_extra", "mlp_block_extra_mma_bf16") if mode else ("fused_mlp_block",
                                                                                      "mlp_block_mma_bf16")
    engagement.reset()
    got = fused_mlp_block(x, *ops, **kw)
    again = fused_mlp_block(x, *ops, **kw)
    packed = fused_mlp_block(x, ops[0], ops[1], pack_mlp_block(ops[2], ops[4]), ops[3], None, ops[5], **kw)
    assert engagement.entries() == {name: {entry: 3}}
    fkw = {k: (v.float() if k == "extra" else v) for k, v in kw.items()}
    want = mlp_block_plain(x.float(), *[t.float() for t in ops], **fkw)
    _assert_close(got, want, torch.bfloat16)
    assert torch.equal(got, again) and torch.equal(got, packed)
    if rows_per_sample and mode is None:
        assert torch.equal(got[:rows_per_sample], x[:rows_per_sample])  # a dropped sample passes through exactly


# B12 in bf16 on the kernel written for the H100 (``csrc/oca_fwd_mma.cu``):
# HAT's step (512 windows) and batch 4 (64), 37 windows, the trained
# fixtures' 64 | 144 at d 16, ragged tiles at d 24, an odd d, an odd count of
# query tiles (three: the pair's second warpgroup idles on the last).
H100_OCA_FWD_CASES = [(512, 6, 256, 576, 30), (64, 6, 256, 576, 30), (37, 6, 256, 576, 30), (16, 2, 64, 144, 16),
                      (5, 3, 200, 300, 24), (3, 2, 100, 70, 7), (4, 2, 150, 100, 16)]


@pytest.mark.parametrize("bw,heads,nq,nk,d", H100_OCA_FWD_CASES)
def test_oca_core_fwd_h100_kernel_matches_plain(dev, bw, heads, nq, nk, d):
    """Against the plain version in f32; a bias handed in bf16 is read as it
    is and gives the bits of the same values handed in f32; two launches the
    same bits; contiguous operands the bits of the OCAB's strided views."""
    from studiosr_tpu_torch.ops.cuda.oca_core import oca_core_fwd, oca_core_plain

    gen = torch.Generator().manual_seed(bw + nq + nk + d)
    q, k, v, bias, _ = _oca_case(gen, bw, heads, nq, nk, d, dev, torch.bfloat16)
    b16 = bias.to(torch.bfloat16)
    engagement.reset()
    got = oca_core_fwd(q, k, v, bias)
    again = oca_core_fwd(q, k, v, bias)
    half = oca_core_fwd(q, k, v, b16)
    same = oca_core_fwd(q, k, v, b16.float())
    dense = oca_core_fwd(q.contiguous(), k.contiguous(), v.contiguous(), bias)
    assert engagement.entries() == {"oca_core_fwd": {"oca_core_fwd_mma_bf16": 5}}
    _assert_close(got, oca_core_plain(q.float(), k.float(), v.float(), bias), torch.bfloat16)
    _assert_close(half, oca_core_plain(q.float(), k.float(), v.float(), b16.float()), torch.bfloat16)
    assert got.shape == (bw, heads, nq, d) and got.transpose(1, 2).is_contiguous()
    assert torch.equal(got, again) and torch.equal(half, same) and torch.equal(got, dense)


def test_oca_core_fwd_routes_by_dtype_and_geometry(dev):
    """f32, and bf16 outside the H100 kernel's geometry (d 48), take the
    older entries; bf16 inside it the new one."""
    from studiosr_tpu_torch.ops.cuda.oca_core import oca_core_fwd, oca_core_plain

    gen = torch.Generator().manual_seed(3)
    engagement.reset()
    for dtype, d in ((torch.float32, 30), (torch.bfloat16, 48), (torch.bfloat16, 30)):
        q, k, v, bias, _ = _oca_case(gen, 3, 2, 64, 144, d, dev, dtype)
        _assert_close(oca_core_fwd(q, k, v, bias), oca_core_plain(q.float(), k.float(), v.float(), bias), dtype)
    assert engagement.entries() == {"oca_core_fwd": {"oca_core_fwd_f32": 1, "oca_core_fwd_bf16": 1,
                                                     "oca_core_fwd_mma_bf16": 1}}


def test_hat_training_kernels_raise_on_shapes_they_do_not_take(dev):
    from studiosr_tpu_torch.ops.oca_vjp import oca_attention

    gen = torch.Generator().manual_seed(0)
    ops = [t.to(dev) for t in _block_operands(gen, 160, 2, 320, ws=16)[:7]]
    x = torch.zeros(1, 16, 16, 160, device=dev)
    with pytest.raises(NotImplementedError, match="head dim"):
        attention_bwd(x, x, *ops, heads=2, window_size=16)
    with pytest.raises(ValueError, match="do not fit"):
        attention_bwd(torch.zeros(1, 24, 16, 160, device=dev), torch.zeros(1, 24, 16, 160, device=dev), *ops,
                      heads=2, window_size=16)
    q = torch.zeros(1, 2, 64, 80, device=dev)
    with pytest.raises(NotImplementedError, match="d <= 64"):
        oca_attention(q, q, q, torch.zeros(2, 64, 64, device=dev))
    with pytest.raises(TypeError, match="dtype"):
        oca_attention(q.half(), q.half(), q.half(), torch.zeros(2, 64, 64, device=dev))


def test_small_hat_fused_train_matches_plain_on_the_card(dev):
    """Loss and gradients of the fused-train HAT (window 16, f32) against
    plain autograd on the card, with the launch counts of one step."""
    model = HAT.build(scale=4, embed_dim=32, depths=[2, 2], num_heads=[2, 2], window_size=16, drop_path_rate=0.5,
                      device=dev)
    module = model.module.train()
    x = torch.rand(3, 32, 48, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    gt = torch.rand(3, 128, 192, 3, generator=torch.Generator().manual_seed(2)).to(dev)
    results = []
    for fused in (False, True):
        module.fused_train = fused
        module.zero_grad()
        engagement.reset()
        out = module(x, generator=torch.Generator().manual_seed(3))
        loss = torch.mean(torch.abs(out - gt))
        loss.backward()
        torch.cuda.synchronize()
        results.append((loss.item(), {k: p.grad.clone() for k, p in module.named_parameters()},
                        engagement.counters()))
    assert results[0][2] == {}
    assert results[1][2] == {"fused_window_attention_block_ws16": 4, "attention_bwd_ws16": 4, "fused_mlp_block": 4,
                             "mlp_bwd": 4, "oca_core_fwd": 2, "oca_core_bwd": 2}
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-5)
    for k, g in results[0][1].items():
        assert float((results[1][1][k] - g).abs().max()) <= 1e-4 * float(g.abs().max()) + 1e-6, k


# B14 (the SFB resblock) on odd heights and ragged maps, both activations
# and res_scales; B15 (the window-attention core; bf16: ``wf_kernel``, f32:
# ``attn_core.cuh``'s row pass) at N and M from 36 to 1024, N != M (one unit
# resident or, at M 1024 and d 64, the ring of key chunks), with and without
# a bias, a mask over two images, both (in shared memory or read per score),
# at head dims 12 (MaxSR light), 15, 16, 24, 32, 48 and 64, on the strided q
# / k / v of a fused qkv projection, starting ``offset`` elements into their
# storage (1, 2, 4: no 16-, 8- or 4-byte alignment), with more windows than
# the persistent grid has blocks.
RESBLOCK_CASES = [((1, 37, 53, 48), "lrelu0.2", 1.0), ((2, 13, 21, 16), "relu", 0.1),
                  ((1, 24, 40, 180), "lrelu0.2", 1.0), ((1, 9, 8, 180), "relu", 0.1)]
WINDOW_ATTN_CASES = [
    (8, 4, 36, 36, 12, "bias", 1, 0), (16, 4, 64, 64, 32, "bias", 1, 0), (4, 4, 256, 256, 32, "none", 1, 0),
    (2, 2, 1024, 1024, 16, "none", 1, 0), (8, 2, 64, 64, 16, "mask", 4, 0), (6, 3, 49, 49, 15, "mask", 3, 0),
    (6, 4, 36, 64, 12, "bias", 1, 0), (4, 2, 64, 36, 16, "mask", 2, 0), (4, 4, 256, 100, 32, "both", 2, 0),
    (1, 2, 1024, 300, 32, "none", 1, 0), (2, 1, 100, 1024, 16, "bias", 1, 0), (2, 2, 64, 1024, 64, "none", 1, 0),
    (3, 2, 49, 49, 32, "both", 3, 1), (3, 2, 64, 80, 32, "bias", 1, 2), (2, 3, 40, 72, 24, "none", 1, 4),
    (2048, 2, 64, 64, 32, "bias", 1, 0), (600, 1, 256, 256, 32, "none", 1, 0), (8, 2, 36, 36, 48, "mask", 4, 0),
    (256, 4, 256, 256, 32, "none", 1, 0), (1024, 4, 64, 64, 32, "bias", 1, 0), (130, 4, 64, 64, 32, "mask", 65, 0),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,activation,res_scale", RESBLOCK_CASES)
def test_resblock_kernel_matches_plain(dev, dtype, shape, activation, res_scale):
    from studiosr_tpu_torch.ops.cuda.conv3x3 import fused_resblock, resblock_plain

    gen = torch.Generator().manual_seed(sum(shape))
    c = shape[-1]
    x = _randn(gen, *shape).to(dev, dtype)
    ops = [_randn(gen, 3, 3, c, c, scale=(9 * c) ** -0.5), _randn(gen, c, scale=0.5),
           _randn(gen, 3, 3, c, c, scale=(9 * c) ** -0.5), _randn(gen, c, scale=0.1)]
    ops = [t.to(dev, dtype if t.dim() == 4 else torch.float32) for t in ops]
    engagement.reset()
    got = fused_resblock(x, *ops, res_scale=res_scale, activation=activation)
    entry = "resblock_mma_bf16" if dtype == torch.bfloat16 else "resblock_mma_f32" if c > 16 else "resblock_f32"
    assert engagement.counters() == {"fused_resblock": 1}
    assert engagement.entries() == {"fused_resblock": {entry: 1}}
    want = resblock_plain(x.float(), *[t.float() for t in ops], res_scale=res_scale, activation=activation)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("shape,activation,res_scale", RESBLOCK_CASES)
def test_resblock_packed_weights_match_hwio_bitwise(dev, shape, activation, res_scale):
    """bf16 B14 on weights packed once (serving's layout) gives the same bits
    as on HWIO weights packed per call."""
    from studiosr_tpu_torch.ops.cuda.conv3x3 import fused_resblock, pack_conv3x3_weights

    gen = torch.Generator().manual_seed(sum(shape) + 1)
    c = shape[-1]
    x = _randn(gen, *shape).to(dev, torch.bfloat16)
    w1, w2 = (_randn(gen, 3, 3, c, c, scale=(9 * c) ** -0.5).to(dev, torch.bfloat16) for _ in range(2))
    b1, b2 = _randn(gen, c, scale=0.5).to(dev), _randn(gen, c, scale=0.1).to(dev)
    hwio = fused_resblock(x, w1, b1, w2, b2, res_scale=res_scale, activation=activation)
    packed = fused_resblock(x, pack_conv3x3_weights(w1), b1, pack_conv3x3_weights(w2), b2, res_scale=res_scale,
                            activation=activation)
    assert torch.equal(packed, hwio)


def _window_case(gen, bw, heads, n, m, d, offset, dev, dtype):
    """q (bw, heads, n, d) and k, v (bw, heads, m, d): the slices of one
    (bw, max(n, m), 3, heads, d) projection that starts ``offset`` elements
    into its storage, the layout ``_Attention`` hands B15 (unscaled: the
    scores get unit variance from the values' scale)."""
    tok = max(n, m)
    flat = _randn(gen, offset + bw * tok * 3 * heads * d, scale=d**-0.25).to(dev, dtype)
    qkv = flat[offset:].view(bw, tok, 3, heads, d).permute(2, 0, 3, 1, 4)
    return qkv[0][:, :, :n], qkv[1][:, :, :m], qkv[2][:, :, :m]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bw,heads,n,m,d,kind,nw,offset", WINDOW_ATTN_CASES)
def test_window_attn_core_kernel_matches_plain(dev, dtype, bw, heads, n, m, d, kind, nw, offset):
    from studiosr_tpu_torch.ops.attention import attention_plain
    from studiosr_tpu_torch.ops.cuda.window_attn import window_attention

    gen = torch.Generator().manual_seed(bw + n + m + d + nw + offset)
    q, k, v = _window_case(gen, bw, heads, n, m, d, offset, dev, dtype)
    bias = _randn(gen, heads, n, m, scale=2.0).to(dev) if kind in ("bias", "both") else None
    mask = None
    if kind in ("mask", "both"):
        mask = torch.where(torch.rand(nw, n, m, generator=gen) > 0.7, -100.0, 0.0).to(dev)
    engagement.reset()
    got = window_attention(q, k, v, bias=bias, mask=mask)
    entry = "window_attn_flash_bf16" if dtype == torch.bfloat16 else "window_attn_flash_f32"
    assert engagement.counters() == {"window_attention_pallas": 1}
    assert engagement.entries() == {"window_attention_pallas": {entry: 1}}
    want = attention_plain(q.float(), k.float(), v.float(), bias, mask)
    assert got.shape == want.shape == (bw, heads, n, d)
    _assert_close(got, want, dtype)
    again = window_attention(q.contiguous(), k.contiguous(), v.contiguous(), bias=bias, mask=mask)
    assert torch.equal(got, again)  # strides and copy widths change no bit


def test_window_attention_raises_and_keeps_the_oca_cap(dev):
    """B15 takes N, M <= 1024 and raises above. B12 / B13 no longer share a
    cap: above 256 queries (f32 here) they launch their entries under the
    ``_large`` counters and agree with their plain versions."""
    from studiosr_tpu_torch.ops.cuda.oca_core import oca_core_bwd, oca_core_bwd_plain, oca_core_fwd, oca_core_plain
    from studiosr_tpu_torch.ops.cuda.window_attn import window_attention

    q = torch.zeros(1, 1, 1089, 16, device=dev)
    with pytest.raises(NotImplementedError, match="1024"):
        window_attention(q, q, q)
    k = torch.zeros(1, 1, 64, 16, device=dev)
    with pytest.raises(NotImplementedError, match="1024"):
        window_attention(torch.zeros(1, 1, 64, 16, device=dev), q, q)
    with pytest.raises(TypeError):
        window_attention(k.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="tile"):
        window_attention(torch.zeros(3, 1, 64, 16, device=dev), torch.zeros(3, 1, 64, 16, device=dev),
                         torch.zeros(3, 1, 64, 16, device=dev), mask=torch.zeros(2, 64, 64, device=dev))
    gen = torch.Generator().manual_seed(11)
    big = (torch.randn(1, 2, 512, 16, generator=gen) * 0.25).to(dev)
    bias = torch.randn(2, 512, 512, generator=gen).to(dev)
    engagement.reset()
    out = oca_core_fwd(big, big, big, bias)
    grads = oca_core_bwd(big, big, big, bias, big)
    assert engagement.entries() == {"oca_core_fwd_large": {"oca_core_fwd_f32": 1},
                                    "oca_core_bwd_large": {"oca_core_bwd_f32": 1}}
    _assert_close(out, oca_core_plain(big, big, big, bias), torch.float32)
    for got, want in zip(grads, oca_core_bwd_plain(big, big, big, bias, big)):
        _assert_close(got, want, torch.float32)


def test_new_wrappers_launch_on_a_cuda_tensor(dev):
    """No plain fallback on the card: a CUDA tensor launches (and counts) or
    raises, for B14 and B15 alike."""
    from studiosr_tpu_torch.ops.cuda.conv3x3 import fused_resblock
    from studiosr_tpu_torch.ops.cuda.window_attn import window_attention

    x = torch.zeros(1, 8, 8, 4, device=dev)
    w, b = torch.zeros(3, 3, 4, 4, device=dev), torch.zeros(4, device=dev)
    engagement.reset()
    fused_resblock(x, w, b, w, b)
    window_attention(torch.zeros(2, 1, 8, 8, device=dev), torch.zeros(2, 1, 8, 8, device=dev),
                     torch.zeros(2, 1, 8, 8, device=dev))
    assert engagement.counters() == {"fused_resblock": 1, "window_attention_pallas": 1}
    with pytest.raises(ValueError, match="contiguous"):
        fused_resblock(x.transpose(1, 2), w, b, w, b)
    with pytest.raises(TypeError):
        fused_resblock(x.half(), w.half(), b, w.half(), b)
    with pytest.raises(ValueError, match="unknown activation"):
        fused_resblock(x, w, b, w, b, activation="gelu")


def test_small_swinfir_fused_matches_plain_on_the_card(dev):
    from studiosr_tpu_torch import SwinFIR

    model = SwinFIR.build(scale=4, embed_dim=24, depths=[2, 2], num_heads=[2, 2], window_size=8, device=dev)
    images = [np.random.default_rng(i).integers(0, 256, (20, 28, 3), dtype=np.uint8) for i in range(2)]
    plain = model.enable_fused(False).inference_batch(images)
    engagement.reset()
    fused = model.enable_fused(True).inference_batch(images)
    assert engagement.counters() == {"fused_swin_block": 4, "fused_resblock": 3, "fused_upsample_x4": 1}
    for got, want in zip(fused, plain):
        diff = np.abs(got.astype(int) - want.astype(int))
        assert got.shape == (80, 112, 3) and diff.max() <= 1 and (diff > 0).mean() < 0.01


@pytest.mark.parametrize("adaptive", [False, True])
def test_small_maxsr_fused_matches_plain_on_the_card(dev, adaptive):
    """Adaptive at 20 x 28: windows of 5 x 6 on the zero-padded 25 x 36
    map (30 tokens); static: 8 x 8 windows on the reflect-padded 24 x 32."""
    from studiosr_tpu_torch import MaxSR

    model = MaxSR.build(scale=2, adaptive=adaptive, dim=32, dim_head=8, depth=[1, 1], dropout=0.0, device=dev)
    image = np.random.default_rng(5).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    plain = model.enable_fused(False).inference(image)
    engagement.reset()
    fused = model.enable_fused(True).inference(image)
    assert engagement.counters() == {"window_attention_pallas": 4}
    diff = np.abs(fused.astype(int) - plain.astype(int))
    assert fused.shape == (40, 56, 3) and diff.max() <= 1 and (diff > 0).mean() < 0.01



# -- MaxSR's fused training and the conv families ----------------------------------------

# B6 and B7 in bf16 at MaxSR's feed-forward (C 128, hidden 512: six of B7's
# 96-unit chunks, the last 32 wide; eight of B6's 64-unit ones): the step's
# rows (batch 32 of 64 x 64), ragged row counts, without drop-path (MaxSR's
# pairs have none) and with it; every output against the plain version, two
# launches the same bits, each launch through the H100 entry.
MAXSR_MLP_CASES = [(32 * 4096, 0), (1000, 0), (777, 0), (130, 65)]


@pytest.mark.parametrize("rows,rows_per_sample", MAXSR_MLP_CASES)
def test_mlp_h100_kernels_at_maxsr_hidden_512_match_plain(dev, rows, rows_per_sample):
    c, hidden = 128, 512
    gen = torch.Generator().manual_seed(rows + 512)
    ops = _block_operands(gen, c, 4, hidden)[7:]
    ops = [t.to(dev, torch.bfloat16 if i in (2, 4) else torch.float32) for i, t in enumerate(ops)]
    x = _randn(gen, rows, c).to(dev, torch.bfloat16)
    g = _randn(gen, rows, c).to(dev, torch.bfloat16)
    kw = {}
    if rows_per_sample:
        dp = torch.full((rows // rows_per_sample,), 1 / 0.9, device=dev)
        dp[0] = 0.0
        kw = dict(drop_path=dp, rows_per_sample=rows_per_sample)
    engagement.reset()
    out, out2 = fused_mlp_block(x, *ops, **kw), fused_mlp_block(x, *ops, **kw)
    grads, grads2 = mlp_bwd(x, g, *ops[:5], **kw), mlp_bwd(x, g, *ops[:5], **kw)
    assert engagement.entries() == {"fused_mlp_block": {"mlp_block_mma_bf16": 2}, "mlp_bwd": {"mlp_bwd_mma_bf16": 2}}
    _assert_close(out, mlp_block_plain(x.float(), *[t.float() for t in ops], **kw), torch.bfloat16)
    want = mlp_bwd_plain(x.float(), g.float(), *[t.float() for t in ops[:5]], **kw)
    for a, e in zip(grads, want):
        assert a.shape == e.shape
        _assert_close(a, e, torch.bfloat16)
    assert torch.equal(out, out2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))


# B5 and B8 in bf16 at MaxSR's attention pairs (C 128, 4 heads of 32, window
# 8, no shift, zero qkv and proj biases): the static mode's table bias,
# gathered in bf16 as the bf16 step hands it over, and the adaptive mode's
# f32 zero bias; the step's batch 32 of 64 x 64 and a small H != W map.
MAXSR_ATTN_CASES = [("static", (32, 64, 64)), ("adaptive", (32, 64, 64)), ("static", (2, 16, 24)),
                    ("adaptive", (3, 24, 16))]


@pytest.mark.parametrize("mode,shape", MAXSR_ATTN_CASES)
def test_attention_h100_kernels_at_maxsr_geometry_match_plain(dev, mode, shape):
    from studiosr_tpu_torch.ops.windows import gather_rel_bias, relative_position_index

    c, heads, ws = 128, 4, 8
    gen = torch.Generator().manual_seed(shape[0] + len(mode))
    ops = _block_operands(gen, c, heads, 4 * c)[:7]
    ops = [t.to(dev, torch.bfloat16 if i in (2, 4) else torch.float32) for i, t in enumerate(ops)]
    ops[3], ops[5] = torch.zeros_like(ops[3]), torch.zeros_like(ops[5])
    if mode == "static":
        table = _randn(gen, (2 * ws - 1) ** 2, heads, scale=0.5).to(dev, torch.bfloat16)
        ops[6] = gather_rel_bias(table, relative_position_index(ws), heads)
    else:
        ops[6] = torch.zeros(heads, ws * ws, ws * ws, device=dev)
    x = _randn(gen, *shape, c).to(dev, torch.bfloat16)
    g = _randn(gen, *shape, c).to(dev, torch.bfloat16)
    kw = dict(heads=heads, window_size=ws, shift=0)
    engagement.reset()
    out = fused_window_attention_block(x, *ops, **kw)
    grads = attention_bwd(x, g, *ops, **kw)
    assert engagement.entries() == {"fused_window_attention_block": {"window_attention_mma_bf16": 1},
                                    "attention_bwd": {"attn_bwd_mma_bf16": 1}}
    f32 = [t.float() for t in ops]
    _assert_close(out, window_attention_plain(x.float(), *f32, **kw), torch.bfloat16)
    for a, e in zip(grads, attention_bwd_plain(x.float(), g.float(), *f32, **kw)):
        assert a.shape == e.shape
        _assert_close(a, e, torch.bfloat16)


@pytest.mark.parametrize("adaptive", [False, True])
def test_small_maxsr_fused_train_matches_plain_on_the_card(dev, adaptive):
    """A bf16 fused-train step of a narrow MaxSR (C 32, heads of 16) on 64 x
    64 maps: every pair through B5-B8 (4 launches each), the loss and the
    gradients within the bf16 rule of plain autograd in f32 on the same
    bf16 weights."""
    from torch.func import functional_call

    from studiosr_tpu_torch import MaxSR

    model = MaxSR.build(scale=2, adaptive=adaptive, dim=32, dim_head=16, depth=[1, 1], dropout=0.0, device=dev)
    module = model.module.train()
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(7)).to(dev)
    names = [k for k, _ in module.named_parameters()]
    results = []
    for fused, dtype in ((False, torch.float32), (True, torch.bfloat16)):
        module.fused_train = fused
        leaves = {k: p.detach().to(torch.bfloat16).to(dtype).requires_grad_() for k, p in module.named_parameters()}
        engagement.reset()
        out = functional_call(module, leaves, (x.to(torch.bfloat16).to(dtype),))
        loss = out.float().square().mean()
        results.append((loss, torch.autograd.grad(loss, list(leaves.values())), engagement.counters()))
    module.fused_train = False
    assert results[0][2] == {}
    assert results[1][2] == {"fused_window_attention_block": 4, "attention_bwd": 4, "fused_mlp_block": 4,
                             "mlp_bwd": 4}
    assert abs(float(results[1][0]) - float(results[0][0])) <= 2e-2 * abs(float(results[0][0]))
    all_fused = torch.cat([g.float().flatten() for g in results[1][1]])
    all_plain = torch.cat([g.flatten() for g in results[0][1]])
    assert float(torch.linalg.vector_norm(all_fused - all_plain) / torch.linalg.vector_norm(all_plain)) <= 5e-2
    assert len(names) == len(results[1][1])


def test_maxsr_fused_train_raises_on_a_window_the_kernels_do_not_take(dev):
    """An adaptive 36 x 36 map has square windows of 6: the fused step runs
    there (B5 / B8 in the small family, 4 launches each) and its loss and
    gradients are within the bf16 rule of plain autograd in f32. An adaptive
    289 x 289 map has windows of 17, which the kernels did not take until
    their streaming family was written: the fused pair now trains there, B5
    and its backward through the ``_large`` family, 4 launches each."""
    from torch.func import functional_call

    from studiosr_tpu_torch import MaxSR

    model = MaxSR.build(scale=2, adaptive=True, dim=32, dim_head=16, depth=[1, 1], dropout=0.0, device=dev)
    module = model.module.train()
    x = torch.rand(2, 36, 36, 3, generator=torch.Generator().manual_seed(6)).to(dev)
    results = []
    for fused, dtype in ((False, torch.float32), (True, torch.bfloat16)):
        module.fused_train = fused
        leaves = {k: p.detach().to(torch.bfloat16).to(dtype).requires_grad_() for k, p in module.named_parameters()}
        engagement.reset()
        loss = functional_call(module, leaves, (x.to(torch.bfloat16).to(dtype),)).float().square().mean()
        results.append((loss, torch.autograd.grad(loss, list(leaves.values())), engagement.counters()))
    assert results[0][2] == {}
    assert results[1][2] == {"fused_window_attention_block": 4, "attention_bwd": 4, "fused_mlp_block": 4,
                             "mlp_bwd": 4}
    assert abs(float(results[1][0]) - float(results[0][0])) <= 2e-2 * abs(float(results[0][0]))
    all_fused = torch.cat([g.float().flatten() for g in results[1][1]])
    all_plain = torch.cat([g.flatten() for g in results[0][1]])
    assert float(torch.linalg.vector_norm(all_fused - all_plain) / torch.linalg.vector_norm(all_plain)) <= 5e-2
    module.fused_train = True
    engagement.reset()
    out = module(torch.rand(1, 289, 289, 3, generator=torch.Generator().manual_seed(7)).to(dev))
    out.float().square().mean().backward()
    assert out.shape == (1, 578, 578, 3) and bool(torch.isfinite(out).all())
    assert engagement.counters() == {"fused_window_attention_block_large": 4, "attention_bwd_large": 4,
                                     "fused_mlp_block": 4, "mlp_bwd": 4}


@pytest.mark.parametrize("size", [36, 72])
def test_maxsr_fused_train_evaluates_plainly_on_any_window(dev, size):
    """In eval mode (the Trainer's evaluations) a module with the flag on
    serves square adaptive maps of windows 6 and 9 plainly: no kernel
    launched, the flag-off output."""
    from studiosr_tpu_torch import MaxSR

    model = MaxSR.build(scale=2, adaptive=True, dim=32, dim_head=16, depth=[1], dropout=0.1, device=dev)
    x = torch.rand(1, size, size, 3, generator=torch.Generator().manual_seed(size)).to(dev)
    want = model.module(x)
    model.module.fused_train = True
    engagement.reset()
    got = model.module(x)
    assert engagement.counters() == {}
    _assert_close(got, want, torch.float32)


@pytest.mark.parametrize("name", ["srcnn", "espcn", "vdsr", "srresnet", "edsr", "rcan", "han", "imdn"])
def test_small_conv_family_serves_bf16_on_the_card(dev, name):
    """Each conv family at narrow widths, bf16 against its f32 forward on the
    card (relative L2 2e-2), with no kernel of the port launched."""
    from studiosr_tpu_torch.zoo.registry import get_model_class

    small = {"srcnn": {}, "espcn": dict(channels=16), "vdsr": dict(channels=16, n_layers=3),
             "srresnet": dict(channels=16, num_rcb=2), "edsr": dict(n_feats=16, n_resblocks=2),
             "rcan": dict(n_feats=16, n_resblocks=2, n_resgroups=2, reduction=4),
             "han": dict(n_feats=16, n_resblocks=2, n_resgroups=2, reduction=4), "imdn": dict(n_feats=16, n_modules=2)}
    model = get_model_class(name).build(scale=4, **small[name], device=dev)
    x = torch.rand(1, 20, 28, 3, generator=torch.Generator().manual_seed(8))
    want = model(x)
    engagement.reset()
    got = model.half()(x)
    assert engagement.counters() == {}
    assert got.shape == (1, 80, 112, 3)
    _assert_close(got, want, torch.bfloat16)


def test_maxsr_fused_serving_declines_above_1024_tokens(dev):
    """C6: MaxSR adaptive with ``enable_fused(True)`` serves a 1025² LR
    image (windows of 33² = 1089 tokens, above B15's 1024): each of the
    trio's two attention calls is a recorded structural decline, nothing
    launches, and the output is the unfused route's, bit for bit. Narrowed
    to dim 32, one head, one trio: the plain core's f32 scores take 5.2 GB
    an attention call."""
    from studiosr_tpu_torch import MaxSR

    model = MaxSR.build(scale=4, adaptive=True, dim=32, dim_head=32, depth=[1], device=dev).half()
    image = np.random.default_rng(0).integers(0, 256, (1025, 1025, 3), dtype=np.uint8)
    engagement.reset()
    with pytest.warns(UserWarning, match="declined by design"):
        fused = model.enable_fused(True).inference(image)
    assert engagement.counters() == {}
    assert engagement.declines()["window_attention_pallas"]["count"] == 2
    plain = model.enable_fused(False).inference(image)
    assert fused.shape == (4100, 4100, 3) and fused.dtype == np.uint8
    assert np.array_equal(fused, plain)


def _paeth_div2k(root, side=600):
    """One seeded HR image (Paeth rows) and its X2 / X3 / X4 in DIV2K's layout."""
    from studiosr_tpu_torch.utils.png import write_png

    hr = np.random.default_rng(1).integers(0, 256, (side, side, 3), dtype=np.uint8)
    (root / "DIV2K" / "DIV2K_train_HR").mkdir(parents=True)
    write_png(str(root / "DIV2K" / "DIV2K_train_HR" / "0001.png"), hr, row_filter=4)
    for s in (2, 3, 4):
        d = root / "DIV2K" / "DIV2K_train_LR_bicubic" / f"X{s}"
        d.mkdir(parents=True)
        write_png(str(d / f"0001x{s}.png"), hr[::s, ::s], row_filter=4)


def test_trainer_on_the_card_takes_the_native_host_routes_and_traces_the_kernels(dev, tmp_path):
    """Two steps of a SwinIR of the main path's widths (two blocks) on the
    card from a prepared DIV2K corpus with ``profile_dir``: every sample
    through the native crop-augment, every PNG through the native unfilter,
    B5-B8 launched twice each through their bf16 H100 entries, and the
    Chrome trace names their CUDA kernels."""
    import json

    from studiosr_tpu_torch import DIV2K, Trainer, native

    _paeth_div2k(tmp_path / "data")
    native.reset_counters()
    dataset = DIV2K(str(tmp_path / "data"), size=16, scale=4, transform=True, to_tensor=True)
    model = SwinIR.build(scale=4, embed_dim=180, depths=[2], num_heads=[6], window_size=8, mlp_ratio=2.0, device=dev)
    trainer = Trainer(model, dataset, batch_size=4, num_workers=2, max_iters=2, eval_interval=2,
                      ckpt_path=str(tmp_path / "ckpt"), profile_dir=str(tmp_path / "trace"))
    engagement.reset()
    trainer.run()
    torch.cuda.synchronize()
    routes = native.counters()
    # the loader prefetches ahead of the steps: at least the 8 samples taken
    assert set(routes["crop_augment"]) == {"native"} and routes["crop_augment"]["native"] >= 8
    assert set(routes["unfilter"]) == {"native"}
    assert trainer.bfloat16 and trainer.fused_train
    kernels = {"fused_window_attention_block": "wa_attn_kernel", "fused_mlp_block": "mf_kernel",
               "mlp_bwd": "mb_prod_kernel", "attention_bwd": "am_attn_kernel"}
    assert engagement.counters() == {name: 4 for name in kernels}
    (trace,) = (tmp_path / "trace").glob("*.json")
    names = [e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"] if e.get("cat") == "kernel"]
    for name, kernel in kernels.items():
        assert sum(kernel in n for n in names) >= 2, (name, kernel)


# C7: fused SwinIR / SwinFIR serving at windows other than 8 (B5 then B6 for
# each Swin block; B1 at window 8). Windows 2-7 take B5's one-tile family,
# 9-16 its multi-tile one, 17 up its streaming one; C 24 with 2 heads of 12
# (the bf16 H100 kernels' geometry rule takes it).
SERVING_WINDOWS = [2, 3, 4, 5, 6, 7, 9, 10, 12, 16, 20, 24]


def _rel_l2(got, want):
    return float(torch.linalg.vector_norm(got.double() - want.double()) / torch.linalg.vector_norm(want.double()))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["swinir", "swinfir"])
@pytest.mark.parametrize("ws", SERVING_WINDOWS)
def test_fused_serving_at_every_window_matches_plain(dev, ws, name, dtype):
    """The fused forward against the plain f32 forward of the same weights
    (relative L2 1e-4 in f32, 2e-2 in bf16, as chip_smoke.py's end-to-end
    rule), B5 and B6 launched once a Swin block and B1 never."""
    from studiosr_tpu_torch import SwinFIR

    cls = SwinFIR if name == "swinfir" else SwinIR
    model = cls.build(scale=4, embed_dim=24, depths=[2, 2], num_heads=[2, 2], window_size=ws, device=dev)
    x = torch.rand(1, 20, 28, 3, generator=torch.Generator().manual_seed(ws)).to(dev)
    want = model(x)
    if dtype == torch.bfloat16:
        model.half()
    engagement.reset()
    got = model.enable_fused(True)(x)
    b5 = "fused_window_attention_block" + window_family(ws)
    counts = engagement.counters()
    assert counts[b5] == 4 and counts["fused_mlp_block"] == 4 and "fused_swin_block" not in counts
    assert _rel_l2(got, want) <= (1e-4 if dtype == torch.float32 else 2e-2)


def test_fused_serving_above_window_16_raises_before_any_launch(dev):
    """Window 24 raised here until B5's streaming family was written; now
    the bf16 fused forward serves through it (B5 and B6 once a block, B1
    never), within 2e-2 of the plain f32 forward."""
    model = SwinIR.build(scale=4, embed_dim=24, depths=[2, 2], num_heads=[2, 2], window_size=24, device=dev)
    x = torch.rand(1, 24, 24, 3, generator=torch.Generator().manual_seed(24)).to(dev)
    want = model(x)
    model.half().enable_fused(True)
    engagement.reset()
    got = model(x)
    assert engagement.counters() == {"fused_window_attention_block_large": 4, "fused_mlp_block": 4,
                                     "fused_conv3x3": 3, "fused_upsample_x4": 1}
    assert got.shape == (1, 96, 96, 3) and _rel_l2(got, want) <= 2e-2


def test_window_8_still_serves_through_b1(dev):
    """SwinIR classical x4 at full width, window 8: 36 B1 launches a forward, no B5 or B6."""
    model = SwinIR.build(scale=4, device=dev).half().enable_fused(True)
    engagement.reset()
    model(torch.rand(1, 32, 32, 3, device=dev))
    assert engagement.counters() == {"fused_swin_block": 36, "fused_conv3x3": 7, "fused_upsample_x4": 1}


# HAT at every window (B10, B12 and B13 beyond windows 8 and 16). B12 / B13
# at the OCA geometries of HAT's windows 4, 12, 24 and 32 at overlap 0.5 (nq
# ws^2, nk (1.5 ws)^2: 16 | 36, 144 | 324, 576 | 1296, 1024 | 2304), window
# 24 at head dim 16 and 37 windows of 6 heads, window 20 at an odd head
# dim: up to 256 queries and 576 keys the entries the windows up to 16 take,
# above them the large entries in bf16 (the streaming family) and
# ``oca_core.cu`` in f32, counted under ``_large``; against the plain
# versions, the backward's bits repeatable, a bf16 bias read as it is.
HAT_OCA_WINDOWS = [(3, 2, 4, 30), (3, 2, 12, 30), (3, 2, 24, 30), (2, 2, 32, 30), (5, 3, 24, 16), (2, 2, 20, 7),
                   (37, 6, 24, 30)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bw,heads,ws,d", HAT_OCA_WINDOWS)
def test_oca_core_at_every_hat_window(dev, dtype, bw, heads, ws, d):
    from studiosr_tpu_torch.ops.cuda.oca_core import (
        counter, oca_core_bwd, oca_core_bwd_plain, oca_core_fwd, oca_core_plain,
    )

    owin, _ = overlap_window(ws, 0.5)
    nq, nk = ws * ws, owin * owin
    gen = torch.Generator().manual_seed(bw + ws + d)
    q, k, v, bias, g = _oca_case(gen, bw, heads, nq, nk, d, dev, dtype)
    kind = bwd_kind = "f32"
    if dtype == torch.bfloat16:
        kind = bwd_kind = "large_mma_bf16" if counter("", nq, nk) == "_large" else "mma_bf16"  # every case has d <= 32
    elif counter("", nq, nk) != "_large":
        bwd_kind = "mma_f32"  # f32 B13 up to window 16 on its 3xTF32 entry
    engagement.reset()
    out = oca_core_fwd(q, k, v, bias)
    grads = oca_core_bwd(q, k, v, bias, g)
    again = oca_core_bwd(q, k, v, bias, g)
    assert engagement.entries() == {counter("oca_core_fwd", nq, nk): {f"oca_core_fwd_{kind}": 1},
                                    counter("oca_core_bwd", nq, nk): {f"oca_core_bwd_{bwd_kind}": 2}}
    assert (ws > 16) == ("_large" in counter("oca_core_fwd", nq, nk))
    _assert_close(out, oca_core_plain(q.float(), k.float(), v.float(), bias), dtype)
    want = oca_core_bwd_plain(q.float(), k.float(), v.float(), bias, g.float())
    for a, e in zip(grads, want):
        assert a.shape == e.shape
        _assert_close(a, e, dtype)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # no atomic sums: bitwise repeatable
    if dtype == torch.bfloat16:
        b16 = bias.to(torch.bfloat16)
        assert torch.equal(oca_core_fwd(q, k, v, b16), oca_core_fwd(q, k, v, b16.float()))


# B10 at every window HAT can be built with (an even key margin): windows 4,
# 5, 12 and 20 (ws^2 not a multiple of 64: padded to whole 64-token tiles),
# 8 and 16, 24 and 32 (more than 576 keys: the attention pass streams
# them), at overlap 0.5 and 1.0, HAT's 180 / 6 at window 12; bf16 on the
# kernels written for the H100 (the blob and dense weights give the same
# bits, two launches the same bits), f32 and bf16 at head dim 48 on ocab.cu
# (its last 64-query chunk of a window partial at 12).
HAT_OCAB_WINDOWS = [(48, 2, (1, 8, 12), 4, 0.5), (32, 2, (1, 10, 15), 5, 0.5), (32, 2, (2, 16, 24), 8, 0.5),
                    (180, 6, (1, 24, 36), 12, 0.5), (24, 3, (1, 24, 24), 12, 1.0), (32, 2, (1, 32, 48), 16, 0.5),
                    (32, 2, (1, 40, 40), 20, 0.5), (48, 2, (1, 48, 72), 24, 0.5), (48, 2, (1, 64, 64), 32, 0.5),
                    (96, 2, (1, 24, 36), 12, 0.5), (96, 2, (1, 48, 48), 24, 0.5)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,heads,shape,ws,overlap", HAT_OCAB_WINDOWS)
def test_ocab_at_every_hat_window(dev, dtype, c, heads, shape, ws, overlap):
    gen = torch.Generator().manual_seed(c + ws + shape[0])
    owin, _ = overlap_window(ws, overlap)
    blk = _block_operands(gen, c, heads, 2 * c, ws=ws)
    bias_dtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    ops = blk[:6] + [_randn(gen, heads, ws * ws, owin * owin, scale=0.5).to(bias_dtype)] + blk[7:]
    ops = [t.to(dev, dtype if i in (2, 4, 9, 11) else (bias_dtype if i == 6 else torch.float32))
           for i, t in enumerate(ops)]
    x = _randn(gen, *shape, c).to(dev, dtype)
    kw = dict(heads=heads, window_size=ws, overlap_ratio=overlap)
    engagement.reset()
    got = fused_ocab_block(x, *ops, **kw)
    mma = dtype == torch.bfloat16 and ocab_mma_takes(c, heads, ws, overlap, 2 * c)
    entry = "ocab_mma_bf16" if mma else ("ocab_bf16" if dtype == torch.bfloat16 else "ocab_f32")
    assert engagement.entries() == {"fused_ocab_block": {entry: 1}}
    assert mma == (dtype == torch.bfloat16 and c // heads <= 32)
    _assert_close(got, ocab_plain(x.float(), *[t.float() for t in ops], **kw), dtype)
    if mma:
        served = list(ops)
        served[2], served[4], served[9], served[11] = (pack_ocab_block(ops[2], ops[4], ops[9], ops[11], heads), None,
                                                       None, None)
        assert torch.equal(got, fused_ocab_block(x, *served, **kw))
        assert torch.equal(got, fused_ocab_block(x, *ops, **kw))


# C8: HAT serves fused in bf16 at every window from 2 to 32 with an even key
# margin at overlap 0.5 (int(ws / 2) even), B10 on the kernels written for
# the H100; embed 32, 2 heads (head dim 16), one group of one block.
HAT_SERVING_WINDOWS = [ws for ws in range(2, 33) if int(ws * 0.5) % 2 == 0]


@pytest.mark.parametrize("ws", HAT_SERVING_WINDOWS)
def test_hat_serves_fused_at_every_even_margin_window(dev, ws):
    """The bf16 fused forward against the plain f32 forward of the same
    weights (relative L2 2e-2, chip_smoke.py's end-to-end rule), B10 once
    through ``ocab_mma_bf16``."""
    model = HAT.build(scale=4, embed_dim=32, depths=[1], num_heads=[2], window_size=ws, device=dev)
    x = torch.rand(1, 20, 28, 3, generator=torch.Generator().manual_seed(ws)).to(dev)
    want = model(x)
    model.half().enable_fused(True)
    engagement.reset()
    got = model(x)
    assert engagement.entries()["fused_ocab_block"] == {"ocab_mma_bf16": 1}
    assert got.shape == (1, 80, 112, 3) and bool(torch.isfinite(got).all())
    assert _rel_l2(got, want) <= 2e-2


# C9: HAT trains fused at windows 12 (ws^2 padded to whole tiles: B5's
# two-to-four-tile family, B12 / B13's first entries) and 24 (the streaming
# families of B5 / B9 and B12 / B13), f32 against plain autograd.
@pytest.mark.parametrize("ws", [12, 24])
def test_small_hat_fused_train_at_windows_12_and_24(dev, ws):
    model = HAT.build(scale=4, embed_dim=32, depths=[2], num_heads=[2], window_size=ws, drop_path_rate=0.5,
                      device=dev)
    module = model.module.train()
    x = torch.rand(2, 2 * ws, 2 * ws, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    gt = torch.rand(2, 8 * ws, 8 * ws, 3, generator=torch.Generator().manual_seed(2)).to(dev)
    results = []
    for fused in (False, True):
        module.fused_train = fused
        module.zero_grad()
        engagement.reset()
        out = module(x, generator=torch.Generator().manual_seed(3))
        loss = torch.mean(torch.abs(out - gt))
        loss.backward()
        torch.cuda.synchronize()
        results.append((loss.item(), {k: p.grad.clone() for k, p in module.named_parameters()},
                        engagement.counters()))
    fam, oca = window_family(ws), "_large" if ws > 16 else ""
    assert results[0][2] == {}
    assert results[1][2] == {"fused_window_attention_block" + fam: 2, "attention_bwd" + fam: 2, "fused_mlp_block": 2,
                             "mlp_bwd": 2, "oca_core_fwd" + oca: 1, "oca_core_bwd" + oca: 1}
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-5)
    for k, g in results[0][1].items():
        assert float((results[1][1][k] - g).abs().max()) <= 1e-4 * float(g.abs().max()) + 1e-6, k


# A20: serving over a mesh of slots in one process, each slot its own
# replica, host thread and CUDA stream; the bytes are the mesh-less ones.
@pytest.mark.parametrize("family", ["swinir", "hat"])
def test_tiled_over_two_slots_of_one_card_gives_the_meshless_bytes(dev, family):
    from studiosr_tpu_torch.parallel import get_mesh, tiled_inference

    cls = SwinIR if family == "swinir" else HAT
    model = cls.build(scale=4, embed_dim=32, depths=[2], num_heads=[2], window_size=8, device=dev, seed=0)
    model.half().enable_fused(True)
    image = np.random.default_rng(4).integers(0, 256, (80, 72, 3), dtype=np.uint8)
    mesh = get_mesh([torch.device("cuda", torch.cuda.current_device())] * 2)
    for loop in (False, True):
        engagement.reset()
        got = tiled_inference(model, image, tile=32, tile_overlap=8, tile_batch=4, mesh=mesh, device_loop=loop)
        assert engagement.counters(), "the mesh route launched no kernel"
        want = tiled_inference(model, image, tile=32, tile_overlap=8, tile_batch=4, device_loop=loop)
        np.testing.assert_array_equal(got, want)


# C10: a kernel launches on its operands' card, whichever card is current.
def test_kernels_launch_on_their_operands_card(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    gen = torch.Generator().manual_seed(0)
    x, w, b = _randn(gen, 1, 24, 24, 32), _randn(gen, 3, 3, 32, 32, scale=0.1), _randn(gen, 32, scale=0.1)
    want = fused_conv3x3(*(t.to("cuda:0") for t in (x, w, b)))
    with torch.cuda.device(0):
        got = fused_conv3x3(*(t.to("cuda:1") for t in (x, w, b)))
        assert torch.cuda.current_device() == 0
    torch.testing.assert_close(got.cpu(), want.cpu(), rtol=0, atol=0)
