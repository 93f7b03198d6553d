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

from studiosr_tpu_torch import SwinIR, resolve_device
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.conv3x3 import conv3x3_plain, fused_conv3x3
from studiosr_tpu_torch.ops.cuda.swin_block import fused_swin_block, swin_block_plain
from studiosr_tpu_torch.ops.cuda.upsampler import fused_upsample_x4, upsample_x4_plain

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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,heads,shape,shift", [(32, 2, (2, 16, 24), 0), (32, 2, (2, 16, 24), 4), (180, 6, (1, 24, 16), 4)])
def test_swin_block_kernel_matches_plain(dev, dtype, c, heads, shape, shift):
    gen = torch.Generator().manual_seed(c + shift)
    ops = _block_operands(gen, c, heads, 2 * c)
    x = _randn(gen, *shape, c).to(dev, dtype)
    # weights in the map's dtype, LayerNorm weights, biases and the rel-pos bias in f32
    ops = [t.to(dev, dtype if i in (2, 4, 9, 11) else torch.float32) for i, t in enumerate(ops)]
    got = fused_swin_block(x, *ops, heads=heads, window_size=8, shift=shift)
    want = swin_block_plain(x.float(), *[t.float() for t in ops], heads=heads, window_size=8, shift=shift)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "cin,cout,activation,residual,with_extra",
    [
        (8, 12, None, False, False),
        (20, 70, "relu", False, True),
        (12, 12, "lrelu0.2", True, True),
        (64, 3, None, False, False),
        (180, 180, "lrelu", False, True),
    ],
)
def test_conv3x3_kernel_matches_plain(dev, dtype, cin, cout, activation, residual, with_extra):
    gen = torch.Generator().manual_seed(cin * cout)
    x = _randn(gen, 2, 13, 21, cin).to(dev, dtype)
    w = _randn(gen, 3, 3, cin, cout, scale=(9 * cin) ** -0.5).to(dev, dtype)
    b = _randn(gen, cout, scale=0.1).to(dev)
    extra = _randn(gen, 2, 13, 21, cout).to(dev, dtype) if with_extra else None
    got = fused_conv3x3(x, w, b, activation, residual, extra)
    want = conv3x3_plain(x.float(), w.float(), b, activation, residual, None if extra is None else extra.float())
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 12, 10, 16), (2, 8, 8, 64)])
def test_upsample_x4_kernel_matches_plain(dev, dtype, shape):
    gen = torch.Generator().manual_seed(shape[-1])
    cin = shape[-1]
    x = _randn(gen, *shape).to(dev, dtype)
    ops = [
        _randn(gen, 3, 3, cin, 4 * cin, scale=(9 * cin) ** -0.5), _randn(gen, 4 * cin, scale=0.1),
        _randn(gen, 3, 3, cin, 4 * cin, scale=(9 * cin) ** -0.5), _randn(gen, 4 * cin, scale=0.1),
        _randn(gen, 3, 3, cin, 3, scale=(9 * cin) ** -0.5), _randn(gen, 3, scale=0.1),
    ]
    ops = [t.to(dev, dtype if t.dim() == 4 else torch.float32) for t in ops]
    got = fused_upsample_x4(x, *ops)
    assert tuple(got.shape) == (shape[0], 4 * shape[1], 4 * shape[2], 3)
    want = upsample_x4_plain(x.float(), *[t.float() for t in ops])
    _assert_close(got, want, dtype)


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
