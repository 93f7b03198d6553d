"""Plain versions of the port's CUDA kernels vs the Pallas kernels.

Each port kernel wrapper takes its plain PyTorch version on CPU tensors;
the JAX side runs the Pallas kernel in interpret mode. Inputs and weights
come from one numpy generator and go to both. f32 tolerances as in
tests/ops/test_fused_swin.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.ops.pallas.conv3x3 import fused_conv3x3 as jax_fused_conv3x3
from studiosr_tpu.ops.pallas.swin_block import fused_swin_block as jax_fused_swin_block
from studiosr_tpu.ops.pallas.upsampler import fused_upsample_x4 as jax_fused_upsample_x4
from studiosr_tpu.ops.windows import calculate_mask
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.conv3x3 import fused_conv3x3, parse_activation
from studiosr_tpu_torch.ops.cuda.swin_block import fused_swin_block
from studiosr_tpu_torch.ops.cuda.upsampler import fused_upsample_x4

torch.set_num_threads(2)

ATOL, RTOL = 5e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _block_operands(rng, c, heads, ws, hidden):
    n = ws * ws
    f = lambda *s, scale=1.0: (rng.standard_normal(s, dtype=np.float32) * scale).astype(np.float32)
    return dict(
        ln1_w=1.0 + f(c, scale=0.1), ln1_b=f(c, scale=0.1),
        wqkv=f(c, 3 * c, scale=c**-0.5), bqkv=f(3 * c, scale=0.1),
        wproj=f(c, c, scale=c**-0.5), bproj=f(c, scale=0.1),
        bias=f(heads, n, n, scale=0.5),
        ln2_w=1.0 + f(c, scale=0.1), ln2_b=f(c, scale=0.1),
        w1=f(c, hidden, scale=c**-0.5), b1=f(hidden, scale=0.1),
        w2=f(hidden, c, scale=hidden**-0.5), b2=f(c, scale=0.1),
    )


@pytest.mark.parametrize("shift", [0, 4])
def test_swin_block_plain_matches_pallas(shift):
    """B1 at C 32, 2 heads, ws 8 on a 16x24 map (windows both ways). The
    shifted JAX block is roll(+s) . fused_swin_block(roll(x, -s), mask)."""
    rng = np.random.default_rng(shift)
    c, heads, ws, hidden = 32, 2, 8, 64
    x = rng.standard_normal((2, 16, 24, c), dtype=np.float32)
    ops = _block_operands(rng, c, heads, ws, hidden)
    mask = jnp.asarray(calculate_mask((16, 24), ws, shift)) if shift else None
    jx = jnp.roll(jnp.asarray(x), (-shift, -shift), axis=(1, 2))
    want = jax_fused_swin_block(
        jx, ops["ln1_w"], ops["ln1_b"], ops["wqkv"], ops["bqkv"], ops["wproj"], ops["bproj"], ops["bias"], mask,
        ops["ln2_w"], ops["ln2_b"], ops["w1"], ops["b1"], ops["w2"], ops["b2"],
        heads=heads, window_size=ws, interpret=True,
    )
    want = np.asarray(jnp.roll(want, (shift, shift), axis=(1, 2)))
    got = fused_swin_block(_t(x), **{k: _t(v) for k, v in ops.items()}, heads=heads, window_size=ws, shift=shift)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize(
    "cin,cout,activation,residual,with_extra",
    [
        (8, 12, None, False, False),
        (8, 12, "relu", False, False),
        (8, 12, "lrelu0.2", False, False),
        (8, 8, "lrelu", True, False),
        (12, 12, None, False, True),
        (12, 12, "relu", True, True),
    ],
)
def test_conv3x3_plain_matches_pallas(cin, cout, activation, residual, with_extra):
    rng = np.random.default_rng(cin + cout)
    x = rng.standard_normal((2, 16, 12, cin), dtype=np.float32)
    w = (rng.standard_normal((3, 3, cin, cout), dtype=np.float32) * 0.2).astype(np.float32)
    b = rng.standard_normal(cout, dtype=np.float32)
    extra = rng.standard_normal((2, 16, 12, cout), dtype=np.float32) if with_extra else None
    want = jax_fused_conv3x3(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), activation=activation, residual=residual,
        extra=None if extra is None else jnp.asarray(extra), interpret=True,
    )
    got = fused_conv3x3(_t(x), _t(w), _t(b), activation, residual, None if extra is None else _t(extra))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_upsample_x4_plain_matches_pallas():
    rng = np.random.default_rng(7)
    cin, n_colors = 16, 3
    x = rng.standard_normal((1, 16, 16, cin), dtype=np.float32)
    f = lambda *s, scale: (rng.standard_normal(s, dtype=np.float32) * scale).astype(np.float32)
    ws_ = [f(3, 3, cin, 4 * cin, scale=0.1), f(4 * cin, scale=0.1), f(3, 3, cin, 4 * cin, scale=0.1),
           f(4 * cin, scale=0.1), f(3, 3, cin, n_colors, scale=0.1), f(n_colors, scale=0.1)]
    want = jax_fused_upsample_x4(jnp.asarray(x), *[jnp.asarray(a) for a in ws_], interpret=True)
    assert want is not None
    got = fused_upsample_x4(_t(x), *[_t(a) for a in ws_])
    assert tuple(got.shape) == (1, 64, 64, n_colors)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    engagement.reset()
    x = torch.zeros(1, 8, 8, 4)
    fused_conv3x3(x, torch.zeros(3, 3, 4, 4), torch.zeros(4))
    assert engagement.counters() == {}


@pytest.mark.parametrize(
    "kind,want", [(None, (None, 0.0)), ("relu", ("relu", 0.0)), ("lrelu", ("lrelu", 0.01)), ("lrelu0.2", ("lrelu", 0.2))]
)
def test_parse_activation(kind, want):
    assert parse_activation(kind) == want
    with pytest.raises(ValueError):
        parse_activation("gelu")
