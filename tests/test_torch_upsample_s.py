"""B4, the x2 / x3 tail, and SwinIR / HAT fused at x2 / x3, vs the JAX
package on the CPU (f32; the JAX kernels in interpret mode).

The Pallas kernel takes maps whose sides are multiples of 8 (its tile); at
a ragged size it declines (returns None) and the port's plain version is
held against the reference chain conv -> pixel_shuffle -> conv there. The
model tests serve the trained x2 / x3 fixtures through both packages' fused
forwards at an input that is not a window multiple.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.ops.pallas.upsampler import fused_upsample_s as jax_fused_upsample_s
from studiosr_tpu.ops.pixel_shuffle import pixel_shuffle as jax_pixel_shuffle
from studiosr_tpu.zoo.registry import load_model as jax_load_model
from studiosr_tpu_torch.ops.cuda.upsampler import fused_upsample_s, upsample_s_plain
from studiosr_tpu_torch.zoo import load_model

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "quality")
ATOL, RTOL = 5e-5, 1e-4


def _operands(rng, cin, s, batch, h, w):
    f = lambda *shape, scale=1.0: (rng.standard_normal(shape, dtype=np.float32) * scale).astype(np.float32)  # noqa
    return [f(batch, h, w, cin), f(3, 3, cin, s * s * cin, scale=(9 * cin) ** -0.5), f(s * s * cin, scale=0.1),
            f(3, 3, cin, 3, scale=(9 * cin) ** -0.5), f(3, scale=0.1)]


def _jax_chain(x, w0, b0, w2, b2, s):
    conv = lambda a, w, b: jax.lax.conv_general_dilated(  # noqa: E731
        a, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"), precision="highest") + b
    return np.asarray(conv(jax_pixel_shuffle(conv(jnp.asarray(x), w0, b0), s), w2, b2))


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("batch", [1, 2])
def test_plain_tail_matches_pallas_kernel(s, batch):
    """cin 16 at 16 x 24 (tile 8); batch 2 maps over the batch in JAX."""
    ops = _operands(np.random.default_rng(s + 10 * batch), 16, s, batch, 16, 24)
    want = jax_fused_upsample_s(*[jnp.asarray(a) for a in ops], s=s, interpret=True)
    got = fused_upsample_s(*[torch.from_numpy(a) for a in ops], s)
    assert tuple(got.shape) == (batch, 16 * s, 24 * s, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=RTOL)


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("batch", [1, 2])
def test_plain_tail_matches_reference_chain_at_a_ragged_size(s, batch):
    """cin 16 at 11 x 13, where the Pallas kernel declines."""
    ops = _operands(np.random.default_rng(s + 20 * batch), 16, s, batch, 11, 13)
    assert jax_fused_upsample_s(*[jnp.asarray(a) for a in ops], s=s, interpret=True) is None
    got = upsample_s_plain(*[torch.from_numpy(a) for a in ops], s)
    np.testing.assert_allclose(got.numpy(), _jax_chain(*ops, s), atol=1e-5, rtol=RTOL)


def test_tail_rejects_other_scales():
    ops = [torch.from_numpy(a) for a in _operands(np.random.default_rng(0), 4, 2, 1, 4, 4)]
    with pytest.raises(ValueError, match="scale 4"):
        fused_upsample_s(*ops, 4)


@pytest.mark.parametrize("name,scale", [("swinir", 2), ("swinir", 3), ("hat", 2), ("hat", 3)])
def test_fused_x2_x3_matches_the_jax_fused_forward(name, scale):
    """The trained fixture (embed 32, window 8) through both packages' fused
    forwards at 20 x 28, padded to 24 x 32; SwinIR pads by flip, HAT by
    reflect, and the output is cropped back to 20s x 28s."""
    ckpt = os.path.join(FIXTURES, f"{name}_x{scale}_ckpt")
    jax_model = jax_load_model(ckpt, name).enable_fused(True)
    model = load_model(ckpt, name, device="cpu").enable_fused(True)
    x = np.random.default_rng(scale).random((1, 20, 28, 3), dtype=np.float32)
    want = np.asarray(jax_model(jnp.asarray(x)))
    got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 20 * scale, 28 * scale, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
