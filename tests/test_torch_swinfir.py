"""Port SwinFIR (eager, fused serving with the plain B14, one training
gradient) and B14's plain version vs the JAX package on the CPU, f32."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.models.swinfir import SwinFIR as JaxSwinFIR
from studiosr_tpu.ops.pallas.conv3x3 import fused_resblock as jax_fused_resblock
from studiosr_tpu_torch import SwinFIR
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.conv3x3 import fused_resblock, resblock_plain
from studiosr_tpu_torch.zoo import jax_params_to_state_dict, load_jax_params

torch.set_num_threads(2)

SMALL = dict(embed_dim=24, depths=[2], num_heads=[2], window_size=8, mlp_ratio=2.0)  # one group: unshifted, shifted
ATOL, RTOL = 2e-4, 1e-4
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "quality")
SWINFIR_CKPT = os.path.join(FIXTURES, "swinfir_ckpt")


def _pair(**kw):
    """A JAX SwinFIR and the port's, holding the same weights."""
    jax_model = JaxSwinFIR.build(**kw)
    model = SwinFIR.build(**kw, device="cpu")
    load_jax_params(model.module, jax_model.variables["params"])
    return jax_model, model


def _input(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_eager_swinfir_matches_linen(scale):
    jax_model, model = _pair(scale=scale, **SMALL)
    for i, (h, w) in enumerate([(8, 8), (12, 12), (20, 24)]):
        x = _input((1, h, w, 3), seed=i)
        want = np.asarray(jax_model(jnp.asarray(x)))
        got = model(torch.from_numpy(x)).numpy()
        assert got.shape == (1, h * scale, w * scale, 3)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=f"{h}x{w}")


@pytest.mark.parametrize("hw", [(12, 12), (20, 24)])
def test_fused_serving_matches_jax_fused(hw):
    """The fused route (plain B1 / B14 / B3 on the CPU) against the JAX
    package's ``enable_fused(True)``: jnp.fft and the interpret-mode
    resblock there; 20 x 24 pads to 24 x 32 (even), 12 x 12 to 16 x 16."""
    jax_model, model = _pair(scale=4, **SMALL)
    x = _input((1, *hw, 3), seed=5)
    want = np.asarray(jax_model.enable_fused(True)(jnp.asarray(x)))
    engagement.reset()
    got = model.enable_fused(True)(torch.from_numpy(x)).numpy()
    assert engagement.counters() == {}  # the CPU takes the plain versions, which count nothing
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, model.enable_fused(False)(torch.from_numpy(x)).numpy(), atol=ATOL, rtol=RTOL)


def test_inference_uint8_matches_jax():
    jax_model, model = _pair(scale=2, **SMALL)
    image = np.random.default_rng(6).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    want = jax_model.enable_fused(True).inference(image)
    got = model.enable_fused(True).inference(image)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape == (40, 56, 3) and diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_fused_train_gradients_match_jax():
    """One f32 training forward / backward: loss and every gradient by name
    against ``SwinIRModule(fused_train=True)`` with the SFB hooks (drop-path
    off, so no random draws differ)."""
    jax_model, model = _pair(scale=2, drop_path_rate=0.0, **SMALL)
    x = _input((2, 16, 16, 3), seed=7)
    gt = _input((2, 32, 32, 3), seed=8)
    fused = jax_model.module.clone(fused_train=True)

    def loss(params):
        out = fused.apply({"params": params}, jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean(jnp.abs(out - jnp.asarray(gt)))

    # jit: faster than eager
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(jax_model.variables["params"])
    want = jax_params_to_state_dict(want_grads)
    module = model.module.train()
    module.fused_train = True
    got_loss = torch.mean(torch.abs(module(torch.from_numpy(x)) - torch.from_numpy(gt)))
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    grads = {k: p.grad.numpy() for k, p in module.named_parameters()}
    assert sorted(grads) == sorted(want)
    assert any("conv.F.fu.conv_layer" in k for k in grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, want[k], atol=2e-5, rtol=1e-3, err_msg=k)


def _resblock_case(seed, b, h, w, c):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c), dtype=np.float32)
    w1 = rng.standard_normal((3, 3, c, c), dtype=np.float32) * (9 * c) ** -0.5
    w2 = rng.standard_normal((3, 3, c, c), dtype=np.float32) * (9 * c) ** -0.5
    b1 = rng.standard_normal(c, dtype=np.float32) * 0.5  # act(b1) is nonzero in the padding
    b2 = rng.standard_normal(c, dtype=np.float32) * 0.1
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("activation", ["relu", "lrelu0.2"])
@pytest.mark.parametrize("res_scale", [1.0, 0.1])
@pytest.mark.parametrize("shape", [(1, 16, 24, 8), (2, 8, 12, 16)])
def test_resblock_plain_matches_pallas(activation, res_scale, shape):
    """B14's plain version against the Pallas kernel in interpret mode (even
    heights: the kernel's 2-row halo; h1 zero outside the image)."""
    x, w1, b1, w2, b2 = _resblock_case(sum(shape), *shape)
    want = jax_fused_resblock(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2),
                              res_scale=res_scale, activation=activation, interpret=True)
    got = resblock_plain(torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(b1), torch.from_numpy(w2),
                         torch.from_numpy(b2), res_scale=res_scale, activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_resblock_odd_height_matches_jax_decline_and_counts_nothing_on_the_cpu():
    """At an odd height the JAX wrapper declines to two convs; the port's
    one function takes every height. The CPU wrapper counts no launch."""
    x, w1, b1, w2, b2 = _resblock_case(3, 1, 13, 10, 8)
    want = jax_fused_resblock(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2),
                              res_scale=0.1, activation="lrelu0.2", interpret=True)
    engagement.reset()
    got = fused_resblock(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2)), res_scale=0.1, activation="lrelu0.2")
    assert engagement.counters() == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_spectrum_channel_order_is_re_then_im():
    """The bridge maps ``fu.conv_layer`` by name only, so the (re | im)
    stacking is the one thing it cannot check: with the halves swapped, the
    model must no longer match the JAX package."""
    from studiosr_tpu_torch.models import swinfir

    jax_model, model = _pair(scale=2, **SMALL)
    x = _input((1, 12, 16, 3), seed=9)
    want = np.asarray(jax_model(jnp.asarray(x)))
    np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), want, atol=ATOL, rtol=RTOL)
    original = swinfir.spectrum_channels

    def swapped(t):
        re, im = original(t).chunk(2, dim=-1)
        return torch.cat([im, re], dim=-1)

    swinfir.spectrum_channels = swapped
    try:
        got = model(torch.from_numpy(x)).numpy()
    finally:
        swinfir.spectrum_channels = original
    assert np.abs(got - want).max() > 100 * ATOL


def test_from_pretrained_raises_and_recipe_trains_in_f32():
    with pytest.raises(NotImplementedError, match="no published pretrained"):
        SwinFIR.from_pretrained()
    model = SwinFIR.build(scale=2, **SMALL, device="cpu")
    assert model.get_training_config() == JaxSwinFIR.build(scale=2, **SMALL).get_training_config()
    assert model.get_training_config()["bfloat16"] is False
    assert "bfloat16" not in model.__class__.__mro__[1].build(scale=2, **SMALL, device="cpu").get_training_config()


@pytest.mark.skipif(not os.path.exists(os.path.join(SWINFIR_CKPT, "best.model.ckpt")), reason="fixture missing")
def test_trained_fixture_served_by_both_packages():
    """The committed trained SwinFIR x4 checkpoint through ``load_model``
    (no JAX) serves img0_lrx4.png like the JAX package, plain and fused."""
    from studiosr_tpu.utils.helpers import imread
    from studiosr_tpu.utils.metrics import compute_psnr
    from studiosr_tpu.zoo.registry import load_model as jax_load_model
    from studiosr_tpu_torch import load_model

    jax_model = jax_load_model(SWINFIR_CKPT, "swinfir", tag="best")
    model = load_model(SWINFIR_CKPT, "swinfir", device="cpu")
    assert isinstance(model, SwinFIR)
    lr = imread(os.path.join(FIXTURES, "img0_lrx4.png"))
    hr = imread(os.path.join(FIXTURES, "img0_hr.png"))
    want = jax_model.inference(lr)
    for fused in (False, True):
        got = model.enable_fused(fused).inference(lr)
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
        assert abs(compute_psnr(got, hr) - compute_psnr(want, hr)) < 0.01


def _bf16_pair(**kw):
    """As _pair, with every parameter rounded to bf16 on both sides."""
    jax_model = JaxSwinFIR.build(**kw)
    jax_model.variables = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16).astype(a.dtype), jax_model.variables)
    model = SwinFIR.build(**kw, device="cpu")
    load_jax_params(model.module, jax_model.variables["params"])
    return jax_model, model


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prepare_serving_packs_the_sfb_convs_for_bf16_only(dtype):
    """bf16 serving holds each SFB's two spatial-branch convs packed for
    B14 (and B1's weights in its blob); so does f32, in the 3xTF32 kernels'
    layouts (C 32 > 16)."""
    from studiosr_tpu_torch.ops.cuda.conv3x3 import unpack_conv3x3_f32_weights, unpack_conv3x3_weights
    from studiosr_tpu_torch.serving import prepare_serving

    _, model = _bf16_pair(scale=4, **SMALL)
    prep = prepare_serving(model.module, model.config, dtype)
    c = SMALL["embed_dim"]
    for sfb in (*prep["convs"], prep["after_body"]):
        assert sorted(sfb) == ["b0", "b2", "s0", "s2"]
        if dtype == torch.bfloat16:
            assert sfb["s0"].dim() == 5 and sfb["s2"].dtype == torch.bfloat16
        else:
            assert sfb["s0"].dim() == 5 and sfb["s2"].dtype == torch.float32
    conv = model.module.conv_after_body.S.body._modules["0"]
    got = prep["after_body"]["s0"]
    unpack = unpack_conv3x3_weights if dtype == torch.bfloat16 else unpack_conv3x3_f32_weights
    assert torch.equal(unpack(got, c, c).float(), conv.weight.permute(2, 3, 1, 0))  # bf16-exact weights: hi + lo is w
    assert prep["blocks"][0][0]["wqkv"].dim() == 1


def test_fast_forward_on_bf16_prepared_weights_matches_jax():
    """The served SwinFIR on the weights as bf16 serving lays them out (B1's
    blob, B14's packed convs), through the plain versions in f32, against
    the JAX package's fused forward on the same bf16-rounded weights."""
    from studiosr_tpu_torch.serving import prepare_serving, swinir_fast_forward

    jax_model, model = _bf16_pair(scale=4, **SMALL)
    x = _input((1, 20, 24, 3), seed=9)
    want = np.asarray(jax_model.enable_fused(True)(jnp.asarray(x)))
    prep = prepare_serving(model.module, model.config, torch.bfloat16)
    engagement.reset()
    with torch.inference_mode():
        got = swinir_fast_forward(model.module, torch.from_numpy(x), model.config, prep=prep)
    assert engagement.counters() == {}
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
