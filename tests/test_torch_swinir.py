"""Port SwinIR (eager model, fused serving, uint8 contract, weight bridge)
vs the JAX package on the CPU, f32."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.models.swinir import SwinIR as JaxSwinIR
from studiosr_tpu.serving import prepare_serving as jax_prepare_serving
from studiosr_tpu.serving import swinir_fast_forward as jax_swinir_fast_forward
from studiosr_tpu.zoo.translate import export_state_dict
from studiosr_tpu_torch import SwinIR
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.serving import prepare_serving, swinir_fast_forward
from studiosr_tpu_torch.zoo import jax_params_to_state_dict, load_jax_params

torch.set_num_threads(2)

SMALL = dict(embed_dim=16, depths=[2, 2], num_heads=[2, 2], window_size=8, mlp_ratio=2.0)
ATOL, RTOL = 5e-5, 1e-4
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "quality")
SWINIR_CKPT = os.path.join(FIXTURES, "swinir_ckpt")


def _pair(**kw):
    """A JAX SwinIR and the port's, holding the same weights."""
    jax_model = JaxSwinIR.build(**kw)
    model = SwinIR.build(**kw, device="cpu")
    load_jax_params(model.module, jax_model.variables["params"])
    return jax_model, model


def _bf16_pair(**kw):
    """As _pair, with every parameter rounded to bf16 on both sides, so that
    weights prepared in bf16 hold the model exactly."""
    jax_model = JaxSwinIR.build(**kw)
    jax_model.variables = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16).astype(a.dtype), jax_model.variables)
    model = SwinIR.build(**kw, device="cpu")
    load_jax_params(model.module, jax_model.variables["params"])
    return jax_model, model


def _input(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize(
    "scale,upsampler", [(4, "pixelshuffle"), (2, "pixelshuffle"), (4, "pixelshuffledirect")]
)
def test_eager_swinir_matches_linen(scale, upsampler):
    jax_model, model = _pair(scale=scale, upsampler=upsampler, **SMALL)
    x = _input((1, 20, 28, 3))  # not a window multiple
    want = np.asarray(jax_model(jnp.asarray(x)))
    got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 20 * scale, 28 * scale, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("prepped", [False, True])
@pytest.mark.parametrize("upsampler", ["pixelshuffle", "pixelshuffledirect"])
def test_fast_forward_matches_jax_fast_forward(prepped, upsampler):
    jax_model, model = _pair(scale=4, upsampler=upsampler, **SMALL)
    x = _input((1, 20, 28, 3), seed=1)
    jax_prep = jax_prepare_serving(jax_model.variables, jax_model.config, jnp.float32) if prepped else None
    want = jax_swinir_fast_forward(jax_model.variables, jnp.asarray(x), jax_model.config, interpret=True, prep=jax_prep)
    prep = prepare_serving(model.module, model.config, torch.float32) if prepped else None
    with torch.inference_mode():
        got = swinir_fast_forward(model.module, torch.from_numpy(x), model.config, prep=prep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fused", [False, True])
def test_inference_uint8_matches_jax(fused):
    jax_model, model = _pair(scale=4, **SMALL)
    jax_model.enable_fused(fused)
    model.enable_fused(fused)
    image = np.random.default_rng(6).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    want = jax_model.inference(image)
    got = model.inference(image)
    assert got.shape == want.shape == (80, 112, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    batch = model.inference_batch([image, image[::-1].copy()])
    np.testing.assert_array_equal(batch[0], got)


def test_bridge_round_trip_through_params_tree_and_export_form():
    jax_model, model = _pair(scale=4, **SMALL)
    exported = export_state_dict(jax_model.variables)
    state = {k: v.numpy() for k, v in model.module.state_dict().items()}
    assert sorted(state) == sorted(exported) == sorted(jax_params_to_state_dict(jax_model.variables["params"]))
    for key, value in exported.items():
        np.testing.assert_array_equal(state[key], value, err_msg=key)

    # The export form loads by key name; recomputed buffers are dropped.
    fresh = SwinIR.build(scale=4, seed=1, **SMALL, device="cpu")
    extra_buffers = {
        "layers.0.residual_group.blocks.0.attn.relative_position_index": np.zeros((64, 64), np.int64),
        "layers.0.residual_group.blocks.1.attn_mask": np.zeros((9, 64, 64), np.float32),
    }
    load_jax_params(fresh.module, {**exported, **extra_buffers})
    for key, value in fresh.module.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), state[key], err_msg=key)


def test_bridge_rejects_unknown_missing_and_misshapen_keys():
    jax_model, model = _pair(scale=4, **SMALL)
    exported = export_state_dict(jax_model.variables)
    with pytest.raises(KeyError):
        load_jax_params(model.module, {**exported, "layers.9.conv.weight": np.zeros(3, np.float32)})
    with pytest.raises(KeyError):
        load_jax_params(model.module, {k: v for k, v in exported.items() if k != "conv_first.bias"})
    bad = dict(exported)
    bad["conv_first.bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError):
        load_jax_params(model.module, bad)


@pytest.mark.skipif(not os.path.exists(os.path.join(SWINIR_CKPT, "best.model.ckpt")), reason="fixture missing")
def test_trained_fixture_served_by_both_packages():
    """The committed trained SwinIR x4 checkpoint, bridged, serves
    img0_lrx4.png like the JAX package: uint8 outputs within 1 LSB and PSNR
    vs img0_hr.png within 0.01 dB, on the plain and the fused paths."""
    import json

    from studiosr_tpu.utils.helpers import imread
    from studiosr_tpu.utils.metrics import compute_psnr
    from studiosr_tpu.zoo.registry import load_model

    jax_model = load_model(SWINIR_CKPT, "swinir", tag="best")
    with open(os.path.join(SWINIR_CKPT, "params.json")) as f:
        config = json.load(f)
    model = SwinIR.build(**config, device="cpu")
    load_jax_params(model.module, jax_model.variables["params"])
    lr = imread(os.path.join(FIXTURES, "img0_lrx4.png"))
    hr = imread(os.path.join(FIXTURES, "img0_hr.png"))

    want = jax_model.inference(lr)
    psnr_jax = compute_psnr(want, hr)
    for fused in (False, True):
        got = model.enable_fused(fused).inference(lr)
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
        assert abs(compute_psnr(got, hr) - psnr_jax) < 0.01


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        SwinIR.build(scale=4, **SMALL)


def test_fused_configuration_without_kernel_raises():
    """The serving mode with no port raises, on any device, instead of
    quietly serving another way: the one-program tile loop. Mesh-sharded
    evaluation and tiling (A17), which raised until they were ported, serve
    the mesh-less results; fused x3, which raised until its tail kernel B4
    was ported, now serves."""
    from studiosr_tpu_torch.parallel import get_mesh

    model = SwinIR.build(scale=3, **SMALL, device="cpu").enable_fused(True)
    assert model(torch.zeros(1, 16, 16, 3)).shape == (1, 48, 48, 3)
    image = np.zeros((16, 16, 3), np.uint8)
    mesh = get_mesh(["cpu"])
    hr = np.zeros((1, 48, 48, 3), np.uint8)
    assert all(np.array_equal(a, b) for a, b in zip(model.evaluate_uint8_batch(image[None], hr, mesh=mesh),
                                                     model.evaluate_uint8_batch(image[None], hr)))
    np.testing.assert_array_equal(model.inference_tiled(image, tile=8, mesh=mesh), model.inference_tiled(image, tile=8))
    with pytest.raises(NotImplementedError, match="device_loop"):
        model.inference_tiled(image, tile=8, device_loop=True)


def test_fused_scale8_records_structural_decline():
    _, model = _pair(scale=8, **SMALL)
    x = torch.from_numpy(_input((1, 16, 16, 3), seed=3))
    want = model(x)
    engagement.reset()
    with pytest.warns(UserWarning, match="log2-ladder"):
        got = model.enable_fused(True)(x)
    assert engagement.declines()["fused_upsample_tail"]["count"] == 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prepare_serving_packs_b1_and_b2_for_bf16_only(dtype):
    """bf16 serving holds B1's weights and rel-pos bias in its kernel's blob
    and B2's conv weights packed; f32 keeps dense (in, out) weights, the
    gathered bias and HWIO convs. B3's tail is packed in bf16 (the two
    pixel-shuffle convs in the wgmma ring's layout, conv_last in mma
    fragment order) and HWIO in f32."""
    from studiosr_tpu_torch.ops.cuda.swin_block import unpack_swin_weights

    _, model = _bf16_pair(scale=4, **SMALL)
    prep = prepare_serving(model.module, model.config, dtype)
    c, hidden = SMALL["embed_dim"], int(SMALL["embed_dim"] * SMALL["mlp_ratio"])
    blk = prep["blocks"][0][1]
    w, _ = prep["convs"][0]
    if dtype == torch.bfloat16:
        assert blk["wqkv"].dim() == 1 and blk["wqkv"].dtype == torch.bfloat16
        assert all(blk[k] is None for k in ("wproj", "bias", "w1", "w2"))
        wqkv, wproj, bias, w1, w2 = unpack_swin_weights(blk["wqkv"], c, 2, hidden)
        attn = model.module.layers[0].residual_group.blocks[1].attn
        assert torch.equal(wqkv.float(), attn.qkv.weight.t()) and torch.equal(wproj.float(), attn.proj.weight.t())
        assert bias.shape == (2, 64, 64) and w1.shape == (c, hidden) and w2.shape == (hidden, c)
        assert w.dim() == 5 and w.dtype == torch.bfloat16
    else:
        assert blk["wqkv"].shape == (c, 3 * c) and blk["bias"].shape == (2, 64, 64) and blk["w1"].shape == (c, hidden)
        assert w.shape == (3, 3, c, c) and w.dtype == torch.float32
    dims = (6, 6, 5) if dtype == torch.bfloat16 else (4, 4, 4)
    assert tuple(t.dim() for t in prep["tail"][::2]) == dims
    assert all(t.dtype == torch.float32 for t in prep["tail"][1::2])


@pytest.mark.parametrize("scale", [2, 4])
def test_fast_forward_on_bf16_prepared_weights_matches_jax(scale):
    """The served composition on the weights as bf16 serving lays them out
    (B1's blob, B2's packed convs), through the plain versions in f32,
    against the JAX package's fast forward on the same bf16-rounded weights
    (interpret mode), at the f32 tolerance."""
    jax_model, model = _bf16_pair(scale=scale, **SMALL)
    x = _input((1, 20, 28, 3), seed=2)
    want = jax_swinir_fast_forward(jax_model.variables, jnp.asarray(x), jax_model.config, interpret=True)
    prep = prepare_serving(model.module, model.config, torch.bfloat16)
    engagement.reset()
    with torch.inference_mode():
        got = swinir_fast_forward(model.module, torch.from_numpy(x), model.config, prep=prep)
    assert engagement.counters() == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
