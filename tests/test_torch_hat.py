"""Port HAT (eager model, fused serving, uint8 contract, the kernels' plain
versions) vs the JAX package on the CPU, f32.

The model tests use HAT's published window (16, overlap 0.5: 24 x 24 key
windows) at a small width; the JAX kernels run in interpret mode. Inputs and
weights come from one numpy generator (or the JAX model's weights, bridged
by name). Tolerances are the JAX package's own (tests/ops/test_fused_swin.py:
atol 5e-5, rtol 1e-4) unless a test says otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.models.hat import HAT as JaxHAT
from studiosr_tpu.ops.pallas.conv3x3 import fused_cab_body as jax_fused_cab_body
from studiosr_tpu.ops.pallas.ocab import fused_ocab_block as jax_fused_ocab_block
from studiosr_tpu.ops.pallas.swin_block import fused_mlp_block as jax_fused_mlp_block
from studiosr_tpu.ops.pallas.swin_block import fused_window_attention_block as jax_fused_window_attention_block
from studiosr_tpu.ops.windows import calculate_mask
from studiosr_tpu.ops.windows import relative_position_index_oca as jax_relative_position_index_oca
from studiosr_tpu.serving.hat_fast import _ocab as jax_ocab
from studiosr_tpu.zoo.translate import export_state_dict
from studiosr_tpu_torch import HAT
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.conv3x3 import fused_cab_body
from studiosr_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
from studiosr_tpu_torch.ops.cuda.ocab import fused_ocab_block
from studiosr_tpu_torch.ops.cuda.window_attention import fused_window_attention_block
from studiosr_tpu_torch.ops.windows import gather_rel_bias, relative_position_index_oca
from studiosr_tpu_torch.serving import hat_fast_forward, prepare_hat_serving
from studiosr_tpu_torch.zoo import load_jax_params

torch.set_num_threads(2)

SMALL = dict(scale=4, embed_dim=30, depths=[2], num_heads=[2], window_size=16)
ATOL, RTOL = 5e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _input(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.fixture(scope="module")
def pair():
    """A JAX HAT and the port's, holding the same weights."""
    jax_model = JaxHAT.build(**SMALL, fast_init=True)
    model = HAT.build(**SMALL, device="cpu")
    load_jax_params(model.module, jax_model.variables["params"])
    return jax_model, model


@pytest.mark.parametrize("ws,overlap", [(16, 0.5), (8, 1.0), (8, 0.5)])
def test_relative_position_index_oca(ws, overlap):
    want = jax_relative_position_index_oca(ws, overlap)
    np.testing.assert_array_equal(relative_position_index_oca(ws, overlap), want)


@pytest.mark.parametrize("shape", [(1, 32, 32, 3), (1, 33, 47, 3)])
def test_eager_hat_matches_linen(pair, shape):
    jax_model, model = pair
    x = _input(shape)
    want = np.asarray(jax_model(jnp.asarray(x)))
    got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 4 * shape[1], 4 * shape[2], 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape,prepped", [((1, 33, 47, 3), False), ((1, 32, 32, 3), True), ((2, 20, 28, 3), True)])
def test_fast_forward_matches_linen(pair, shape, prepped):
    """Batch 1 folds the CAB join into B6 (extra / extra_scale); batch 2
    joins in plain ops first."""
    jax_model, model = pair
    x = _input(shape, seed=1)
    want = np.asarray(jax_model(jnp.asarray(x)))
    prep = prepare_hat_serving(model.module, model.config, torch.float32) if prepped else None
    with torch.inference_mode():
        got = hat_fast_forward(model.module, torch.from_numpy(x), model.config, prep=prep)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fused", [False, True])
def test_inference_uint8_matches_jax(pair, fused):
    jax_model, model = pair
    model.enable_fused(fused)
    image = np.random.default_rng(6).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    want = jax_model.inference(image)
    got = model.inference(image)
    model.enable_fused(False)
    assert got.shape == want.shape == (80, 112, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_bridge_keys_match_the_export_form(pair):
    jax_model, model = pair
    exported = export_state_dict(jax_model.variables)
    state = {k: v.numpy() for k, v in model.module.state_dict().items()}
    assert sorted(state) == sorted(exported)
    for key, value in exported.items():
        np.testing.assert_array_equal(state[key], value, err_msg=key)
    assert "layers.0.residual_group.blocks.1.conv_block.cab.3.attention.1.weight" in state
    assert "layers.0.residual_group.overlap_attn.relative_position_bias_table" in state


def test_fused_train_builds_and_x2_x3_serve():
    """fused_train, which raised until B9, B12 and B13 were ported, now
    builds (its gradients are held in tests/test_torch_hat_train.py); x2 /
    x3, which raised until their tail kernel B4 was ported, serve fused and
    agree with the plain forward."""
    model = HAT.build(**SMALL, device="cpu", fused_train=True)
    assert model.module.fused_train
    x = torch.from_numpy(_input((1, 16, 16, 3), seed=4))
    np.testing.assert_allclose(model(x).numpy(), HAT.build(**SMALL, device="cpu")(x).numpy(), atol=ATOL, rtol=RTOL)
    for scale in (2, 3):
        model = HAT.build(**{**SMALL, "scale": scale}, device="cpu")
        want = model(x)
        got = model.enable_fused(True)(x)
        assert got.shape == (1, 16 * scale, 16 * scale, 3)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)


def test_fused_scale8_records_structural_decline():
    model = HAT.build(**{**SMALL, "scale": 8}, device="cpu")
    x = torch.from_numpy(_input((1, 16, 16, 3), seed=3))
    want = model(x)
    engagement.reset()
    with pytest.warns(UserWarning, match="log2-ladder"):
        got = model.enable_fused(True)(x)
    assert engagement.declines()["fused_upsample_tail"]["count"] == 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)


# -- the kernels' plain versions against the Pallas kernels -------------------


def _f(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(np.float32)


def test_cab_body_plain_matches_pallas():
    """B11 at an even height (an odd one takes the JAX wrapper's XLA path)."""
    rng = np.random.default_rng(11)
    c, cm = 32, 10
    x = _f(rng, 2, 16, 24, c)
    ops = [1 + _f(rng, c, scale=0.1), _f(rng, c, scale=0.1), _f(rng, 3, 3, c, cm, scale=(9 * c) ** -0.5),
           _f(rng, cm, scale=0.1), _f(rng, 3, 3, cm, c, scale=(9 * cm) ** -0.5), _f(rng, c, scale=0.1)]
    want_y, want_s = jax_fused_cab_body(jnp.asarray(x), *[jnp.asarray(a) for a in ops], interpret=True)
    got_y, got_s = fused_cab_body(_t(x), *[_t(a) for a in ops])
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=ATOL, rtol=RTOL)
    # sums over 384 pixels of O(1) values: the same rule scaled by the count
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=ATOL * 16 * 24, rtol=RTOL)


def _attn_operands(rng, c, heads, n, nk):
    return [1 + _f(rng, c, scale=0.1), _f(rng, c, scale=0.1), _f(rng, c, 3 * c, scale=c**-0.5),
            _f(rng, 3 * c, scale=0.1), _f(rng, c, c, scale=c**-0.5), _f(rng, c, scale=0.1),
            _f(rng, heads, n, nk, scale=0.5)]


@pytest.mark.parametrize("shift", [0, 8])
def test_window_attention_ws16_plain_matches_pallas(shift):
    """B5 at window 16 on a 1x32x32 map, C 32, 2 heads. The shifted JAX block
    is roll(+s) . fused_window_attention_block(roll(x, -s), mask)."""
    rng = np.random.default_rng(shift + 5)
    c, heads, ws = 32, 2, 16
    x = _f(rng, 1, 32, 32, c)
    ops = _attn_operands(rng, c, heads, ws * ws, ws * ws)
    mask = jnp.asarray(calculate_mask((32, 32), ws, shift)) if shift else None
    jx = jnp.roll(jnp.asarray(x), (-shift, -shift), axis=(1, 2))
    want = jax_fused_window_attention_block(jx, *[jnp.asarray(a) for a in ops], mask, heads=heads, window_size=ws,
                                            interpret=True)
    want = np.asarray(jnp.roll(want, (shift, shift), axis=(1, 2)))
    got = fused_window_attention_block(_t(x), *[_t(a) for a in ops], heads=heads, window_size=ws, shift=shift)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_mlp_block_extra_plain_matches_pallas():
    """B6 with HAT's CAB join: x' = x + extra * extra_scale, then the MLP."""
    rng = np.random.default_rng(6)
    rows, c, hidden = 200, 32, 64
    x, extra = _f(rng, rows, c), _f(rng, rows, c)
    escale = _f(rng, c, scale=0.5)
    ops = [1 + _f(rng, c, scale=0.1), _f(rng, c, scale=0.1), _f(rng, c, hidden, scale=c**-0.5),
           _f(rng, hidden, scale=0.1), _f(rng, hidden, c, scale=hidden**-0.5), _f(rng, c, scale=0.1)]
    want = jax_fused_mlp_block(jnp.asarray(x), *[jnp.asarray(a) for a in ops], block_rows=64,
                               extra=jnp.asarray(extra), extra_scale=jnp.asarray(escale), interpret=True)
    got = fused_mlp_block(_t(x), *[_t(a) for a in ops], extra=_t(extra), extra_scale=_t(escale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def _ocab_params(rng, c, heads, ws, owin):
    return {
        "norm1": {"scale": 1 + _f(rng, c, scale=0.1), "bias": _f(rng, c, scale=0.1)},
        "qkv": {"kernel": _f(rng, c, 3 * c, scale=0.1), "bias": _f(rng, 3 * c, scale=0.1)},
        "proj": {"kernel": _f(rng, c, c, scale=0.1), "bias": _f(rng, c, scale=0.1)},
        "relative_position_bias_table": _f(rng, (ws + owin - 1) ** 2, heads, scale=0.05),
        "norm2": {"scale": 1 + _f(rng, c, scale=0.1), "bias": _f(rng, c, scale=0.1)},
        "mlp": {"fc1": {"kernel": _f(rng, c, 2 * c, scale=0.1), "bias": _f(rng, 2 * c, scale=0.1)},
                "fc2": {"kernel": _f(rng, 2 * c, c, scale=0.1), "bias": _f(rng, c, scale=0.1)}},
    }


def _ocab_port(x, p, heads, ws, overlap):
    bias = gather_rel_bias(_t(p["relative_position_bias_table"]), relative_position_index_oca(ws, overlap), heads)
    return fused_ocab_block(
        _t(x), _t(p["norm1"]["scale"]), _t(p["norm1"]["bias"]), _t(p["qkv"]["kernel"]), _t(p["qkv"]["bias"]),
        _t(p["proj"]["kernel"]), _t(p["proj"]["bias"]), bias, _t(p["norm2"]["scale"]), _t(p["norm2"]["bias"]),
        _t(p["mlp"]["fc1"]["kernel"]), _t(p["mlp"]["fc1"]["bias"]), _t(p["mlp"]["fc2"]["kernel"]),
        _t(p["mlp"]["fc2"]["bias"]), heads=heads, window_size=ws, overlap_ratio=overlap,
    ).numpy()


def test_ocab_plain_matches_xla_at_hat_geometry():
    """B10 at ws 16 / overlap 0.5 (24 x 24 key windows) on a 1x32x48 map:
    every window's key window reaches outside the image."""
    rng = np.random.default_rng(10)
    c, heads, ws, overlap = 24, 2, 16, 0.5
    p = _ocab_params(rng, c, heads, ws, 24)
    x = _f(rng, 1, 32, 48, c)
    want = np.asarray(jax_ocab(jnp.asarray(x), p, heads, ws, overlap))
    np.testing.assert_allclose(_ocab_port(x, p, heads, ws, overlap), want, atol=ATOL, rtol=RTOL)


def test_ocab_plain_matches_pallas():
    """B10 against the Pallas kernel at tests/ops/test_ocab.py's geometry."""
    rng = np.random.default_rng(0)
    c, heads, ws, overlap = 24, 3, 8, 1.0
    p = _ocab_params(rng, c, heads, ws, 16)
    x = _f(rng, 2, 16, 24, c)
    bias = np.asarray(gather_rel_bias(_t(p["relative_position_bias_table"]),
                                      relative_position_index_oca(ws, overlap), heads))
    jp = {k: v for k, v in p.items()}
    want = jax_fused_ocab_block(
        jnp.asarray(x), jp["norm1"]["scale"], jp["norm1"]["bias"], jp["qkv"]["kernel"], jp["qkv"]["bias"],
        jp["proj"]["kernel"], jp["proj"]["bias"], jnp.asarray(bias), jp["norm2"]["scale"], jp["norm2"]["bias"],
        jp["mlp"]["fc1"]["kernel"], jp["mlp"]["fc1"]["bias"], jp["mlp"]["fc2"]["kernel"], jp["mlp"]["fc2"]["bias"],
        heads=heads, ws=ws, overlap_ratio=overlap, interpret=True,
    )
    assert want is not None
    np.testing.assert_allclose(_ocab_port(x, p, heads, ws, overlap), np.asarray(want), atol=ATOL, rtol=RTOL)
