"""Fused SwinIR / SwinFIR serving at windows other than 8 (B5 then B6 for
each Swin block) vs the JAX package's fast forward (interpret mode) on the
CPU, f32; window 8 keeps B1's operands; a window no kernel takes still
serves on the CPU through the plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.models.swinfir import SwinFIR as JaxSwinFIR
from studiosr_tpu.models.swinir import SwinIR as JaxSwinIR
from studiosr_tpu.serving import swinir_fast_forward as jax_swinir_fast_forward
from studiosr_tpu_torch import SwinFIR, SwinIR
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.mlp_block import unpack_mlp_block
from studiosr_tpu_torch.ops.cuda.window_attention import unpack_window_attention
from studiosr_tpu_torch.serving import prepare_serving, swinir_fast_forward
from studiosr_tpu_torch.zoo import load_jax_params

torch.set_num_threads(2)

WINDOWS = (4, 6, 12, 16)
# (label, JAX class, port class, scale, embed_dim)
MODELS = (("swinir x4", JaxSwinIR, SwinIR, 4, 16), ("swinir x2", JaxSwinIR, SwinIR, 2, 16),
          ("swinfir x4", JaxSwinFIR, SwinFIR, 4, 24))
ATOL, RTOL = 5e-5, 1e-4  # tests/test_torch_swinir.py's f32 tolerance
SWINFIR_ATOL = 2e-4  # tests/test_torch_swinfir.py's


def _small(ws: int, embed_dim: int = 16, scale: int = 4) -> dict:
    return dict(scale=scale, embed_dim=embed_dim, depths=[2, 2], num_heads=[2, 2], window_size=ws, mlp_ratio=2.0)


def _pair(jax_cls, cls, bf16: bool = False, **kw):
    """A JAX model and the port's, holding the same weights (rounded to bf16
    on both sides with ``bf16``, so that weights prepared in bf16 hold the
    model exactly)."""
    jax_model = jax_cls.build(**kw)
    if bf16:
        jax_model.variables = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16).astype(a.dtype),
                                                     jax_model.variables)
    model = cls.build(**kw, device="cpu")
    load_jax_params(model.module, jax_model.variables["params"])
    return jax_model, model


def _input(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("ws", WINDOWS)
@pytest.mark.parametrize("label,jax_cls,cls,scale,embed_dim", MODELS, ids=[m[0] for m in MODELS])
def test_fused_serving_matches_jax_at_window(label, jax_cls, cls, scale, embed_dim, ws):
    """The served composition (B5 + B6 for each Swin block, plain versions
    on the CPU) against the JAX package's fused forward, which takes its
    whole-block kernel at ws <= 8 and B5 + B6 above; 12 x 20 pads to the
    window's multiple."""
    jax_model, model = _pair(jax_cls, cls, **_small(ws, embed_dim, scale))
    x = _input((1, 12, 20, 3), seed=ws)
    if cls is SwinFIR:
        want = np.asarray(jax_model.enable_fused(True)(jnp.asarray(x)))
    else:
        want = np.asarray(jax_swinir_fast_forward(jax_model.variables, jnp.asarray(x), jax_model.config,
                                                  interpret=True))
    engagement.reset()
    got = model.enable_fused(True)(torch.from_numpy(x)).numpy()
    assert engagement.counters() == {}  # the CPU takes the plain versions, which count nothing
    assert got.shape == (1, 12 * scale, 20 * scale, 3)
    np.testing.assert_allclose(got, want, atol=SWINFIR_ATOL if cls is SwinFIR else ATOL, rtol=RTOL)


@pytest.mark.parametrize("ws", WINDOWS)
def test_fast_forward_on_bf16_prepared_operands_matches_jax(ws):
    """B5's blob (weights and the bias in fragment order) and B6's, as bf16
    serving lays them out, through the plain versions in f32, against the
    JAX package's fast forward on the same bf16-rounded weights."""
    jax_model, model = _pair(JaxSwinIR, SwinIR, bf16=True, **_small(ws))
    x = _input((1, 12, 20, 3), seed=10 + ws)
    want = jax_swinir_fast_forward(jax_model.variables, jnp.asarray(x), jax_model.config, interpret=True)
    prep = prepare_serving(model.module, model.config, torch.bfloat16)
    assert prep["blocks"][0][0]["attn"]["wproj"] is None and prep["blocks"][0][0]["mlp"]["w2"] is None
    with torch.inference_mode():
        got = swinir_fast_forward(model.module, torch.from_numpy(x), model.config, prep=prep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ws", (4, 8, 12, 16))
def test_prepare_serving_lays_out_b1_at_8_and_b5_b6_elsewhere(ws, dtype):
    """Window 8 keeps B1's operands (its blob in bf16); the other windows
    get B5's (packed with the bias in bf16, dense with the gathered (heads,
    N, N) bias in f32) and B6's (packed in bf16, dense in f32)."""
    _, model = _pair(JaxSwinIR, SwinIR, bf16=True, **_small(ws))
    prep = prepare_serving(model.module, model.config, dtype)
    blk = prep["blocks"][1][1]
    c, hidden, n = 16, 32, ws * ws
    if ws == 8:
        assert set(blk) == {"ln1_w", "ln1_b", "wqkv", "bqkv", "wproj", "bproj", "bias", "ln2_w", "ln2_b", "w1", "b1",
                            "w2", "b2"}
        assert (blk["wqkv"].dim() == 1) == (dtype == torch.bfloat16)
        return
    assert set(blk) == {"attn", "mlp"}
    attn, mlp = blk["attn"], blk["mlp"]
    module_blk = model.module.layers[1].residual_group.blocks[1]
    want_qkv, want_proj = module_blk.attn.qkv.weight.t(), module_blk.attn.proj.weight.t()
    want_w1, want_w2 = module_blk.mlp.fc1.weight.t(), module_blk.mlp.fc2.weight.t()
    if dtype == torch.bfloat16:
        assert attn["wqkv"].dim() == 1 and attn["wproj"] is None and attn["bias"] is None
        wqkv, wproj, bias = unpack_window_attention(attn["wqkv"], c, 2, ws)
        w1, w2 = unpack_mlp_block(mlp["w1"], c, hidden)
        assert mlp["w2"] is None
    else:
        wqkv, wproj, bias, w1, w2 = attn["wqkv"], attn["wproj"], attn["bias"], mlp["w1"], mlp["w2"]
    assert bias.shape == (2, n, n)
    for got, want in ((wqkv, want_qkv), (wproj, want_proj), (w1, want_w1), (w2, want_w2)):
        assert torch.equal(got.float(), want)
    assert torch.equal(attn["ln_w"], module_blk.norm1.weight) and torch.equal(mlp["ln_w"], module_blk.norm2.weight)


def test_window_without_a_kernel_serves_plainly_on_the_cpu():
    """Window 24 (no CUDA kernel takes it; a module on the card raises in
    prepare_serving) serves on the CPU through the plain versions, equal to
    the eager forward."""
    model = SwinIR.build(**_small(24), device="cpu")
    x = torch.from_numpy(_input((1, 20, 28, 3), seed=24))
    want = model(x)
    got = model.enable_fused(True)(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)
