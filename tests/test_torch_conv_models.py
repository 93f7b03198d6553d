"""The port's eight conv families (SRCNN, ESPCN, VDSR, SRResNet, EDSR, RCAN,
HAN, IMDN), their blocks, the bicubic resize and the weight bridge's rules
for them, against the JAX package on the CPU, f32.

Weights are seeded numpy values put into the JAX variables tree and loaded
into the port through ``load_jax_params``; inputs come from numpy seeds and
go to both packages. A whole model is held to a relative L2 of 1e-5 (convs
summed in another order), a block to atol 1e-5 / rtol 1e-5, and the trained
fixtures to the uint8 rule of the other checkpoint tests: within 1 LSB on
under 1 % of pixels.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import studiosr_tpu_torch
import studiosr_tpu.models as jax_models
from studiosr_tpu.models import blocks as jax_blocks
from studiosr_tpu.ops.resize import bicubic_resize as jax_bicubic_resize
from studiosr_tpu.utils.helpers import imread
from studiosr_tpu.zoo.registry import load_model as jax_load_model
from studiosr_tpu.zoo.translate import export_state_dict
from studiosr_tpu_torch.models import blocks
from studiosr_tpu_torch.ops.resize import bicubic_resize, bicubic_upsample
from studiosr_tpu_torch.zoo import jax_params_to_state_dict, load_jax_params, load_model
from studiosr_tpu_torch.zoo.registry import get_model_class

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "quality")
REL_L2 = 1e-5

# small widths of each family (the published ones are the builds' defaults)
SMALL = {
    "srcnn": dict(residual=True),
    "espcn": dict(channels=16),
    "vdsr": dict(channels=16, n_layers=3),
    "srresnet": dict(channels=16, num_rcb=2),
    "edsr": dict(n_feats=16, n_resblocks=2, res_scale=0.5),
    "rcan": dict(n_feats=16, n_resblocks=2, n_resgroups=2, reduction=4),
    "han": dict(n_feats=16, n_resblocks=2, n_resgroups=2, reduction=4),
    "imdn": dict(n_feats=16, n_modules=2),
}
JAX_MODULES = {"srcnn": "SRCNNModule", "espcn": "ESPCNModule", "vdsr": "VDSRModule", "srresnet": "SRResNetModule",
               "edsr": "EDSRModule", "rcan": "RCANModule", "han": "HANModule", "imdn": "IMDNModule"}
CASES = [(name, s) for name in SMALL for s in ((2, 4, 8) if name == "srresnet" else (2, 3, 4))] + [("han", 8)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _variables(module, x, seed):
    """A flax module's variables tree (its shapes traced, not initialised),
    every leaf seeded values of a size that keeps the activations O(1):
    kernels normal / sqrt(fan-in), biases 0.1 normal, PReLU slopes in [0.1,
    0.4], LAM / CSAM gammas 0.5 +- 0.1, BatchNorm scales near 1 and running
    variances in [0.5, 2]."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        shape = a.shape
        if name.endswith("['kernel']"):
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith("['alpha']"):
            v = rng.uniform(0.1, 0.4, shape)
        elif name.endswith("['gamma']"):
            v = 0.5 + 0.1 * rng.standard_normal(shape)
        elif name.endswith("['scale']"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith("['var']"):
            v = rng.uniform(0.5, 2.0, shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(v.astype(np.float32))

    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(name, scale, seed=0):
    """A JAX module of the family with seeded variables, its forward, and the
    port's model holding the same weights (and running statistics)."""
    cfg = dict(scale=scale, **SMALL[name])
    module = getattr(getattr(jax_models, name), JAX_MODULES[name])(**cfg)
    variables = _variables(module, np.zeros((1, 8, 8, 3), np.float32), seed)
    model = get_model_class(name).build(**cfg, device="cpu")
    load_jax_params(model.module, variables)
    return variables, lambda x: np.asarray(jax.jit(module.apply)(variables, jnp.asarray(x))), model


@pytest.mark.parametrize("name,scale", CASES)
def test_model_matches_jax(name, scale):
    _, forward, model = _pair(name, scale)
    x = np.random.default_rng(scale).random((2, 10, 12, 3), dtype=np.float32)
    want = forward(x)
    got = model(_t(x)).numpy()
    assert got.shape == want.shape == (2, 10 * scale, 12 * scale, 3)
    assert _rel_l2(got, want) <= REL_L2


@pytest.mark.parametrize("name", ["srresnet", "han"])
def test_export_state_dict_loads_into_the_port(name):
    """The torch-convention state_dict the JAX package exports (OIHW and
    OIDHW kernels, ``weight`` for ``alpha``, running statistics) fills the
    port's module by key name."""
    variables, forward, _ = _pair(name, 4, seed=3)
    model = get_model_class(name).build(scale=4, **SMALL[name], device="cpu")
    load_jax_params(model.module, export_state_dict(variables))
    x = np.random.default_rng(4).random((1, 8, 8, 3), dtype=np.float32)
    assert _rel_l2(model(_t(x)).numpy(), forward(x)) <= REL_L2


def test_rank5_kernel_and_alpha_rules():
    """HAN's CSAM kernel (kD, kH, kW, I, O) -> OIDHW and PReLU's ``alpha`` ->
    ``weight``, as ``studiosr_tpu/zoo/translate.py`` maps them."""
    rng = np.random.default_rng(5)
    k5 = rng.standard_normal((3, 3, 3, 1, 1)).astype(np.float32)
    alpha = rng.standard_normal((1,)).astype(np.float32)
    state = jax_params_to_state_dict({"csa": {"conv": {"kernel": k5}}, "conv1.1": {"alpha": alpha}})
    np.testing.assert_array_equal(state["csa.conv.weight"], k5.transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(state["conv1.1.weight"], alpha)
    want = export_state_dict({"params": {"csa": {"conv": {"kernel": k5}}, "conv1.1": {"alpha": alpha}}})
    assert sorted(want) == sorted(state)
    for k, v in want.items():
        np.testing.assert_array_equal(state[k], v)


# -- the blocks ----------------------------------------------------------------------


def _block_pair(jax_block, torch_block, x, seed):
    variables = _variables(jax_block, x, seed)
    load_jax_params(torch_block, variables)
    return np.asarray(jax_block.apply(variables, jnp.asarray(x))), torch_block(_t(x)).detach().numpy()


def test_resblock_matches_jax():
    x = np.random.default_rng(6).standard_normal((2, 9, 7, 8)).astype(np.float32)
    want, got = _block_pair(jax_blocks.ResBlock(8, 3, 0.3), blocks.ResBlock(8, 3, 0.3), x, 6)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_channel_attention_matches_jax():
    x = np.random.default_rng(7).standard_normal((2, 9, 7, 16)).astype(np.float32)
    want, got = _block_pair(jax_blocks.ChannelAttention(16, 4), blocks.ChannelAttention(16, 4), x, 7)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [1, 8])
def test_prelu_matches_jax(n):
    x = np.random.default_rng(8).standard_normal((2, 5, 4, 8)).astype(np.float32)
    want, got = _block_pair(jax_blocks.PReLU(n), blocks.PReLU(n), x, 8 + n)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("sign,img_range", [(-1, 1.0), (1, 255.0)])
def test_mean_shift_matches_jax(sign, img_range):
    x = np.random.default_rng(9).random((2, 5, 4, 3), dtype=np.float32)
    want = np.asarray(jax_blocks.mean_shift(jnp.asarray(x), img_range, sign=sign))
    np.testing.assert_allclose(blocks.mean_shift(_t(x), img_range, sign=sign).numpy(), want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("out", [(26, 34), (39, 51), (20, 11), (7, 9)])
def test_bicubic_resize_matches_jax(out):
    """Integer ratios (x2, x3) and non-integer ones, up and down."""
    x = np.random.default_rng(10).random((2, 13, 17, 3), dtype=np.float32)
    want = np.asarray(jax_bicubic_resize(jnp.asarray(x), *out))
    np.testing.assert_allclose(bicubic_resize(_t(x), *out).numpy(), want, atol=2e-6, rtol=1e-5)
    if out == (26, 34):
        torch.testing.assert_close(bicubic_upsample(_t(x), 2), bicubic_resize(_t(x), *out))


# -- the registry and the trained fixtures -------------------------------------------


@pytest.mark.parametrize("name", sorted(studiosr_tpu_torch.zoo.registry.MODEL_REGISTRY))
def test_registry_holds_every_model(name):
    cls = get_model_class(name)
    assert cls is getattr(studiosr_tpu_torch, cls.__name__) and cls.__name__.lower() == name


FIXTURE_CKPTS = [("ckpt", "espcn", "_lr"), ("srcnn_ckpt", "srcnn", "_lrx2"), ("vdsr_ckpt", "vdsr", "_lrx2"),
                 ("srresnet_ckpt", "srresnet", "_lrx4"), ("edsr_ckpt", "edsr", "_lrx4"), ("rcan_ckpt", "rcan", "_lrx4"),
                 ("han_ckpt", "han", "_lrx4"), ("han_x8_ckpt", "han", "_lrx8"), ("imdn_ckpt", "imdn", "_lrx4")]


@pytest.mark.parametrize("subdir,name,suffix", FIXTURE_CKPTS)
def test_trained_fixture_serves_like_jax(subdir, name, suffix):
    """The port's ``load_model`` against the JAX package's on the three
    fixture images; SRResNet's running statistics come back as flax stored
    them."""
    ckpt = os.path.join(FIXTURES, subdir)
    jax_model = jax_load_model(ckpt, name, tag="best")
    model = load_model(ckpt, name, device="cpu")
    if name == "srresnet":
        stats = jax_params_to_state_dict(jax_model.variables["batch_stats"])
        assert stats and all(np.abs(v).max() > 0 for v in stats.values())
        for k, v in stats.items():
            np.testing.assert_array_equal(model.module.state_dict()[k].numpy(), v, err_msg=k)
    for i in range(3):
        lr = imread(os.path.join(FIXTURES, f"img{i}{suffix}.png"))
        got, want = model.inference(lr), jax_model.inference(lr)
        assert got.shape == want.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
