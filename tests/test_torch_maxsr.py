"""Port MaxSR (static and adaptive, eval and training mode, fused with the
plain B15), B15's plain version and the BatchNorm state across the weight
bridge vs the JAX package on the CPU, f32."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.models.maxsr import MaxSR as JaxMaxSR
from studiosr_tpu.ops.pallas.window_attn import window_attention_pallas
from studiosr_tpu_torch import MaxSR, Trainer
from studiosr_tpu_torch.ops.attention import attention_core, get_attention_backend, set_attention_backend
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.window_attn import window_attention
from studiosr_tpu_torch.zoo import jax_variables_to_state_dict, load_jax_params

torch.set_num_threads(2)

SMALL = dict(dim=32, dim_head=8, depth=[1, 1], window_size=8, dropout=0.0)
ATOL, RTOL = 2e-4, 1e-4
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "quality")
MAXSR_CKPT = os.path.join(FIXTURES, "maxsr_ckpt")


def _with_batch_stats(variables, seed=0):
    """``variables`` with non-trivial running statistics (means ~N(0, 0.3),
    variances in [0.5, 2]), so eval mode reads them."""
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 2.0, a.shape).astype(np.float32)), variables["batch_stats"]
    )
    stats = {k: _means(v, rng) for k, v in stats.items()}
    return {**variables, "batch_stats": stats}


def _means(tree, rng):
    if "mean" in tree:
        return {**tree, "mean": jnp.asarray(rng.normal(0, 0.3, tree["mean"].shape).astype(np.float32))}
    return {k: _means(v, rng) for k, v in tree.items()}


def _pair(**kw):
    """A JAX MaxSR with set running statistics and the port's, holding the
    same parameters and statistics."""
    jax_model = JaxMaxSR.build(**kw)
    jax_model.variables = _with_batch_stats(jax_model.variables)
    model = MaxSR.build(**kw, device="cpu")
    load_jax_params(model.module, jax_model.variables)
    return jax_model, model


def _image(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("scale", [2, 3, 4])
@pytest.mark.parametrize("adaptive", [False, True])
def test_eval_matches_jax(adaptive, scale):
    jax_model, model = _pair(scale=scale, adaptive=adaptive, **SMALL)
    for size in (12, 16):
        x = _image((1, size, size, 3), seed=size)
        want = np.asarray(jax_model(jnp.asarray(x)))
        got = model(torch.from_numpy(x)).numpy()
        assert got.shape == (1, size * scale, size * scale, 3)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=f"{size}x{size}")


@pytest.mark.parametrize("adaptive", [False, True])
def test_fused_matches_jax_fused(adaptive):
    """``enable_fused`` (the plain B15 on the CPU) against the JAX package's
    (the Pallas kernel in interpret mode): 2 x 2 attention cores; adaptive
    at 20 x 12, windows of 5 x 4 on the zero-padded 25 x 16 map."""
    jax_model, model = _pair(scale=2, adaptive=adaptive, **SMALL)
    x = _image((1, 20, 12, 3), seed=3)
    want = np.asarray(jax_model.enable_fused(True)(jnp.asarray(x)))
    engagement.reset()
    got = model.enable_fused(True)(torch.from_numpy(x)).numpy()
    assert engagement.counters() == {}
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("adaptive", [False, True])
def test_train_mode_batch_statistics_match_jax(adaptive):
    """Training mode at dropout 0: the forward normalises with the batch
    statistics, and the running statistics after the step equal the JAX
    package's updated ``batch_stats`` (flax's momentum and biased variance)."""
    jax_model, model = _pair(scale=2, adaptive=adaptive, **SMALL)
    x = _image((3, 12, 16, 3), seed=4)
    want, updated = jax_model.module.apply(jax_model.variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                                           rngs={"dropout": jax.random.PRNGKey(0)})
    module = model.module.train()
    got = module(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    expected = jax_variables_to_state_dict({"params": {}, **updated})
    state = module.state_dict()
    assert expected and all(k.endswith(("running_mean", "running_var")) for k in expected)
    for k, v in expected.items():
        np.testing.assert_allclose(state[k].numpy(), v, atol=1e-6, rtol=1e-5, err_msg=k)
        assert int(state[k.rsplit(".", 1)[0] + ".num_batches_tracked"]) == 1


def test_dropsample_keeps_and_scales_each_sample():
    """dropout 0.1: each sample's MBConv branch is kept with probability 0.9
    and scaled by 1 / 0.9, the draws from the generator handed to forward
    (jax.random's bits cannot be matched; their distribution can)."""
    from studiosr_tpu_torch.models.maxsr import MBConv

    block = MBConv(8, dropout=0.1).train()
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.3, generator=torch.Generator().manual_seed(0))
    x = torch.rand(4000, 2, 2, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full = block.eval()(x) - x  # eval: the branch, never dropped, unscaled (running statistics)
        block.train()
        block.fn._modules["8"].eval(), block.fn._modules["1"].eval(), block.fn._modules["4"].eval()
        branch = block(x, generator=torch.Generator().manual_seed(2)) - x
    ratio = (branch.reshape(4000, -1) / full.reshape(4000, -1))
    per_sample = ratio[:, 0]
    assert torch.allclose(ratio, per_sample[:, None].expand_as(ratio), atol=1e-4)  # one draw a sample
    kept = per_sample.abs() > 0.5
    assert abs(float(kept.float().mean()) - 0.9) < 0.015
    torch.testing.assert_close(per_sample[kept], torch.full_like(per_sample[kept], 1 / 0.9), atol=1e-4, rtol=1e-4)
    assert float(per_sample[~kept].abs().max()) < 1e-5
    again = block(x, generator=torch.Generator().manual_seed(2)) - x
    torch.testing.assert_close(again.detach(), branch)


def _qkv(seed, b, h, n, m, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, n, d), dtype=np.float32) * 0.3,
            rng.standard_normal((b, h, m, d), dtype=np.float32),
            rng.standard_normal((b, h, m, d), dtype=np.float32))


@pytest.mark.parametrize("case", ["bias", "none", "mask"])
def test_attention_core_matches_pallas(case):
    """B15's plain version (``attention_core``) against the Pallas kernel in
    interpret mode: a bias, no bias (MaxSR adaptive), a batch-1 mask."""
    b, h, n, d = 8, 2, 36, 8
    q, k, v = _qkv(1, b, h, n, n, d)
    rng = np.random.default_rng(2)
    bias = rng.standard_normal((h, n, n), dtype=np.float32) if case != "none" else None
    mask = np.where(rng.random((b, n, n)) > 0.5, -100.0, 0.0).astype(np.float32) if case == "mask" else None
    want = window_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   bias=None if bias is None else jnp.asarray(bias),
                                   mask=None if mask is None else jnp.asarray(mask), interpret=True)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = attention_core(t(q), t(k), t(v), bias=t(bias), mask=t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    engagement.reset()
    np.testing.assert_array_equal(window_attention(t(q), t(k), t(v), bias=t(bias), mask=t(mask)).numpy(), got.numpy())
    assert engagement.counters() == {}


def test_attention_backend_switch():
    """The JAX package's opt-in name routes ``attention_core`` through B15's
    wrapper (the plain version on the CPU); the default stays plain."""
    assert get_attention_backend() == "xla"
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 4, 2, 16, 16, 8))
    mask = torch.where(torch.rand(2, 16, 16, generator=torch.Generator().manual_seed(0)) > 0.5, -100.0, 0.0)
    want = attention_core(q, k, v, mask=mask)
    set_attention_backend("pallas")
    try:
        got = attention_core(q, k, v, mask=mask)
    finally:
        set_attention_backend("xla")
    torch.testing.assert_close(got, want)
    with pytest.raises(ValueError):
        set_attention_backend("triton")


def test_fused_train_raises_naming_a15b(tmp_path):
    """Fused training raised naming ROADMAP A15b until it was ported: the
    module's flag, ``build(fused_train=True)`` and a Trainer asked for it
    now take it, and nothing raises naming A15b."""
    model = MaxSR.build(scale=2, **SMALL, device="cpu")
    model.module.fused_train = True
    assert model.module.fused_train
    model.module.fused_train = False
    assert MaxSR.build(scale=2, **SMALL, device="cpu", fused_train=True).module.fused_train
    trainer = Trainer(model, None, ckpt_path=str(tmp_path), fused_train=True, bfloat16=False)
    assert trainer.fused_train and not model.module.fused_train


def test_from_pretrained_reads_a_local_torch_state_dict(tmp_path):
    jax_model = JaxMaxSR.build(scale=2, adaptive=False, dim=48, dim_head=12, depth=[2, 2, 2, 2], window_size=8)
    jax_model.variables = _with_batch_stats(jax_model.variables, seed=5)
    from studiosr_tpu.zoo.translate import export_state_dict

    state = {k: torch.from_numpy(np.array(v)) for k, v in export_state_dict(jax_model.variables).items()}
    state = {f"module.{k}": v for k, v in state.items()}
    path = tmp_path / "maxsr_light.pth"
    torch.save({"params": state}, path)
    model = MaxSR.from_pretrained(scale=2, light=True, adaptive=False, ckpt_path=str(path), device="cpu")
    x = _image((1, 16, 16, 3), seed=6)
    np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), np.asarray(jax_model(jnp.asarray(x))),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.skipif(not os.path.exists(os.path.join(MAXSR_CKPT, "best.model.ckpt")), reason="fixture missing")
def test_trained_fixture_restores_batch_stats_and_serves_like_jax():
    """``read_checkpoint(maxsr_ckpt)`` brings the running statistics back
    bitwise; the port (f32, CPU, plain and fused) serves img0_lrx4.png as
    the JAX package does."""
    from studiosr_tpu.utils.helpers import imread
    from studiosr_tpu.utils.metrics import compute_psnr
    from studiosr_tpu.zoo.registry import load_model as jax_load_model
    from studiosr_tpu_torch import load_model
    from studiosr_tpu_torch.zoo.registry import read_checkpoint

    jax_model = jax_load_model(MAXSR_CKPT, "maxsr", tag="best")
    state = read_checkpoint(os.path.join(MAXSR_CKPT, "best.model.ckpt"))
    stats = jax_variables_to_state_dict({"params": {}, "batch_stats": jax_model.variables["batch_stats"]})
    assert stats and all(k.endswith(("running_mean", "running_var")) for k in stats)
    for k, v in stats.items():
        np.testing.assert_array_equal(np.asarray(state[k]), v, err_msg=k)
    model = load_model(MAXSR_CKPT, "maxsr", device="cpu")
    for k, v in stats.items():
        np.testing.assert_array_equal(model.module.state_dict()[k].numpy(), v, err_msg=k)
    lr = imread(os.path.join(FIXTURES, "img0_lrx4.png"))
    hr = imread(os.path.join(FIXTURES, "img0_hr.png"))
    x = lr.astype(np.float32)[None] / 255.0
    want = np.asarray(jax_model(jnp.asarray(x)))
    for fused in (False, True):
        got = model.enable_fused(fused)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        out = model.inference(lr)
        diff = np.abs(out.astype(int) - jax_model.inference(lr).astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
        assert compute_psnr(out, hr) > 20.0
