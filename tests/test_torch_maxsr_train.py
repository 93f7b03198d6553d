"""MaxSR fused training of the port against the JAX package on the CPU, f32.

The port's ``MaxSRModule`` with ``fused_train`` (the attention pairs through
``attention_map_vjp`` and ``mlp_block_vjp``, whose kernels take their plain
versions on the CPU) against the JAX package's ``MaxSRModule(fused_train=True)``
under ``value_and_grad``, as tests/ops/test_fused_train.py runs it: the loss
(rtol 1e-5), every gradient by name (atol 2e-5, rtol 1e-3) and the BatchNorm
running statistics after the step. Then ``mlp_block_vjp`` against the JAX
package's (its backward a Pallas kernel in interpret mode), the grid
shuffle, B7's packed layout at MaxSR's hidden 512, and the flag's wiring.
Weights and inputs are seeded numpy values handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.models.maxsr import MaxSRModule as JaxMaxSRModule
from studiosr_tpu.models.maxsr import _block_partition, _grid_partition, _shuffle_grid, _unshuffle_grid
from studiosr_tpu.ops.pallas.mlp_vjp import mlp_block_vjp as jax_mlp_block_vjp
from studiosr_tpu_torch import MaxSR, Trainer
from studiosr_tpu_torch.models.maxsr import shuffle_grid, unshuffle_grid
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.mlp_bwd import mma_takes, pack_mlp_bwd_weights
from studiosr_tpu_torch.ops.mlp_vjp import mlp_block_vjp
from studiosr_tpu_torch.zoo import jax_params_to_state_dict, jax_variables_to_state_dict, load_jax_params
from tests.test_torch_conv_models import _variables
from tests.test_torch_mlp_attn_fwd_mma import _expected_b7_pack

torch.set_num_threads(2)

# dim 32 in heads of 16, one trio a stage; a 64 x 64 map, so that the
# adaptive windows are 8 x 8 as at the training crop
CFG = dict(scale=2, dim=32, dim_head=16, depth=(1, 1), window_size=8)
SIZE = 64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _batch(b=2):
    x = np.random.default_rng(0).random((b, SIZE, SIZE, 3), dtype=np.float32)
    gt = np.random.default_rng(1).random((b, 2 * SIZE, 2 * SIZE, 3), dtype=np.float32)
    return x, gt


@pytest.mark.parametrize("wh,ww", [(4, 4), (3, 5), (6, 2)])
def test_shuffle_grid_matches_jax(wh, ww):
    """grid partition == block partition of the shuffled map, as the JAX
    package's ``_shuffle_grid``; the inverse undoes it."""
    x = np.random.default_rng(wh).standard_normal((2, 12, 20, 5)).astype(np.float32)
    np.testing.assert_array_equal(shuffle_grid(_t(x), wh, ww).numpy(),
                                  np.asarray(_shuffle_grid(jnp.asarray(x), wh, ww)))
    np.testing.assert_array_equal(unshuffle_grid(_t(x), wh, ww).numpy(),
                                  np.asarray(_unshuffle_grid(jnp.asarray(x), wh, ww)))
    got = _block_partition(jnp.asarray(shuffle_grid(_t(x), wh, ww).numpy()), wh, ww)[0]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(_grid_partition(jnp.asarray(x), wh, ww)[0]))
    assert torch.equal(unshuffle_grid(shuffle_grid(_t(x), wh, ww), wh, ww), _t(x))


@pytest.mark.parametrize("adaptive", [False, True])
def test_fused_train_matches_jax(adaptive):
    """Loss, every gradient by name and the updated running statistics of
    one training forward of the fused-train MaxSR (static: the table bias;
    adaptive: the zero bias and the re-based residual; block and grid pairs
    both) against ``MaxSRModule(fused_train=True)``."""
    jax_module = JaxMaxSRModule(**CFG, adaptive=adaptive, dropout=0.0, fused_train=True)
    x, gt = _batch()
    variables = _variables(jax_module, x[:1], seed=11 + adaptive)

    def loss(params):
        out, updated = jax_module.apply({**variables, "params": params}, jnp.asarray(x), train=True,
                                        mutable=["batch_stats"])
        return jnp.mean(jnp.abs(out - jnp.asarray(gt))), updated

    (want_loss, updated), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    model = MaxSR.build(**CFG, adaptive=adaptive, dropout=0.0, device="cpu")
    load_jax_params(model.module, variables)
    module = model.module.train()
    module.fused_train = True
    engagement.reset()
    got_loss = torch.mean(torch.abs(module(_t(x)) - _t(gt)))
    got_loss.backward()
    assert engagement.counters() == {}  # CPU tensors: the plain versions, no launch
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    want = jax_params_to_state_dict(want_grads)
    grads = {k: p.grad.numpy() for k, p in module.named_parameters()}
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g, want[k], atol=2e-5, rtol=1e-3, err_msg=k)
    stats = jax_variables_to_state_dict({"params": {}, **updated})
    state = module.state_dict()
    assert stats and all(k.endswith(("running_mean", "running_var")) for k in stats)
    for k, v in stats.items():
        np.testing.assert_allclose(state[k].numpy(), v, atol=1e-6, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("size", [36, 49, 100])
def test_adaptive_fused_train_matches_jax_at_other_windows(monkeypatch, size):
    """Adaptive maps of 36, 49 and 100 square have windows of 6, 7 and 10
    (ceil(sqrt(side)), the map zero-padded to the window's square): the loss
    and every gradient of one fused-train forward against the JAX package's
    with its fused forwards forced onto the Pallas kernels in interpret mode
    (B5 with B8 at 6 and 7, B9 at 10), at the tolerances above."""
    from studiosr_tpu.ops import attn_vjp
    from studiosr_tpu.ops.pallas import mlp_vjp

    monkeypatch.setattr(attn_vjp, "FORCE_FUSED", True)
    monkeypatch.setattr(mlp_vjp, "FORCE_FUSED", True)
    jax_module = JaxMaxSRModule(**CFG, adaptive=True, dropout=0.0, fused_train=True)
    rng = np.random.default_rng(size)
    x = rng.random((1, size, size, 3), dtype=np.float32)
    gt = rng.random((1, 2 * size, 2 * size, 3), dtype=np.float32)
    variables = _variables(jax_module, x, seed=size)

    def loss(params):
        out, _ = jax_module.apply({**variables, "params": params}, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
        return jnp.mean(jnp.abs(out - jnp.asarray(gt)))

    jax.clear_caches()  # an unforced trace of the same shapes may be cached
    try:
        want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    finally:
        jax.clear_caches()
    model = MaxSR.build(**CFG, adaptive=True, dropout=0.0, device="cpu")
    load_jax_params(model.module, variables)
    module = model.module.train()
    module.fused_train = True
    got_loss = torch.mean(torch.abs(module(_t(x)) - _t(gt)))
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    want = jax_params_to_state_dict(want_grads)
    grads = {k: p.grad.numpy() for k, p in module.named_parameters()}
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g, want[k], atol=2e-5, rtol=1e-3, err_msg=k)


@pytest.mark.parametrize("adaptive", [False, True])
def test_fused_and_plain_maxsr_agree_with_dropsample(adaptive):
    """The same generator draws the same dropsample scales on both paths, so
    the fused module's loss and gradients equal plain autograd's."""
    model = MaxSR.build(**CFG, adaptive=adaptive, dropout=0.3, device="cpu", seed=4)
    module = model.module.train()
    x, gt = _batch(b=3)
    results = []
    for fused in (False, True):
        module.fused_train = fused
        module.zero_grad()
        out = module(_t(x), generator=torch.Generator().manual_seed(3))
        loss = torch.mean(torch.abs(out - _t(gt)))
        loss.backward()
        results.append((loss.item(), {k: p.grad.clone() for k, p in module.named_parameters()}))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-5)
    for k, g in results[0][1].items():
        np.testing.assert_allclose(results[1][1][k].numpy(), g.numpy(), atol=2e-5, rtol=1e-3, err_msg=k)


def test_nonsquare_adaptive_map_takes_the_plain_path():
    """An adaptive map of 8 x 12 has windows of 3 x 4: the fused flag leaves
    its pairs on the plain path (the same output as without the flag)."""
    model = MaxSR.build(**CFG, adaptive=True, dropout=0.0, device="cpu", seed=5)
    module = model.module.train()
    x = _t(np.random.default_rng(6).random((1, 8, 12, 3), dtype=np.float32))
    want = module(x)
    module.fused_train = True
    got = module(x)
    assert got.shape == (1, 16, 24, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("hidden,rows", [(64, 200), (512, 130)])
def test_mlp_block_vjp_matches_jax(hidden, rows):
    """``mlp_block_vjp`` (no drop-path) against the JAX package's: the
    forward (its reference math on the CPU) and the cotangents, its backward
    the Pallas ``_bwd`` kernel in interpret mode; MaxSR's hidden 512 at C
    128, ragged row counts."""
    c = 128 if hidden == 512 else 32
    rng = np.random.default_rng(hidden)
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    ops = [f(rows, c), 1.0 + f(c, k=0.1), f(c, k=0.1), f(c, hidden, k=c**-0.5), f(hidden, k=0.1),
           f(hidden, c, k=hidden**-0.5), f(c, k=0.1)]
    g = f(rows, c)
    want, vjp = jax.vjp(jax_mlp_block_vjp, *map(jnp.asarray, ops))
    want_grads = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_() for a in ops]
    got = mlp_block_vjp(*leaves)
    got_grads = torch.autograd.grad(got, leaves, _t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    for name, a, e in zip(["dx", "ds", "db", "dw1", "db1", "dw2", "db2"], got_grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=2e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("c", [128, 184])
def test_b7_packed_layout_at_hidden_512(c):
    """B7's packed weights at MaxSR's hidden 512 (six chunks of 96, the last
    32 wide) follow the rule element by element, and the H100 kernel takes
    the geometry."""
    hidden = 512
    w1 = torch.arange(c * hidden, dtype=torch.float64).reshape(c, hidden) + 1
    w2 = -torch.arange(hidden * c, dtype=torch.float64).reshape(hidden, c) - 1
    got = pack_mlp_bwd_weights(w1, w2).numpy()
    want = np.array([0.0 if e is None else float((w1 if e[0] == "w1" else w2)[e[1], e[2]])
                     for e in _expected_b7_pack(c, hidden)])
    np.testing.assert_array_equal(got, want)
    assert mma_takes(c, hidden) and not mma_takes(c, hidden + 16)


def test_fused_train_flag_reaches_every_pair_and_the_trainer(tmp_path):
    """``build(fused_train=True)`` sets every attention pair; the Trainer
    leaves it off on the CPU by default, takes it when asked, and restores
    the module's flag after its check."""
    model = MaxSR.build(**CFG, dropout=0.1, device="cpu", fused_train=True)
    pairs = [m for m in model.module.modules() if hasattr(m, "fused_train") and m is not model.module]
    assert len(pairs) == 4 and all(p.fused_train for p in pairs) and model.module.fused_train
    model.module.fused_train = False
    assert not any(p.fused_train for p in pairs)
    off = Trainer(model, None, batch_size=2, ckpt_path=str(tmp_path / "a"))
    on = Trainer(model, None, batch_size=2, ckpt_path=str(tmp_path / "b"), fused_train=True)
    assert (off.fused_train, on.fused_train) == (False, True)
    assert not model.module.fused_train


@pytest.mark.parametrize("adaptive,size", [(True, 36), (True, 72), (False, 24)])
def test_eval_mode_takes_the_plain_path_on_any_window(monkeypatch, adaptive, size):
    """In eval mode (the Trainer's evaluations) the flag leaves every pair
    plain: square adaptive maps whose windows are 6 or 9 (neither of the
    kernels' 8 and 16) and static ones give the flag-off output bits and
    never reach the fused functions."""
    import studiosr_tpu_torch.models.maxsr as maxsr_module

    model = MaxSR.build(**CFG, adaptive=adaptive, dropout=0.1, device="cpu", seed=7)
    x = _t(np.random.default_rng(size).random((1, size, size, 3), dtype=np.float32))
    want = model.module(x)

    def refuse(*args, **kwargs):
        raise AssertionError("the fused route was taken in eval mode")

    monkeypatch.setattr(maxsr_module, "attention_map_vjp", refuse)
    monkeypatch.setattr(maxsr_module, "mlp_block_vjp", refuse)
    model.module.fused_train = True
    got = model.module(x)
    assert not model.module.training and got.shape == (1, 2 * size, 2 * size, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
