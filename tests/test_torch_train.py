"""Fused training of the port vs the JAX package on the CPU, f32.

B5 (window attention half) and B6 (MLP half) plain versions against the
Pallas kernels in interpret mode, B8 and B7 (their backwards) against
``pairs_attention_bwd`` and ``mlp_vjp._bwd`` in interpret mode, the
autograd Functions against autograd of the plain forwards, the fused-train
SwinIR against ``SwinIRModule(fused_train=True)``, and ``make_train_step``
against the JAX train step. Inputs come from numpy seeds and go to both
packages. Tolerances are those of the JAX package's own tests named at
each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.ops.pallas.attn_bwd import pairs_attention_bwd
from studiosr_tpu.ops.pallas.mlp_vjp import _bwd as jax_mlp_bwd
from studiosr_tpu.ops.pallas.mlp_vjp import _dp_bwd as jax_mlp_dp_bwd
from studiosr_tpu.ops.pallas.swin_block import fused_mlp_block as jax_fused_mlp_block
from studiosr_tpu.ops.pallas.swin_block import fused_window_attention_block as jax_fused_window_attention_block
from studiosr_tpu.ops.windows import calculate_mask
from studiosr_tpu_torch.ops.attn_vjp import attention_map_vjp
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.attn_bwd import attention_bwd
from studiosr_tpu_torch.ops.cuda.mlp_block import fused_mlp_block, mlp_block_plain
from studiosr_tpu_torch.ops.cuda.mlp_bwd import mlp_bwd
from studiosr_tpu_torch.ops.cuda.window_attention import fused_window_attention_block, window_attention_plain
from studiosr_tpu_torch.ops.mlp_vjp import mlp_block_dp_vjp

torch.set_num_threads(2)

ATOL, RTOL = 5e-5, 1e-4  # forwards, as tests/ops/test_fused_swin.py
GRAD_NAMES_ATTN = ["dx", "ds", "db", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias"]
GRAD_NAMES_MLP = ["dx", "ds", "db", "dw1", "db1", "dw2", "db2"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _attn_operands(rng, c, heads, ws=8, scale=0.1):
    n = ws * ws
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    return dict(
        ln_w=1.0 + f(c, k=0.1), ln_b=f(c, k=0.1), wqkv=f(c, 3 * c, k=scale * 3), bqkv=f(3 * c, k=scale),
        wproj=f(c, c, k=scale * 3), bproj=f(c, k=scale), bias=f(heads, n, n, k=0.5),
    )


def _mlp_operands(rng, c, hidden):
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    return dict(ln_w=f(c), ln_b=f(c), w1=f(c, hidden, k=0.2), b1=f(hidden, k=0.1), w2=f(hidden, c, k=0.2),
                b2=f(c, k=0.1))


@pytest.mark.parametrize("shift,dp", [(0, None), (4, (0.0, 1.25))])
def test_window_attention_plain_matches_pallas(shift, dp):
    """B5 at C 32, 2 heads on a 16x24 map, batch 2, with mask and dp scales
    (one of them 0: that sample's output is exactly x)."""
    rng = np.random.default_rng(10 + shift)
    b, h, w, c, heads, ws = 2, 16, 24, 32, 2, 8
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    ops = _attn_operands(rng, c, heads)
    dps = None if dp is None else np.asarray(dp, np.float32)
    mask = jnp.asarray(calculate_mask((h, w), ws, shift)) if shift else None
    jx = jnp.roll(jnp.asarray(x), (-shift, -shift), axis=(1, 2))
    want = jax_fused_window_attention_block(
        jx, *[jnp.asarray(v) for v in ops.values()], mask, heads=heads, window_size=ws,
        drop_path=None if dps is None else jnp.asarray(dps), interpret=True,
    )
    want = np.asarray(jnp.roll(want, (shift, shift), axis=(1, 2)))
    got = fused_window_attention_block(
        _t(x), **{k: _t(v) for k, v in ops.items()}, heads=heads, window_size=ws, shift=shift,
        drop_path=None if dps is None else _t(dps),
    ).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    if dps is not None:
        np.testing.assert_array_equal(got[0], x[0])


@pytest.mark.parametrize("dp", [None, (1.25, 0.0)])
def test_mlp_block_plain_matches_pallas(dp):
    """B6 on 2 x 384 rows, C 24, hidden 48, per-sample dp scales."""
    rng = np.random.default_rng(20)
    rows_per_sample, c, hidden = 384, 24, 48
    x = rng.standard_normal((2 * rows_per_sample, c)).astype(np.float32)
    ops = _mlp_operands(rng, c, hidden)
    dps = None if dp is None else np.asarray(dp, np.float32)
    kw = {} if dps is None else dict(drop_path=jnp.asarray(dps), rows_per_sample=rows_per_sample)
    want = np.asarray(jax_fused_mlp_block(jnp.asarray(x), *[jnp.asarray(v) for v in ops.values()], interpret=True,
                                          **kw))
    got = fused_mlp_block(_t(x), **{k: _t(v) for k, v in ops.items()}, drop_path=None if dps is None else _t(dps),
                          rows_per_sample=rows_per_sample).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    if dps is not None:
        np.testing.assert_array_equal(got[rows_per_sample:], x[rows_per_sample:])


def test_mlp_block_extra_operands_wait_for_hat():
    """HAT's CAB join (``extra`` with ``extra_scale``) serves, but not with
    drop-path, which waits for HAT training; the two operands come
    together. The join itself is held against the Pallas kernel in
    tests/test_torch_hat.py."""
    rng = np.random.default_rng(21)
    x = _t(rng.standard_normal((64, 8)).astype(np.float32))
    extra = _t(rng.standard_normal((64, 8)).astype(np.float32))
    escale = _t(rng.standard_normal(8).astype(np.float32))
    ops = [_t(v) for v in _mlp_operands(rng, 8, 16).values()]
    with pytest.raises(NotImplementedError, match="extra"):
        fused_mlp_block(x, *ops, extra=extra, extra_scale=escale, drop_path=torch.ones(1), rows_per_sample=64)
    with pytest.raises(ValueError, match="extra"):
        fused_mlp_block(x, *ops, extra=extra)
    got = fused_mlp_block(x, *ops, extra=extra, extra_scale=escale)
    torch.testing.assert_close(got, mlp_block_plain(x + extra * escale, *ops), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shift,dp", [(0, None), (4, (0.0, 1.25))])
def test_attention_bwd_plain_matches_pallas(shift, dp):
    """B8 vs ``pairs_attention_bwd(..., interpret=True)`` as
    tests/ops/test_attn_bwd.py (b 2, 16x16, C 12, 2 heads, atol 3e-4, rtol
    2e-3). The shifted case rolls the JAX operands and its dx; a 0 scale
    leaves that sample's dx equal to g."""
    rng = np.random.default_rng(30 + shift)
    b, h, w, c, heads, ws = 2, 16, 16, 12, 2, 8
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    ops = _attn_operands(rng, c, heads)
    ops["bias"] = ops["bias"] * 0.1
    dps = None if dp is None else np.asarray(dp, np.float32)
    mask = jnp.asarray(calculate_mask((h, w), ws, shift)) if shift else None
    roll = lambda a: jnp.roll(jnp.asarray(a), (-shift, -shift), axis=(1, 2))  # noqa: E731
    want = pairs_attention_bwd(
        roll(x), roll(g), *[jnp.asarray(v) for v in ops.values()], mask, None if dps is None else jnp.asarray(dps),
        heads=heads, window_size=ws, interpret=True,
    )
    want = [np.asarray(jnp.roll(want[0], (shift, shift), axis=(1, 2)))] + [np.asarray(a) for a in want[1:]]
    got = attention_bwd(
        _t(x), _t(g), **{k: _t(v) for k, v in ops.items()}, heads=heads, window_size=ws, shift=shift,
        drop_path=None if dps is None else _t(dps),
    )
    for name, a, e in zip(GRAD_NAMES_ATTN, got, want):
        np.testing.assert_allclose(a.numpy(), e, atol=3e-4, rtol=2e-3, err_msg=name)
    # the q columns alone: the port's wqkv is unscaled, so dq carries 1/sqrt(d)
    np.testing.assert_allclose(got[3][:, :c].numpy(), want[3][:, :c], atol=3e-4, rtol=2e-3, err_msg="dwq")
    np.testing.assert_allclose(got[4][:c].numpy(), want[4][:c], atol=3e-4, rtol=2e-3, err_msg="dbq")
    if dps is not None:
        np.testing.assert_array_equal(got[0][0].numpy(), g[0])


@pytest.mark.parametrize(
    "rows,rows_per_sample,dp",
    [(300, 0, None), (512 * 9 + 37, 0, None), (2 * 320, 320, (0.0, 1.25))],
    ids=["plain", "accumulated-partials", "dp"],
)
def test_mlp_bwd_plain_matches_pallas(rows, rows_per_sample, dp):
    """B7 vs ``mlp_vjp._bwd`` / ``_dp_bwd`` (interpret mode on the CPU), as
    tests/ops/test_mlp_vjp.py (atol 5e-4, rtol 1e-3; its accumulated-partials
    case, more than 8 row blocks, at its 2e-3)."""
    rng = np.random.default_rng(rows)
    c, hidden = 16, 32
    x = (rng.standard_normal((rows, c)) * 0.5).astype(np.float32)
    g = rng.standard_normal((rows, c)).astype(np.float32)
    ops = _mlp_operands(rng, c, hidden)
    res = tuple(jnp.asarray(v) for v in (x, *ops.values()))
    if dp is None:
        want = jax_mlp_bwd(res, jnp.asarray(g))
    else:
        want = jax_mlp_dp_bwd(rows_per_sample, res + (jnp.asarray(dp, jnp.float32),), jnp.asarray(g))[:7]
    tol = 2e-3 if rows > 512 * 8 else None
    got = mlp_bwd(
        _t(x), _t(g), *[_t(ops[k]) for k in ("ln_w", "ln_b", "w1", "b1", "w2")],
        drop_path=None if dp is None else torch.tensor(dp), rows_per_sample=rows_per_sample,
    )
    for name, a, e in zip(GRAD_NAMES_MLP, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=tol or 5e-4, rtol=tol or 1e-3, err_msg=name)


def test_attention_map_vjp_grads_match_autograd_of_plain():
    """The autograd Function (B5 forward, B8 backward) against autograd of
    the plain forward, with shift, mask and a 0 scale."""
    rng = np.random.default_rng(40)
    b, h, w, c, heads = 2, 16, 24, 16, 2
    x = _t(rng.standard_normal((b, h, w, c)).astype(np.float32)).requires_grad_()
    g = _t(rng.standard_normal((b, h, w, c)).astype(np.float32))
    ops = {k: _t(v).requires_grad_() for k, v in _attn_operands(rng, c, heads).items()}
    dp = torch.tensor([0.0, 1.25])
    args = (x, *ops.values())
    got = torch.autograd.grad((attention_map_vjp(*args, dp, 4, heads, 8) * g).sum(), args)
    want = torch.autograd.grad(
        (window_attention_plain(*args, heads=heads, window_size=8, shift=4, drop_path=dp) * g).sum(), args
    )
    # the weight gradients reach 40 here; f32 sums taken in another order
    for name, a, e in zip(["dx"] + list(ops), got, want):
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=1e-4, rtol=1e-4, err_msg=name)


def test_mlp_block_dp_vjp_grads_match_autograd_of_plain():
    rng = np.random.default_rng(41)
    rows_per_sample, c, hidden = 64, 16, 32
    x = _t(rng.standard_normal((3 * rows_per_sample, c)).astype(np.float32)).requires_grad_()
    g = _t(rng.standard_normal((3 * rows_per_sample, c)).astype(np.float32))
    ops = {k: _t(v).requires_grad_() for k, v in _mlp_operands(rng, c, hidden).items()}
    dp = torch.tensor([1.25, 0.0, 1.25])
    args = (x, *ops.values())
    got = torch.autograd.grad((mlp_block_dp_vjp(*args, dp, rows_per_sample) * g).sum(), args)
    want = torch.autograd.grad(
        (mlp_block_plain(*args, drop_path=dp, rows_per_sample=rows_per_sample) * g).sum(), args
    )
    for name, a, e in zip(["dx"] + list(ops), got, want):
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


def test_cpu_training_kernels_count_no_launch():
    engagement.reset()
    test_mlp_block_dp_vjp_grads_match_autograd_of_plain()
    assert engagement.counters() == {}


# -- the model ----------------------------------------------------------------

# one residual group of two blocks (unshifted, shifted): the JAX side runs
# its Pallas MLP backward in interpret mode, and every block adds to its compile
CFG = dict(scale=2, embed_dim=16, depths=[2], num_heads=[2], window_size=8, mlp_ratio=2.0,
           upsampler="pixelshuffledirect")


def _models(drop_path_rate=0.0):
    from studiosr_tpu.models.swinir import SwinIR as JaxSwinIR
    from studiosr_tpu_torch import SwinIR
    from studiosr_tpu_torch.zoo import load_jax_params

    jax_model = JaxSwinIR.build(**CFG, drop_path_rate=drop_path_rate)
    model = SwinIR.build(**CFG, drop_path_rate=drop_path_rate, device="cpu")
    load_jax_params(model.module, jax_model.variables["params"])
    return jax_model, model


def _batch(b=2, size=16, scale=2):
    x = np.random.default_rng(0).standard_normal((b, size, size, 3)).astype(np.float32)
    gt = np.random.default_rng(1).standard_normal((b, size * scale, size * scale, 3)).astype(np.float32)
    return x, gt


def test_fused_train_swinir_matches_jax():
    """Loss and every gradient by name against ``SwinIRModule(fused_train=True)``,
    as tests/ops/test_fused_train.py (atol 2e-5, rtol 1e-3)."""
    from studiosr_tpu_torch.zoo import jax_params_to_state_dict

    jax_model, model = _models()
    x, gt = _batch()
    fused = jax_model.module.clone(fused_train=True)

    def loss(params):
        out = fused.apply({"params": params}, jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(7)})
        return jnp.mean(jnp.abs(out - jnp.asarray(gt)))

    # jit: a fifth of eager's time
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(jax_model.variables["params"])
    want = jax_params_to_state_dict(want_grads)
    module = model.module.train()
    module.fused_train = True
    got_loss = torch.mean(torch.abs(module(_t(x)) - _t(gt)))
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    grads = {k: p.grad.numpy() for k, p in module.named_parameters()}
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g, want[k], atol=2e-5, rtol=1e-3, err_msg=k)


def test_fused_and_plain_paths_agree_with_drop_path():
    """The same generator draws the same scales on both paths, so the fused
    module's loss and gradients equal plain autograd of the eager one."""
    _, model = _models(drop_path_rate=0.5)
    module = model.module.train()
    x, gt = _batch(b=4)
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


def test_drop_path_draws_by_distribution():
    """The port's draws cannot match jax.random's bits; their distribution
    does: share of zeros near the rate, mean near 1."""
    from studiosr_tpu_torch.models.blocks import drop_path_scales

    s = drop_path_scales(20000, 0.1, torch.Generator().manual_seed(0), n=2)
    assert s.shape == (20000, 2)
    assert abs(float((s == 0).float().mean()) - 0.1) < 0.01
    assert abs(float(s.mean()) - 1.0) < 0.02
    assert torch.unique(s).tolist() == [0.0, float(torch.tensor(1.0 / 0.9))]
    from studiosr_tpu_torch.models.blocks import DropPath

    x = torch.ones(8, 2, 2, 3)
    layer = DropPath(0.5)
    assert layer.eval()(x) is x
    y = layer.train()(x, generator=torch.Generator().manual_seed(1))
    per_sample = y.reshape(8, -1)
    assert set(torch.unique(per_sample).tolist()) <= {0.0, 2.0}
    assert (per_sample == per_sample[:, :1]).all()  # one scale per sample


def test_fused_train_requires_no_dropout():
    from studiosr_tpu_torch import SwinIR

    model = SwinIR.build(**CFG, drop_rate=0.1, device="cpu")
    with pytest.raises(NotImplementedError, match="drop==0"):
        model.module.fused_train = True


# -- the train step -------------------------------------------------------------


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_matches_jax(accum_steps):
    """Three f32 steps of ``make_train_step`` against the JAX step: Adam with
    L2, a milestone at optimizer step 2, EMA; with accum_steps 2 only every
    second step updates (and decays the EMA)."""
    from studiosr_tpu.parallel import build_optimizer as jax_build_optimizer
    from studiosr_tpu.parallel import get_mesh, prepare_state as jax_prepare_state, shard_batch
    from studiosr_tpu.parallel import make_train_step as jax_make_train_step
    from studiosr_tpu.parallel.train_step import multistep_schedule as jax_schedule
    from studiosr_tpu.utils.losses import l1_loss as jax_l1
    from studiosr_tpu_torch.parallel import build_optimizer, make_train_step, multistep_schedule, prepare_state
    from studiosr_tpu_torch.utils import l1_loss
    from studiosr_tpu_torch.zoo import jax_params_to_state_dict

    opt = dict(learning_rate=1e-3, weight_decay=1e-2, milestones=[2], gamma=0.5, accum_steps=accum_steps)
    jax_model, model = _models()
    mesh = get_mesh(jax.devices()[:1])
    jtx = jax_build_optimizer(**opt)
    jstate = jax_prepare_state(jax_model.variables, jtx, mesh, ema_decay=0.9)
    jstep = jax_make_train_step(jax_model.module, jtx, jax_l1, bfloat16=False, mesh=mesh, donate=False, ema_decay=0.9)
    tx = build_optimizer(**opt)
    state = prepare_state(model.module, tx, ema_decay=0.9)
    step = make_train_step(model.module, tx, l1_loss, bfloat16=False, ema_decay=0.9)
    for i in range(3):
        rng = np.random.default_rng(100 + i)
        lq = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
        gt = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
        jstate, jloss = jstep(jstate, *shard_batch((jnp.asarray(lq), jnp.asarray(gt)), mesh), jax.random.PRNGKey(i))
        state, loss = step(state, torch.from_numpy(lq), torch.from_numpy(gt))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        want = jax_params_to_state_dict(jstate.params)
        want_ema = jax_params_to_state_dict(jstate.ema_params)
        for k, p in state.params.items():
            got, exp, got_ema, exp_ema = p.detach().numpy(), want[k], state.ema_params[k].numpy(), want_ema[k]
            if k.endswith("qkv.bias"):
                # the k bias has a true gradient of 0 (softmax ignores a
                # per-row shift), so Adam turns f32 noise into its step
                c = got.shape[0] // 3
                keep = np.r_[0:c, 2 * c : 3 * c]
                got, exp, got_ema, exp_ema = got[keep], exp[keep], got_ema[keep], exp_ema[keep]
            np.testing.assert_allclose(got, exp, atol=2e-6, rtol=1e-4, err_msg=f"step {i} {k}")
            np.testing.assert_allclose(got_ema, exp_ema, atol=2e-6, rtol=1e-4, err_msg=f"step {i} ema {k}")
    assert state.step == 3 and state.opt_state["count"] == (3 if accum_steps == 1 else 1)
    lr, jlr = multistep_schedule(2e-4, [2, 4], 0.5), jax_schedule(2e-4, [2, 4], 0.5)
    for count in range(6):
        np.testing.assert_allclose(lr(count), float(jlr(count)), rtol=1e-6)


def test_bf16_step_keeps_f32_masters():
    """The bf16 policy computes in bf16 copies; the state stays f32."""
    from studiosr_tpu_torch.parallel import build_optimizer, make_train_step, prepare_state
    from studiosr_tpu_torch.utils import l1_loss

    _, model = _models()
    tx = build_optimizer()
    state = prepare_state(model.module, tx)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    x, gt = _batch()
    state, loss = make_train_step(model.module, tx, l1_loss, bfloat16=True)(state, _t(x), _t(gt))
    assert torch.isfinite(loss) and loss.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert any(not torch.equal(p, before[k]) for k, p in state.params.items())
    assert not model.module.training
    with pytest.raises(TypeError, match="f32"):
        prepare_state(model.half().module, tx)
