"""HAT fused training of the port vs the JAX package on the CPU, f32.

B12 / B13 plain versions against ``oca_core_fwd`` / ``oca_core_bwd`` in
interpret mode, B9's plain version (``attention_bwd_plain`` at window 16)
against ``v5_attention_bwd`` in interpret mode, the autograd Functions
(``oca_attention``, ``attention_map_vjp`` at window 16) against autograd of
their plain math, the fused-train HAT against ``HATModule(fused_train=True)``
at window 8 and 16, and ``make_train_step`` on HAT against the JAX train
step. Inputs come from numpy seeds and go to both packages. Tolerances are
those of the JAX package's own tests named at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.ops.oca_vjp import _core_math
from studiosr_tpu.ops.pallas.attn_bwd import v5_attention_bwd
from studiosr_tpu.ops.pallas.oca_core import oca_core_bwd as jax_oca_core_bwd
from studiosr_tpu.ops.pallas.oca_core import oca_core_fwd as jax_oca_core_fwd
from studiosr_tpu.ops.windows import calculate_mask
from studiosr_tpu_torch import HAT, Trainer
from studiosr_tpu_torch.ops.attn_vjp import attention_map_vjp
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.attn_bwd import attention_bwd
from studiosr_tpu_torch.ops.cuda.oca_core import oca_core_bwd, oca_core_bwd_plain, oca_core_fwd, oca_core_plain
from studiosr_tpu_torch.ops.cuda.window_attention import window_attention_plain
from studiosr_tpu_torch.ops.oca_vjp import oca_attention

torch.set_num_threads(2)

GRAD_NAMES_ATTN = ["dx", "ds", "db", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _oca_operands(bw=6, heads=2, nq=64, nk=144, d=30, seed=0):
    """tests/ops/test_oca_vjp.py's operands."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((bw, heads, nq, d)) * 0.2).astype(np.float32)
    k = (rng.standard_normal((bw, heads, nk, d)) * 0.2).astype(np.float32)
    v = (rng.standard_normal((bw, heads, nk, d)) * 0.5).astype(np.float32)
    bias = (rng.standard_normal((heads, nq, nk)) * 0.05).astype(np.float32)
    g = rng.standard_normal((bw, heads, nq, d)).astype(np.float32)
    return q, k, v, bias, g


def test_oca_core_plain_matches_pallas():
    """B12 vs ``oca_core_fwd(interpret=True)`` at nq 64, nk 144, d 30 (atol
    2e-5, rtol 1e-4, as tests/ops/test_oca_vjp.py); the plain version is
    ``_core_math``."""
    q, k, v, bias, _ = _oca_operands()
    want = np.asarray(jax_oca_core_fwd(*map(jnp.asarray, (q, k, v, bias)), interpret=True))
    got = oca_core_fwd(*map(_t, (q, k, v, bias)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(oca_core_plain(*map(_t, (q, k, v, bias))).numpy(),
                               np.asarray(_core_math(*map(jnp.asarray, (q, k, v, bias)))), atol=2e-5, rtol=1e-4)


def test_oca_core_bwd_plain_matches_pallas():
    """B13 vs ``oca_core_bwd(interpret=True)`` (atol 3e-4, rtol 2e-3)."""
    q, k, v, bias, g = _oca_operands(seed=1)
    want = jax_oca_core_bwd(*map(jnp.asarray, (q, k, v, bias, g)), interpret=True)
    got = oca_core_bwd(*map(_t, (q, k, v, bias, g)))
    assert got[3].dtype == torch.float32 and got[3].shape == (2, 64, 144)
    for name, a, e in zip(["dq", "dk", "dv", "dbias"], got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=3e-4, rtol=2e-3, err_msg=name)


def test_oca_attention_grads_match_autograd_of_plain():
    """The autograd Function (B12 forward, B13 backward) against autograd of
    the plain forward, on the transposed views the OCAB hands it."""
    q, k, v, bias, g = _oca_operands(bw=4, nq=64, nk=144, d=16, seed=2)
    leaves = [_t(a.transpose(0, 2, 1, 3).copy()).transpose(1, 2).requires_grad_() for a in (q, k, v)]
    leaves.append(_t(bias).requires_grad_())
    got = torch.autograd.grad((oca_attention(*leaves) * _t(g)).sum(), leaves)
    want = torch.autograd.grad((oca_core_plain(*leaves) * _t(g)).sum(), leaves)
    for name, a, e in zip(["dq", "dk", "dv", "dbias"], got, want):
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
    with torch.no_grad():
        np.testing.assert_array_equal(oca_attention(*leaves).numpy(), oca_core_plain(*leaves).numpy())
    np.testing.assert_allclose(oca_core_bwd_plain(*[t.detach() for t in leaves], _t(g))[3].numpy(), want[3].numpy(),
                               atol=1e-5, rtol=1e-4)


def _attn_operands(rng, c, heads, ws):
    n = ws * ws
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    return dict(ln_w=1.0 + f(c, k=0.1), ln_b=f(c, k=0.1), wqkv=f(c, 3 * c, k=0.1), bqkv=f(3 * c, k=0.1),
                wproj=f(c, c, k=0.1), bproj=f(c, k=0.1), bias=f(heads, n, n, k=0.05))


@pytest.mark.parametrize("shift,dp", [(0, None), (8, (0.0, 1.25))])
def test_attention_bwd_ws16_plain_matches_pallas(shift, dp):
    """B9 vs ``v5_attention_bwd(interpret=True)`` as tests/ops/test_attn_bwd.py
    (b 2, 32x32, C 12, 2 heads, window 16; atol 3e-4, rtol 2e-3), without and
    with the shift mask and drop-path scales. The shifted case rolls the JAX
    operands and its dx; a 0 scale leaves that sample's dx equal to g."""
    rng = np.random.default_rng(50 + shift)
    b, h, w, c, heads, ws = 2, 32, 32, 12, 2, 16
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    ops = _attn_operands(rng, c, heads, ws)
    dps = None if dp is None else np.asarray(dp, np.float32)
    mask = jnp.asarray(calculate_mask((h, w), ws, shift)) if shift else None
    roll = lambda a: jnp.roll(jnp.asarray(a), (-shift, -shift), axis=(1, 2))  # noqa: E731
    want = v5_attention_bwd(
        roll(x), roll(g), *[jnp.asarray(v) for v in ops.values()], mask, None if dps is None else jnp.asarray(dps),
        heads=heads, window_size=ws, interpret=True,
    )
    assert want is not None
    want = [np.asarray(jnp.roll(want[0], (shift, shift), axis=(1, 2)))] + [np.asarray(a) for a in want[1:]]
    engagement.reset()
    got = attention_bwd(
        _t(x), _t(g), **{k: _t(v) for k, v in ops.items()}, heads=heads, window_size=ws, shift=shift,
        drop_path=None if dps is None else _t(dps),
    )
    assert engagement.counters() == {}
    for name, a, e in zip(GRAD_NAMES_ATTN, got, want):
        np.testing.assert_allclose(a.numpy(), e, atol=3e-4, rtol=2e-3, err_msg=name)
    if dps is not None:
        np.testing.assert_array_equal(got[0][0].numpy(), g[0])


def test_attention_map_vjp_ws16_grads_match_autograd_of_plain():
    """``attention_map_vjp`` at window 16 (B5 forward, B9 backward) against
    autograd of the plain forward, with shift, mask and a 0 scale."""
    rng = np.random.default_rng(60)
    b, h, w, c, heads, ws = 2, 32, 48, 16, 2, 16
    x = _t(rng.standard_normal((b, h, w, c)).astype(np.float32)).requires_grad_()
    g = _t(rng.standard_normal((b, h, w, c)).astype(np.float32))
    ops = {k: _t(v).requires_grad_() for k, v in _attn_operands(rng, c, heads, ws).items()}
    dp = torch.tensor([0.0, 1.25])
    args = (x, *ops.values())
    got = torch.autograd.grad((attention_map_vjp(*args, dp, 8, heads, ws) * g).sum(), args)
    want = torch.autograd.grad(
        (window_attention_plain(*args, heads=heads, window_size=ws, shift=8, drop_path=dp) * g).sum(), args
    )
    for name, a, e in zip(["dx"] + list(ops), got, want):
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=1e-4, rtol=1e-4, err_msg=name)


# -- the model ----------------------------------------------------------------

# tests/ops/test_fused_train.py's HAT_CFG (window 8, 12x12 OCAB key windows),
# and the same widths at HAT's window 16 (24x24 key windows) on 32x32 maps,
# whose second block is shifted by 8
HAT_CFG = dict(scale=2, embed_dim=16, depths=[2], num_heads=[2], window_size=8, mlp_ratio=2.0, drop_path_rate=0.0,
               overlap_ratio=0.5, compress_ratio=2, squeeze_factor=4)
SIZES = {8: 16, 16: 32}


def _models(ws, **over):
    from studiosr_tpu.models.hat import HAT as JaxHAT
    from studiosr_tpu_torch.zoo import load_jax_params

    cfg = {**HAT_CFG, "window_size": ws, **over}
    jax_model = JaxHAT.build(**cfg, fast_init=True)
    model = HAT.build(**cfg, device="cpu")
    load_jax_params(model.module, jax_model.variables["params"])
    return jax_model, model


def _batch(size, b=2, scale=2):
    x = np.random.default_rng(0).standard_normal((b, size, size, 3)).astype(np.float32)
    gt = np.random.default_rng(1).standard_normal((b, size * scale, size * scale, 3)).astype(np.float32)
    return x, gt


@pytest.mark.parametrize("ws", [8, 16])
def test_fused_train_hat_matches_jax(ws):
    """Loss and every gradient by name against ``HATModule(fused_train=True)``
    ``value_and_grad``, as tests/ops/test_fused_train.py (rtol 1e-5 on the
    loss, atol 2e-5, rtol 1e-3 on the gradients). norm1's gradients reach
    each HAB both through the CAB and through the attention half's backward:
    autograd sums the two."""
    from studiosr_tpu_torch.zoo import jax_params_to_state_dict

    jax_model, model = _models(ws)
    x, gt = _batch(SIZES[ws])
    fused = jax_model.module.clone(fused_train=True)

    def loss(params):
        out = fused.apply({"params": params}, jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(7)})
        return jnp.mean(jnp.abs(out - jnp.asarray(gt)))

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


def test_fused_and_plain_hat_agree_with_drop_path():
    """The same generator draws the same scales on both paths, so the fused
    module's loss and gradients equal plain autograd of the eager one."""
    model = HAT.build(**{**HAT_CFG, "window_size": 16, "drop_path_rate": 0.5}, device="cpu")
    module = model.module.train()
    x, gt = _batch(32, b=3)
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


def test_fused_train_flag_reaches_every_block_and_needs_no_dropout():
    model = HAT.build(**HAT_CFG, device="cpu", fused_train=True)
    blocks = [m for m in model.module.modules() if hasattr(m, "fused_train") and m is not model.module]
    assert len(blocks) == 3 and all(b.fused_train for b in blocks)  # two HABs and the OCAB
    model.module.fused_train = False
    assert not any(b.fused_train for b in blocks)
    with pytest.raises(NotImplementedError, match="drop==0"):
        HAT.build(**HAT_CFG, drop_rate=0.1, device="cpu").module.fused_train = True


def test_trainer_takes_hat_fused_path(tmp_path):
    """HAT passes the Trainer's fused-training check: off by default on the
    CPU, on when asked, and restored after the run."""
    _, model = _models(8)
    off = Trainer(model, None, batch_size=2, ckpt_path=str(tmp_path / "a"))
    on = Trainer(model, None, batch_size=2, ckpt_path=str(tmp_path / "b"), fused_train=True)
    assert (off.fused_train, on.fused_train) == (False, True)
    assert not model.module.fused_train


def test_train_step_hat_matches_jax():
    """One f32 step of ``make_train_step`` on the fused-train HAT at window 16
    against the JAX step on ``HATModule(fused_train=True)``: Adam with L2,
    EMA (tolerances of tests/test_torch_train.py's SwinIR step)."""
    from studiosr_tpu.parallel import build_optimizer as jax_build_optimizer
    from studiosr_tpu.parallel import get_mesh, prepare_state as jax_prepare_state, shard_batch
    from studiosr_tpu.parallel import make_train_step as jax_make_train_step
    from studiosr_tpu.utils.losses import l1_loss as jax_l1
    from studiosr_tpu_torch.parallel import build_optimizer, make_train_step, prepare_state
    from studiosr_tpu_torch.utils import l1_loss
    from studiosr_tpu_torch.zoo import jax_params_to_state_dict

    opt = dict(learning_rate=1e-3, weight_decay=1e-2, milestones=[2], gamma=0.5)
    jax_model, model = _models(16)
    mesh = get_mesh(jax.devices()[:1])
    jtx = jax_build_optimizer(**opt)
    jstate = jax_prepare_state(jax_model.variables, jtx, mesh, ema_decay=0.9)
    jstep = jax_make_train_step(jax_model.module.clone(fused_train=True), jtx, jax_l1, bfloat16=False, mesh=mesh,
                                donate=False, ema_decay=0.9)
    model.module.fused_train = True
    tx = build_optimizer(**opt)
    state = prepare_state(model.module, tx, ema_decay=0.9)
    step = make_train_step(model.module, tx, l1_loss, bfloat16=False, ema_decay=0.9)
    rng = np.random.default_rng(100)
    lq = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    gt = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    jstate, jloss = jstep(jstate, *shard_batch((jnp.asarray(lq), jnp.asarray(gt)), mesh), jax.random.PRNGKey(0))
    state, loss = step(state, torch.from_numpy(lq), torch.from_numpy(gt))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = jax_params_to_state_dict(jstate.params)
    want_ema = jax_params_to_state_dict(jstate.ema_params)
    assert sorted(state.params) == sorted(want)
    for k, p in state.params.items():
        got, exp, got_ema, exp_ema = p.detach().numpy(), want[k], state.ema_params[k].numpy(), want_ema[k]
        if k.endswith(".attn.qkv.bias"):
            # a window's k bias has a true gradient of 0 (softmax ignores a
            # per-row shift), so Adam turns f32 noise into its step
            c = got.shape[0] // 3
            keep = np.r_[0:c, 2 * c : 3 * c]
            got, exp, got_ema, exp_ema = got[keep], exp[keep], got_ema[keep], exp_ema[keep]
        np.testing.assert_allclose(got, exp, atol=2e-6, rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(got_ema, exp_ema, atol=2e-6, rtol=1e-4, err_msg=f"ema {k}")
    assert state.step == 1
