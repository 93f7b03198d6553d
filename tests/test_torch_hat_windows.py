"""HAT at every window: B10, B12 and B13 beyond windows 8 and 16, on the CPU.

The port against the JAX package on the same numpy inputs from a seed:

* B12 / B13's plain versions at the OCA geometries of HAT's windows 4, 12
  and 24 (overlap 0.5: 16 | 36, 144 | 324 and 576 | 1296 queries | keys)
  against ``oca_attention`` and its VJP, which take the Pallas kernels in
  interpret mode where ``oca_supported`` takes the geometry (window 24) and
  the XLA route where it declines (4 and 12, whose key counts are not
  multiples of 8);
* B10's plain version, and the block read back from the images the H100
  kernels read (a window's ws^2 queries padded to whole 64-token tiles),
  against the JAX package's XLA ``_ocab`` at windows 4, 12 and 24 (the
  Pallas ``fused_ocab_block`` declines all three);
* ``pack_key_images`` (the gather pass's plain version) at windows 4, 12
  and 24 (1296 keys: past the 576 that a unit's images held whole before)
  against the gather built element by element, bit for bit;
* HAT's fast forward against ``hat_fast_forward(..., interpret=True)`` at
  windows 12 and 24, and HAT's fused-train loss and gradients against the
  JAX package's at window 24;
* the card's routes at every window from 2 to 32 with an even key margin,
  both dtypes, driven with a stand-in library: B10, B12 and B13 each reach a
  kernel entry and none raises.

Tolerances: B12 atol 2e-5, rtol 1e-4 and B13 atol 3e-4, rtol 2e-3
(tests/ops/test_oca_vjp.py's); B10 and the fast forward atol 5e-5, rtol 1e-4
(tests/ops/test_fused_swin.py's); the gradients rtol 1e-5 on the loss, atol
2e-5, rtol 1e-3 (tests/ops/test_fused_train.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.models.hat import HAT as JaxHAT
from studiosr_tpu.ops.oca_vjp import oca_attention as jax_oca_attention
from studiosr_tpu.ops.pallas.oca_core import oca_supported
from studiosr_tpu.serving.hat_fast import _ocab as jax_ocab
from studiosr_tpu.serving.hat_fast import hat_fast_forward as jax_hat_fast_forward
from studiosr_tpu_torch import HAT
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.oca_core import counter, oca_core_bwd, oca_core_fwd
from studiosr_tpu_torch.ops.cuda.ocab import (
    fused_ocab_block, ocab_f32_mma_takes, ocab_mma_takes, overlap_window, pack_key_images, pack_ocab_block,
)
from studiosr_tpu_torch.ops.windows import gather_rel_bias, relative_position_index_oca
from studiosr_tpu_torch.serving.hat_fast import hat_fast_forward
from studiosr_tpu_torch.zoo import jax_params_to_state_dict, load_jax_params
from tests.test_torch_ocab_mma import _FakeLibrary, _block_from_images, _block_ops, _expected_key_images, _images
from studiosr_tpu_torch.ops.cuda._launch import STREAM

torch.set_num_threads(2)


def _meta_call(device, entry, *args):
    """``_launch.call`` for operands on the meta device, which reach the
    launch path without a card: no card to make current, stream 0."""
    return entry(*(0 if a is STREAM else a for a in args))


# every window from 2 to 32 whose key margin is even at overlap 0.5
HAT_WINDOWS = [ws for ws in range(2, 33) if int(ws * 0.5) % 2 == 0]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _f(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# -- B12 / B13 -------------------------------------------------------------------------------------


@pytest.mark.parametrize("ws,bw", [(4, 2), (12, 2), (24, 1)])
def test_oca_core_plain_matches_jax_at_window(ws, bw):
    """Forward and backward (dq, dk, dv, d bias summed over the windows) at
    2 heads of 16."""
    owin, _ = overlap_window(ws, 0.5)
    heads, nq, nk, d = 2, ws * ws, owin * owin, 16
    rng = np.random.default_rng(ws)
    q, k, v = _f(rng, bw, heads, nq, d, scale=0.3), _f(rng, bw, heads, nk, d, scale=0.3), _f(rng, bw, heads, nk, d)
    bias, g = _f(rng, heads, nq, nk, scale=0.5), _f(rng, bw, heads, nq, d)
    assert oca_supported(heads, nq, nk) == (ws == 24)  # interpret mode at 24, the XLA route at 4 and 12
    args = [jnp.asarray(a) for a in (q, k, v, bias)]
    want, pull = jax.vjp(jax_oca_attention, *args)
    want_grads = pull(jnp.asarray(g))
    np.testing.assert_allclose(oca_core_fwd(*map(_t, (q, k, v, bias))).numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    got = oca_core_bwd(*map(_t, (q, k, v, bias, g)))
    for name, a, e in zip(["dq", "dk", "dv", "dbias"], got, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=3e-4, rtol=2e-3, err_msg=name)


# -- B10 ---------------------------------------------------------------------------------------------


@pytest.mark.parametrize("ws,shape", [(4, (1, 8, 12)), (12, (1, 12, 24)), (24, (1, 24, 24))])
def test_ocab_plain_matches_jax_at_window(ws, shape):
    """C 32, 2 heads, hidden 64, on the gathered rel-pos bias of one table:
    the CPU wrapper on the packed blob and the block read back from the
    H100 kernels' images, against the XLA ``_ocab``."""
    c, heads, overlap = 32, 2, 0.5
    rng = np.random.default_rng(100 + ws)
    owin, _ = overlap_window(ws, overlap)
    ops = _block_ops(rng, c, heads, ws, owin, 2 * c)
    table = _f(rng, (ws + owin - 1) ** 2, heads, scale=0.5)
    ops[6] = gather_rel_bias(_t(table), relative_position_index_oca(ws, overlap), heads).numpy()
    x = _f(rng, *shape, c)
    p = {"norm1": {"scale": ops[0], "bias": ops[1]}, "qkv": {"kernel": ops[2], "bias": ops[3]},
         "proj": {"kernel": ops[4], "bias": ops[5]}, "relative_position_bias_table": table,
         "norm2": {"scale": ops[7], "bias": ops[8]},
         "mlp": {"fc1": {"kernel": ops[9], "bias": ops[10]}, "fc2": {"kernel": ops[11], "bias": ops[12]}}}
    want = np.asarray(jax_ocab(jnp.asarray(x), p, heads, ws, overlap))
    tops = [_t(a) for a in ops]
    served = list(tops)
    served[2], served[4], served[9], served[11] = pack_ocab_block(tops[2], tops[4], tops[9], tops[11], heads), None, \
        None, None
    got = fused_ocab_block(_t(x), *served, heads=heads, window_size=ws, overlap_ratio=overlap)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)
    img = _images(_t(x), tops, heads, ws, overlap)
    np.testing.assert_allclose(_block_from_images(_t(x), tops, img, heads, ws, overlap).numpy(), want, atol=5e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("ws,shape,heads,d",
                         [(4, (2, 8, 12), 2, 8), (12, (1, 24, 12), 2, 16), (24, (1, 24, 48), 1, 30)])
def test_key_images_match_their_rule_at_window(ws, shape, heads, d):
    owin, pad = overlap_window(ws, 0.5)
    rng = np.random.default_rng(ws + d)
    k, v = _f(rng, *shape, heads, d), _f(rng, *shape, heads, d)
    got = pack_key_images(_t(k), _t(v), ws, 0.5).numpy()
    want = _expected_key_images(k, v, ws, pad)
    assert got.shape == want.shape and got.shape[1] == 2 * -(-owin * owin // 64) * 64 * (16 if d <= 16 else 32)
    np.testing.assert_array_equal(got, want)


# -- the model -------------------------------------------------------------------------------------------

HAT_CFG = dict(scale=2, embed_dim=16, depths=[1], num_heads=[2], mlp_ratio=2.0, drop_path_rate=0.0, overlap_ratio=0.5,
               compress_ratio=2, squeeze_factor=4)


def _seeded(variables, seed):
    """Every leaf of a fast-initialised (all-zero) JAX model drawn from a
    seeded normal, as the JAX package's initialisers draw them but cheaper:
    kernels scaled by 1 / sqrt(fan-in), biases zero, LayerNorm scales 1 +
    0.1 n, the rel-pos tables 0.5 n (so the bias matters), the rest 0.02 n."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            v = rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif name.endswith("['scale']"):
            v = 1 + 0.1 * rng.standard_normal(a.shape)
        elif name.endswith("['bias']"):
            v = np.zeros(a.shape)
        else:
            v = (0.5 if "relative_position_bias_table" in name else 0.02) * rng.standard_normal(a.shape)
        return jnp.asarray(v, a.dtype)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _models(ws):
    """A JAX HAT and the port's on the same seeded weights."""
    jax_model = JaxHAT.build(**HAT_CFG, window_size=ws, fast_init=True)
    jax_model.variables = _seeded(jax_model.variables, ws)
    model = HAT.build(**HAT_CFG, window_size=ws, device="cpu")
    load_jax_params(model.module, jax_model.variables["params"])
    return jax_model, model


@pytest.mark.parametrize("ws,shape", [(12, (1, 12, 24, 3)), (24, (1, 20, 24, 3))])
def test_fast_forward_matches_jax_at_window(ws, shape):
    jax_model, model = _models(ws)
    x = np.random.default_rng(ws).random(shape, dtype=np.float32)
    want = np.asarray(jax_hat_fast_forward(jax_model.variables, jnp.asarray(x), jax_model.config, interpret=True))
    engagement.reset()
    with torch.inference_mode():
        got = hat_fast_forward(model.module, _t(x), model.config)
    assert engagement.counters() == {}  # CPU tensors take the plain versions
    assert got.shape == (1, 2 * shape[1], 2 * shape[2], 3)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)


def test_fused_train_hat_matches_jax_at_window_24():
    """Loss and every gradient by name against ``HATModule(fused_train=True)``
    ``value_and_grad`` on one 24 x 24 window a sample (576 queries, 1296
    keys in the OCAB)."""
    jax_model, model = _models(24)
    rng = np.random.default_rng(24)
    x, gt = _f(rng, 2, 24, 24, 3), _f(rng, 2, 48, 48, 3)
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


# -- the card's routes -----------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ws", HAT_WINDOWS)
def test_every_even_margin_window_reaches_a_kernel(monkeypatch, ws, dtype):
    """HAT x4 serving's widths (C 180, 6 heads, hidden 360) for B10 and the
    OCA core on 2 x 3 windows: bf16 B10 on the kernels written for the H100,
    f32 on its 3xTF32 kernels up to 256 queries and 576 keys and on ocab.cu
    above; B12 / B13 in bf16 on the H100 entries (the large ones
    above 256 queries or 576 keys), in f32 on oca_core.cu but B13 up to
    256 queries and 576 keys on its 3xTF32 entry; nothing raises."""
    import studiosr_tpu_torch.ops.cuda.oca_core as oca_module
    import studiosr_tpu_torch.ops.cuda.ocab as ocab_module
    from studiosr_tpu_torch.ops.cuda import _build

    monkeypatch.setattr(_build, "load", lambda name, signatures, restypes=None: _FakeLibrary())
    monkeypatch.setattr(ocab_module, "call", _meta_call)
    monkeypatch.setattr(oca_module, "call", _meta_call)
    c, heads, hidden, f32 = 180, 6, 360, torch.float32
    owin, _ = overlap_window(ws, 0.5)
    nq, nk, d = ws * ws, owin * owin, c // heads
    meta = lambda *s, dt=dtype: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    attn = [meta(c, dt=f32), meta(c, dt=f32), meta(c, 3 * c), meta(3 * c, dt=f32), meta(c, c), meta(c, dt=f32)]
    mlp = [meta(c, dt=f32), meta(c, dt=f32), meta(c, hidden), meta(hidden, dt=f32), meta(hidden, c), meta(c, dt=f32)]
    engagement.reset()
    out = fused_ocab_block(meta(1, 2 * ws, 3 * ws, c), *attn, meta(heads, nq, nk, dt=f32), *mlp, heads=heads,
                           window_size=ws, overlap_ratio=0.5)
    assert out.shape == (1, 2 * ws, 3 * ws, c)
    q, k = meta(6, heads, nq, d), meta(6, heads, nk, d)
    oca_core_fwd(q, k, k, meta(heads, nq, nk, dt=f32))
    oca_core_bwd(q, k, k, meta(heads, nq, nk, dt=f32), q)
    bf16 = dtype == torch.bfloat16
    assert ocab_mma_takes(c, heads, ws, 0.5, hidden)
    large = nq > 256 or nk > 576
    kind = ("large_mma_bf16" if large else "mma_bf16") if bf16 else "f32"
    bwd_kind = "f32" if large else "mma_f32"  # f32 B13 up to window 16 on its 3xTF32 entry
    f32_entry = "ocab_mma_f32" if ocab_f32_mma_takes(c, heads, ws, 0.5, hidden) else "ocab_f32"
    assert engagement.entries() == {"fused_ocab_block": {"ocab_mma_bf16" if bf16 else f32_entry: 1},
                                    counter("oca_core_fwd", nq, nk): {f"oca_core_fwd_{kind}": 1},
                                    counter("oca_core_bwd", nq, nk): {f"oca_core_bwd_{kind if bf16 else bwd_kind}": 1}}
    engagement.reset()
