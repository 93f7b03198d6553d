"""Plain versions of the port's CUDA kernels vs the Pallas kernels.

Each port kernel wrapper takes its plain PyTorch version on CPU tensors;
the JAX side runs the Pallas kernel in interpret mode. Inputs and weights
come from one numpy generator and go to both. f32 tolerances as in
tests/ops/test_fused_swin.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.ops.pallas.conv3x3 import fused_conv3x3 as jax_fused_conv3x3
from studiosr_tpu.ops.pallas.swin_block import fused_swin_block as jax_fused_swin_block
from studiosr_tpu.ops.pallas.upsampler import fused_upsample_x4 as jax_fused_upsample_x4
from studiosr_tpu.ops.windows import calculate_mask
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.conv3x3 import (
    fused_conv3x3, pack_conv3x3_weights, packed_conv3x3_shape, parse_activation, prepare_fused_conv3x3_weights,
    unpack_conv3x3_weights,
)
from studiosr_tpu_torch.ops.cuda.swin_block import fused_swin_block
from studiosr_tpu_torch.ops.cuda.upsampler import fused_upsample_x4

torch.set_num_threads(2)

ATOL, RTOL = 5e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _block_operands(rng, c, heads, ws, hidden):
    n = ws * ws
    f = lambda *s, scale=1.0: (rng.standard_normal(s, dtype=np.float32) * scale).astype(np.float32)
    return dict(
        ln1_w=1.0 + f(c, scale=0.1), ln1_b=f(c, scale=0.1),
        wqkv=f(c, 3 * c, scale=c**-0.5), bqkv=f(3 * c, scale=0.1),
        wproj=f(c, c, scale=c**-0.5), bproj=f(c, scale=0.1),
        bias=f(heads, n, n, scale=0.5),
        ln2_w=1.0 + f(c, scale=0.1), ln2_b=f(c, scale=0.1),
        w1=f(c, hidden, scale=c**-0.5), b1=f(hidden, scale=0.1),
        w2=f(hidden, c, scale=hidden**-0.5), b2=f(c, scale=0.1),
    )


@pytest.mark.parametrize("shift", [0, 4])
def test_swin_block_plain_matches_pallas(shift):
    """B1 at C 32, 2 heads, ws 8 on a 16x24 map (windows both ways). The
    shifted JAX block is roll(+s) . fused_swin_block(roll(x, -s), mask)."""
    rng = np.random.default_rng(shift)
    c, heads, ws, hidden = 32, 2, 8, 64
    x = rng.standard_normal((2, 16, 24, c), dtype=np.float32)
    ops = _block_operands(rng, c, heads, ws, hidden)
    mask = jnp.asarray(calculate_mask((16, 24), ws, shift)) if shift else None
    jx = jnp.roll(jnp.asarray(x), (-shift, -shift), axis=(1, 2))
    want = jax_fused_swin_block(
        jx, ops["ln1_w"], ops["ln1_b"], ops["wqkv"], ops["bqkv"], ops["wproj"], ops["bproj"], ops["bias"], mask,
        ops["ln2_w"], ops["ln2_b"], ops["w1"], ops["b1"], ops["w2"], ops["b2"],
        heads=heads, window_size=ws, interpret=True,
    )
    want = np.asarray(jnp.roll(want, (shift, shift), axis=(1, 2)))
    got = fused_swin_block(_t(x), **{k: _t(v) for k, v in ops.items()}, heads=heads, window_size=ws, shift=shift)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize(
    "cin,cout,activation,residual,with_extra",
    [
        (8, 12, None, False, False),
        (8, 12, "relu", False, False),
        (8, 12, "lrelu0.2", False, False),
        (8, 8, "lrelu", True, False),
        (12, 12, None, False, True),
        (12, 12, "relu", True, True),
    ],
)
def test_conv3x3_plain_matches_pallas(cin, cout, activation, residual, with_extra):
    rng = np.random.default_rng(cin + cout)
    x = rng.standard_normal((2, 16, 12, cin), dtype=np.float32)
    w = (rng.standard_normal((3, 3, cin, cout), dtype=np.float32) * 0.2).astype(np.float32)
    b = rng.standard_normal(cout, dtype=np.float32)
    extra = rng.standard_normal((2, 16, 12, cout), dtype=np.float32) if with_extra else None
    want = jax_fused_conv3x3(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), activation=activation, residual=residual,
        extra=None if extra is None else jnp.asarray(extra), interpret=True,
    )
    got = fused_conv3x3(_t(x), _t(w), _t(b), activation, residual, None if extra is None else _t(extra))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("cin,cout", [(180, 180), (20, 48), (3, 3), (32, 200), (12, 70), (17, 33)])
def test_packed_conv3x3_weights_round_trip(cin, cout):
    """B2's packed layout: (Cout blocks of 192, Cin stages of 16, 9 taps,
    16, 192 + 8), every value of the HWIO weights once, zeros everywhere
    else."""
    rng = np.random.default_rng(cin + cout)
    w = torch.from_numpy(rng.standard_normal((3, 3, cin, cout), dtype=np.float32)).to(torch.bfloat16)
    packed = pack_conv3x3_weights(w)
    assert tuple(packed.shape) == packed_conv3x3_shape(cin, cout) and packed.dtype == torch.bfloat16
    block = 192
    assert packed.shape[0] == -(-cout // block) and packed.shape[1] == -(-cin // 16) and packed.shape[-1] == block + 8
    assert torch.equal(unpack_conv3x3_weights(packed, cin, cout), w)
    assert not packed[..., block:].any()
    assert int(torch.count_nonzero(packed)) == int(torch.count_nonzero(w))
    tap, ci, co = 7, cin - 1, cout - 1  # (2, 1, Cin - 1, Cout - 1) sits in its block, stage and row
    assert packed[co // block, ci // 16, tap, ci % 16, co % block] == w[2, 1, ci, co]
    with pytest.raises(ValueError, match="do not fit"):
        unpack_conv3x3_weights(packed, cin + 16, cout)


@pytest.mark.parametrize("activation,residual", [(None, False), ("lrelu0.2", True)])
def test_packed_conv3x3_plain_matches_hwio_and_pallas(activation, residual):
    """The plain version on packed weights equals it on the HWIO weights
    they came from, and the Pallas kernel in interpret mode (weights rounded
    to bf16 for all three: the packed layout is bf16)."""
    rng = np.random.default_rng(3)
    cin = cout = 20
    x = rng.standard_normal((2, 9, 13, cin), dtype=np.float32)
    w = torch.from_numpy(rng.standard_normal((3, 3, cin, cout), dtype=np.float32) * 0.2).to(torch.bfloat16).float()
    b = rng.standard_normal(cout, dtype=np.float32)
    extra = rng.standard_normal((2, 9, 13, cout), dtype=np.float32)
    prepared = prepare_fused_conv3x3_weights(w.permute(3, 2, 0, 1), torch.bfloat16)
    assert torch.equal(prepared, pack_conv3x3_weights(w))
    assert torch.equal(prepare_fused_conv3x3_weights(w.permute(3, 2, 0, 1), torch.float32), w)  # f32 keeps HWIO
    got = fused_conv3x3(_t(x), prepared, _t(b), activation, residual, _t(extra))
    hwio = fused_conv3x3(_t(x), w, _t(b), activation, residual, _t(extra))
    assert torch.equal(got, hwio)
    want = jax_fused_conv3x3(jnp.asarray(x), jnp.asarray(w.numpy()), jnp.asarray(b), activation=activation,
                             residual=residual, extra=jnp.asarray(extra), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_upsample_x4_plain_matches_pallas():
    rng = np.random.default_rng(7)
    cin, n_colors = 16, 3
    x = rng.standard_normal((1, 16, 16, cin), dtype=np.float32)
    f = lambda *s, scale: (rng.standard_normal(s, dtype=np.float32) * scale).astype(np.float32)
    ws_ = [f(3, 3, cin, 4 * cin, scale=0.1), f(4 * cin, scale=0.1), f(3, 3, cin, 4 * cin, scale=0.1),
           f(4 * cin, scale=0.1), f(3, 3, cin, n_colors, scale=0.1), f(n_colors, scale=0.1)]
    want = jax_fused_upsample_x4(jnp.asarray(x), *[jnp.asarray(a) for a in ws_], interpret=True)
    assert want is not None
    got = fused_upsample_x4(_t(x), *[_t(a) for a in ws_])
    assert tuple(got.shape) == (1, 64, 64, n_colors)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    engagement.reset()
    x = torch.zeros(1, 8, 8, 4)
    fused_conv3x3(x, torch.zeros(3, 3, 4, 4), torch.zeros(4))
    assert engagement.counters() == {}


@pytest.mark.parametrize(
    "kind,want", [(None, (None, 0.0)), ("relu", ("relu", 0.0)), ("lrelu", ("lrelu", 0.01)), ("lrelu0.2", ("lrelu", 0.2))]
)
def test_parse_activation(kind, want):
    assert parse_activation(kind) == want
    with pytest.raises(ValueError):
        parse_activation("gelu")


class _FakeLibrary:
    """Stands in for a built kernel library: records which C entry a wrapper
    called and with what, and returns status 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


def _fake_launches(monkeypatch, module):
    """Route ``module``'s launches to a _FakeLibrary: tensors on the meta
    device reach the launch path without a card."""
    from studiosr_tpu_torch.ops.cuda import _build

    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda name, signatures: lib)
    monkeypatch.setattr(module, "stream", lambda device: 0)
    engagement.reset()
    return lib


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "conv3x3_mma_bf16"), (torch.float32, "conv3x3_f32")])
def test_conv3x3_launch_takes_the_entry_of_its_dtype(monkeypatch, dtype, entry):
    """bf16 goes to the kernel written for the H100 (HWIO weights packed on
    the way, packed ones as they are), f32 to the FMA kernel; each launch
    counts under ``fused_conv3x3`` and under its entry."""
    import studiosr_tpu_torch.ops.cuda.conv3x3 as module

    lib = _fake_launches(monkeypatch, module)
    x = torch.empty(1, 9, 13, 180, dtype=dtype, device="meta")
    w = torch.empty(3, 3, 180, 180, dtype=dtype, device="meta")
    b = torch.empty(180, device="meta")
    out = fused_conv3x3(x, w, b, "lrelu0.2", True, torch.empty_like(x))
    assert out.shape == x.shape and out.dtype == dtype and out.device.type == "meta"
    assert [name for name, _ in lib.calls] == [entry]
    assert lib.calls[0][1][5:13] == (1, 9, 13, 180, 180, 2, 0.2, 1)  # B, H, W, Cin, Cout, act, slope, residual
    assert engagement.counters() == {"fused_conv3x3": 1}
    assert engagement.entries() == {"fused_conv3x3": {entry: 1}}
    if dtype == torch.bfloat16:
        fused_conv3x3(x, pack_conv3x3_weights(w), b, "lrelu0.2", True, torch.empty_like(x))
        assert engagement.entries() == {"fused_conv3x3": {entry: 2}}
        with pytest.raises(ValueError, match="shape"):  # packed for another Cin
            fused_conv3x3(x, pack_conv3x3_weights(w[:, :, :64]), b)
    else:
        with pytest.raises(ValueError, match="shape"):  # f32 takes HWIO only
            fused_conv3x3(x, torch.empty(1, 12, 9, 16, 200, dtype=dtype, device="meta"), b)
    engagement.reset()
    assert engagement.entries() == {}


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "window_attn_flash_bf16"), (torch.float32, "window_attn_f32")])
def test_window_attention_launch_reads_slices_in_place(monkeypatch, dtype, entry):
    """q, k, v reach the kernel as the strided slices of one projection (N
    64 queries, M 36 keys), the output as a transposed view; a mask over
    two images gives nW 2."""
    import studiosr_tpu_torch.ops.cuda.window_attn as module

    lib = _fake_launches(monkeypatch, module)
    bw, heads, n, m, d = 4, 3, 64, 36, 12
    qkv = torch.empty(bw, n, 3, heads, d, dtype=dtype, device="meta").permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1][:, :, :m], qkv[2][:, :, :m]
    mask = torch.empty(2, n, m, device="meta")
    out = module.window_attention(q, k, v, bias=torch.empty(heads, n, m, device="meta"), mask=mask)
    assert out.shape == (bw, heads, n, d) and out.stride() == (n * heads * d, d, heads * d, 1)
    assert [name for name, _ in lib.calls] == [entry]
    args = lib.calls[0][1]
    token = 3 * heads * d
    assert list(args[6]) == [n * token, d, token] * 3 + [n * heads * d, d, heads * d]
    assert args[7:13] == (bw, heads, n, m, d, 2)
    assert engagement.entries() == {"window_attention_pallas": {entry: 1}}
