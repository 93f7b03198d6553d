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
from studiosr_tpu.ops.pallas.conv3x3 import fused_resblock as jax_fused_resblock
from studiosr_tpu.ops.pallas.swin_block import fused_swin_block as jax_fused_swin_block
from studiosr_tpu.ops.pallas.upsampler import fused_upsample_x4 as jax_fused_upsample_x4
from studiosr_tpu.ops.windows import calculate_mask
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.conv3x3 import (
    fused_conv3x3, fused_resblock, pack_conv3x3_f32_weights, pack_conv3x3_weights, packed_conv3x3_shape,
    parse_activation, prepare_fused_conv3x3_weights, resblock_plain, unpack_conv3x3_weights,
)
from studiosr_tpu_torch.ops.cuda.swin_block import (
    fused_swin_block, mma_geometry_error, pack_swin_f32, pack_swin_weights, swin_block_plain, swin_pack_stages,
    unpack_swin_weights,
)
from studiosr_tpu_torch.ops.cuda.upsampler import fused_upsample_x4
from studiosr_tpu_torch.ops.cuda._launch import STREAM

torch.set_num_threads(2)


def _meta_call(device, entry, *args):
    """``_launch.call`` for operands on the meta device, which reach the
    launch path without a card: no card to make current, stream 0."""
    return entry(*(0 if a is STREAM else a for a in args))


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
    assert torch.equal(prepare_fused_conv3x3_weights(w.permute(3, 2, 0, 1), torch.float32),
                       pack_conv3x3_f32_weights(w))  # f32 at Cout 20 > 16: the 3xTF32 kernel's images
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
    monkeypatch.setattr(_build, "load", lambda name, signatures, restypes=None: lib)
    monkeypatch.setattr(module, "call", _meta_call)
    engagement.reset()
    return lib


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "conv3x3_mma_bf16"), (torch.float32, "conv3x3_mma_f32")])
def test_conv3x3_launch_takes_the_entry_of_its_dtype(monkeypatch, dtype, entry):
    """bf16 goes to the kernel written for the H100, f32 (Cout 180 > 16) to
    the 3xTF32 kernel written for it (HWIO weights packed on the way, packed
    ones as they are); each launch counts under ``fused_conv3x3`` and under
    its entry."""
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
        fused_conv3x3(x, pack_conv3x3_f32_weights(w), b, "lrelu0.2", True, torch.empty_like(x))
        assert engagement.entries() == {"fused_conv3x3": {entry: 2}}
        with pytest.raises(ValueError, match="shape"):  # the bf16 layout's shape, in f32
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


# -- B1's and B14's packed weights (the bf16 kernels' load-time layouts) ----------

B1_GEOMETRIES = [(180, 6, 360), (32, 2, 64), (16, 2, 32), (24, 2, 48), (60, 6, 120), (20, 2, 40)]


def _bf16_block_weights(rng, c, heads, hidden):
    """Dense B1 weights rounded to bf16 (so the packed layout holds them
    exactly) and an f32 rel-pos bias."""
    ops = _block_operands(rng, c, heads, 8, hidden)
    dense = {k: torch.from_numpy(ops[k]).to(torch.bfloat16) for k in ("wqkv", "wproj", "w1", "w2")}
    return ops, dense, torch.from_numpy(ops["bias"])


def _reference_blob(wqkv, wproj, bias, w1, w2, heads):
    """The blob element by element, straight from the stage rule of
    ``csrc/swin_block_mma.cu`` (``SmGeom``, ``sm_kmajor``), independent of
    the packer: element (k, n) of a stage of K rows at (n / 8) K 8 + (k / 8)
    64 + (n % 8) 8 + k % 8."""
    c, hidden = wqkv.shape[0], w1.shape[1]
    d = c // heads
    pad16 = lambda v: -(-v // 16) * 16
    dp, kc = pad16(d), pad16(c)
    np_ = 32 if c <= 32 else 64 if c <= 64 else 96 if c <= 96 else 128 if c <= 128 else 184
    rows = lambda ncols: min(kc, 28672 // (2 * ncols) // 16 * 16)
    wqkv, wproj, w1, w2 = (t.float().numpy() for t in (wqkv, wproj, w1, w2))
    out = []

    def stage(nrows, ncols, value):
        a = np.zeros(nrows * ncols, np.float32)
        for k in range(nrows):
            for n in range(ncols):
                a[(n // 8) * nrows * 8 + (k // 8) * 64 + (n % 8) * 8 + k % 8] = value(k, n)
        out.append(torch.from_numpy(a).to(torch.bfloat16))

    for h in range(heads):
        for r0 in range(0, kc, rows(3 * dp)):
            def qkv(k, n, r0=r0, h=h):
                part, j = n // dp, n % dp
                return wqkv[r0 + k, part * c + h * d + j] if r0 + k < c and j < d else 0.0
            stage(min(rows(3 * dp), kc - r0), 3 * dp, qkv)
        frag = np.zeros(64 * 64, np.float32)
        for wr in range(4):
            for nt in range(8):
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for i in range(4):
                        frag[((wr * 8 + nt) * 32 + lane) * 4 + i] = bias[h, 16 * wr + g + 8 * (i // 2), 8 * nt + 2 * t + i % 2]
        out.append(torch.from_numpy(frag).view(torch.bfloat16))
        stage(dp, np_, lambda k, n, h=h: wproj[h * d + k, n] if k < d and n < c else 0.0)
    for c0 in range(0, hidden, 64):
        hc = pad16(min(64, hidden - c0))
        for r0 in range(0, kc, rows(hc)):
            stage(min(rows(hc), kc - r0), hc,
                  lambda k, n, r0=r0, c0=c0: w1[r0 + k, c0 + n] if r0 + k < c and c0 + n < hidden else 0.0)
        stage(hc, np_, lambda k, n, c0=c0: w2[c0 + k, n] if c0 + k < hidden and n < c else 0.0)
    return torch.cat(out)


@pytest.mark.parametrize("c,heads,hidden", B1_GEOMETRIES)
def test_packed_swin_weights_round_trip(c, heads, hidden):
    """B1's blob: every weight and bias value back bit for bit, zero
    padding everywhere else, stages of whole core matrices that fit a 28 KB
    ring slot."""
    rng = np.random.default_rng(c + heads)
    _, dense, bias = _bf16_block_weights(rng, c, heads, hidden)
    packed = pack_swin_weights(dense["wqkv"], dense["wproj"], bias, dense["w1"], dense["w2"], heads)
    assert packed.dtype == torch.bfloat16 and packed.dim() == 1
    got = unpack_swin_weights(packed, c, heads, hidden)
    for want, back in zip((dense["wqkv"], dense["wproj"], bias, dense["w1"], dense["w2"]), got):
        assert back.dtype == want.dtype and torch.equal(back, want)
    stages = swin_pack_stages(c, heads, hidden)
    elems = [nrows * ncols + (8192 if kind == "pb" else 0) for kind, _, _, nrows, ncols in stages]
    assert sum(elems) == packed.numel()
    for (kind, _, _, nrows, ncols), n in zip(stages, elems):
        assert nrows % 16 == 0 and ncols % 8 == 0  # whole wgmma k-steps and 8-column core matrices
        assert 2 * n <= 28672 and (2 * n) % 256 == 0  # fits a ring slot; stages stay 128-byte aligned
    # zero padding: the weights' nonzero bf16 values and the bias's nonzero halves, nothing else
    weights = sum(int(torch.count_nonzero(t)) for t in dense.values())
    assert int(torch.count_nonzero(packed)) == weights + int(torch.count_nonzero(bias.view(torch.bfloat16)))
    with pytest.raises(ValueError, match="do not fit"):
        unpack_swin_weights(packed, c, heads, hidden + 16)


@pytest.mark.parametrize("c,heads,hidden", [(24, 2, 48), (20, 2, 40)])
def test_packed_swin_weights_layout_matches_the_stage_rule(c, heads, hidden):
    """The packer against an element-by-element build of the stage rule
    (q|k|v columns per head in pad16(d) blocks, the bias in score-fragment
    order, proj rows per head, 64-unit hidden chunks, each stage in wgmma's
    K-major core-matrix order)."""
    rng = np.random.default_rng(11)
    _, dense, bias = _bf16_block_weights(rng, c, heads, hidden)
    packed = pack_swin_weights(dense["wqkv"], dense["wproj"], bias, dense["w1"], dense["w2"], heads)
    want = _reference_blob(dense["wqkv"], dense["wproj"], bias, dense["w1"], dense["w2"], heads)
    assert torch.equal(packed.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("shift", [0, 4])
def test_packed_swin_block_plain_matches_dense_and_pallas(shift):
    """The plain version on the packed blob equals it on the dense weights
    bit for bit, and the Pallas kernel in interpret mode (weights rounded to
    bf16 for all three)."""
    rng = np.random.default_rng(20 + shift)
    c, heads, ws, hidden = 32, 2, 8, 64
    x = rng.standard_normal((2, 16, 24, c), dtype=np.float32)
    ops, dense, bias = _bf16_block_weights(rng, c, heads, hidden)
    tops = {k: _t(v) for k, v in ops.items()}
    tops.update({k: v.float() for k, v in dense.items()})
    kw = dict(heads=heads, window_size=ws, shift=shift)
    want_dense = swin_block_plain(_t(x), **tops, **kw)
    packed = dict(tops, wqkv=pack_swin_weights(dense["wqkv"], dense["wproj"], bias, dense["w1"], dense["w2"], heads),
                  wproj=None, bias=None, w1=None, w2=None)
    got = fused_swin_block(_t(x), **packed, **kw)
    assert torch.equal(got, want_dense)
    mask = jnp.asarray(calculate_mask((16, 24), ws, shift)) if shift else None
    j = {k: jnp.asarray(v.numpy()) for k, v in tops.items()}
    want = jax_fused_swin_block(
        jnp.roll(jnp.asarray(x), (-shift, -shift), axis=(1, 2)), j["ln1_w"], j["ln1_b"], j["wqkv"], j["bqkv"],
        j["wproj"], j["bproj"], j["bias"], mask, j["ln2_w"], j["ln2_b"], j["w1"], j["b1"], j["w2"], j["b2"],
        heads=heads, window_size=ws, interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.roll(want, (shift, shift), axis=(1, 2))), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("activation,res_scale", [("lrelu0.2", 1.0), ("relu", 0.1)])
def test_packed_resblock_plain_matches_hwio_and_pallas(activation, res_scale):
    """B14's plain version on packed weights equals it on HWIO bit for bit,
    and the Pallas kernel in interpret mode, res_scale included (weights
    rounded to bf16 for all three)."""
    rng = np.random.default_rng(30)
    c = 20
    x = rng.standard_normal((1, 8, 12, c), dtype=np.float32)
    w1, w2 = (torch.from_numpy(rng.standard_normal((3, 3, c, c), dtype=np.float32) * 0.2).to(torch.bfloat16).float()
              for _ in range(2))
    b1, b2 = (rng.standard_normal(c, dtype=np.float32) * 0.1 for _ in range(2))
    hwio = fused_resblock(_t(x), w1, _t(b1), w2, _t(b2), res_scale, activation)
    got = fused_resblock(_t(x), pack_conv3x3_weights(w1), _t(b1), pack_conv3x3_weights(w2), _t(b2), res_scale,
                         activation)
    assert torch.equal(got, hwio)
    assert torch.equal(resblock_plain(_t(x), pack_conv3x3_weights(w1), _t(b1), w2, _t(b2), res_scale, activation), hwio)
    want = jax_fused_resblock(jnp.asarray(x), jnp.asarray(w1.numpy()), jnp.asarray(b1), jnp.asarray(w2.numpy()),
                              jnp.asarray(b2), res_scale=res_scale, activation=activation, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("c,heads,why", [(240, 8, "C 240"), (96, 2, "head dim 48"), (90, 6, "C 90"), (32, 3, "heads")])
def test_swin_block_bf16_geometry_errors_name_the_geometry(c, heads, why):
    assert why in mma_geometry_error(c, heads)
    for c_ok, heads_ok in ((180, 6), (32, 2), (16, 2), (24, 2), (60, 6), (184, 8)):
        assert mma_geometry_error(c_ok, heads_ok) == ""


class _CountingLibrary(_FakeLibrary):
    """A fake kernel library whose ``swin_block_mma_elements`` and
    ``swin_block_mma_f32_elements`` answer with the packers' element counts,
    as the built libraries do."""

    def swin_block_mma_elements(self, c, heads, hidden):
        self.calls.append(("swin_block_mma_elements", (c, heads, hidden)))
        stages = swin_pack_stages(c, heads, hidden)
        return sum(nrows * ncols + (8192 if kind == "pb" else 0) for kind, _, _, nrows, ncols in stages)

    def swin_block_mma_f32_elements(self, c, heads, hidden):
        self.calls.append(("swin_block_mma_f32_elements", (c, heads, hidden)))
        return 614400 if (c, heads, hidden) == (180, 6, 360) else -1


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "swin_block_mma_bf16"), (torch.float32, "swin_block_mma_f32")])
def test_swin_block_launch_takes_the_entry_of_its_dtype(monkeypatch, dtype, entry):
    """bf16 goes to the kernel written for the H100, f32 (C 180, head dim
    30) to the 3xTF32 kernel written for it (dense weights packed on the
    way, the packed blob as it is); each launch counts under
    ``fused_swin_block`` and under its entry; a geometry the bf16 kernel
    does not take raises before any launch."""
    import studiosr_tpu_torch.ops.cuda.swin_block as module
    from studiosr_tpu_torch.ops.cuda import _build

    lib = _CountingLibrary()
    monkeypatch.setattr(_build, "load", lambda name, signatures, restypes=None: lib)
    monkeypatch.setattr(module, "call", _meta_call)
    engagement.reset()
    c, heads, hidden = 180, 6, 360
    meta = lambda *s, dt=dtype: torch.empty(*s, dtype=dt, device="meta")
    f32 = torch.float32
    ops = dict(ln1_w=meta(c, dt=f32), ln1_b=meta(c, dt=f32), wqkv=meta(c, 3 * c), bqkv=meta(3 * c, dt=f32),
               wproj=meta(c, c), bproj=meta(c, dt=f32), bias=meta(heads, 64, 64, dt=f32), ln2_w=meta(c, dt=f32),
               ln2_b=meta(c, dt=f32), w1=meta(c, hidden), b1=meta(hidden, dt=f32), w2=meta(hidden, c),
               b2=meta(c, dt=f32))
    x = meta(2, 24, 16, c)
    out = fused_swin_block(x, **ops, heads=heads, window_size=8, shift=4)
    assert out.shape == x.shape and out.dtype == dtype and out.device.type == "meta"
    launches = [(name, args) for name, args in lib.calls if not name.endswith("_elements")]
    assert [name for name, _ in launches] == [entry]
    if dtype == torch.bfloat16:
        assert launches[0][1][11:19] == (2, 24, 16, c, heads, hidden, 4, 333440)  # B, H, W, C, heads, hidden, shift, elements
        packed = pack_swin_weights(ops["wqkv"], ops["wproj"], ops["bias"], ops["w1"], ops["w2"], heads)
        fused_swin_block(x, **dict(ops, wqkv=packed, wproj=None, bias=None, w1=None, w2=None), heads=heads,
                         window_size=8)
        assert engagement.entries() == {"fused_swin_block": {entry: 2}}
        with pytest.raises(ValueError, match="None"):
            fused_swin_block(x, **dict(ops, wqkv=packed), heads=heads, window_size=8)
        with pytest.raises(NotImplementedError, match="head dim 60"):
            fused_swin_block(x, **ops, heads=3, window_size=8)
    else:
        assert launches[0][1][11:19] == (2, 24, 16, c, heads, hidden, 4, 614400)  # ..., shift, elements
        packed = pack_swin_f32(ops["wqkv"], ops["wproj"], ops["bias"], ops["w1"], ops["w2"], heads)
        fused_swin_block(x, **dict(ops, wqkv=packed, wproj=None, bias=None, w1=None, w2=None), heads=heads,
                         window_size=8)
        assert engagement.entries() == {"fused_swin_block": {entry: 2}}
    assert engagement.counters() == {"fused_swin_block": len([n for n, _ in lib.calls if n == entry])}


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "resblock_mma_bf16"), (torch.float32, "resblock_mma_f32")])
def test_resblock_launch_takes_the_entry_of_its_dtype(monkeypatch, dtype, entry):
    """bf16 B14 runs both passes on B2's kernel written for the H100, f32 (C
    180 > 16) on B2's 3xTF32 kernel written for it, both on packed weights
    (HWIO packed on the way). The activation, its slope and res_scale reach
    the entry."""
    import studiosr_tpu_torch.ops.cuda.conv3x3 as module

    lib = _fake_launches(monkeypatch, module)
    x = torch.empty(1, 9, 13, 180, dtype=dtype, device="meta")
    w = torch.empty(3, 3, 180, 180, dtype=dtype, device="meta")
    b = torch.empty(180, device="meta")
    out = fused_resblock(x, w, b, w, b, 0.1, "lrelu0.2")
    assert out.shape == x.shape and out.dtype == dtype
    assert [name for name, _ in lib.calls] == [entry]
    assert lib.calls[0][1][7:] == (1, 9, 13, 180, 2, pytest.approx(0.2), pytest.approx(0.1), 0)
    assert engagement.entries() == {"fused_resblock": {entry: 1}}
    if dtype == torch.bfloat16:
        fused_resblock(x, pack_conv3x3_weights(w), b, pack_conv3x3_weights(w), b)
        assert engagement.entries() == {"fused_resblock": {entry: 2}}
    else:
        fused_resblock(x, pack_conv3x3_f32_weights(w), b, pack_conv3x3_f32_weights(w), b)
        assert engagement.entries() == {"fused_resblock": {entry: 2}}
        with pytest.raises(ValueError, match="shape"):  # the bf16 layout's shape, in f32
            fused_resblock(x, pack_conv3x3_weights(w).float(), b, w, b)
