"""B8 and B7's f32 route written for the H100 (``csrc/attn_bwd_f32.cu``,
``csrc/mlp_bwd_f32.cu`` on ``csrc/tf32x3.cuh``), on the CPU: the packed
weight layouts, built element by element from their rules and unpacked back
to the identity; the wrappers' routing by dtype, window and width (launches
on meta tensors through a fake library); the TF32 rounding the kernels'
3xTF32 products use; and the plain versions with every product in 3xTF32
(``ops/cuda/tf32x3.py``, the kernels' arithmetic) against the same
functions in f64, and against the Pallas kernels in interpret mode.

Inputs come from numpy seeds and go to both packages. Tolerances: against
f64, the f32 kernels' rule on the card (max |k - p| <= 1e-4 max |p| +
1e-5); against the Pallas kernels, the JAX package's tests (B8
tests/ops/test_attn_bwd.py: atol 3e-4, rtol 2e-3; B7
tests/ops/test_mlp_vjp.py: atol 5e-4, rtol 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from studiosr_tpu.ops.pallas.attn_bwd import pairs_attention_bwd
from studiosr_tpu.ops.pallas.mlp_vjp import mlp_block_dp_vjp as jax_mlp_block_dp_vjp
from studiosr_tpu.ops.pallas.mlp_vjp import mlp_block_vjp as jax_mlp_block_vjp
from studiosr_tpu.ops.windows import calculate_mask
from studiosr_tpu_torch.ops.cuda import engagement, tf32x3
from studiosr_tpu_torch.ops.cuda._launch import STREAM
from studiosr_tpu_torch.ops.cuda.attn_bwd import _pack_index as attn_pack_index
from studiosr_tpu_torch.ops.cuda.attn_bwd import (
    _f32_pack_index as attn_f32_pack_index, attention_bwd, attention_bwd_plain, f32_mma_takes as attn_f32_takes,
    pack_attn_bwd_f32_weights,
)
from studiosr_tpu_torch.ops.cuda.mlp_bwd import _pack_index as mlp_pack_index
from studiosr_tpu_torch.ops.cuda.mlp_bwd import (
    _f32_pack_index as mlp_f32_pack_index, f32_mma_takes as mlp_f32_takes, mlp_bwd, mlp_bwd_plain,
    pack_mlp_bwd_f32_weights,
)
from studiosr_tpu_torch.ops.windows import calculate_mask as port_calculate_mask, window_partition, window_reverse

torch.set_num_threads(2)

# (C, heads): SwinIR's, SwinFIR's and HAT's 6 heads of 30, MaxSR's 4 of 32,
# the trained fixtures' 2 of 16, head dims 8, 12 and 24, and one C above 184
ATTN_GEOMETRIES = [(180, 6), (128, 4), (32, 2), (16, 2), (24, 2), (48, 2), (240, 8)]
# (C, hidden): mlp ratio 2, MaxSR's 4, and a hidden width not a multiple of 4
MLP_GEOMETRIES = [(180, 360), (128, 512), (32, 64), (20, 37)]
ATTN_NAMES = ["dx", "ds", "db", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias"]
MLP_NAMES = ["dx", "ds", "db", "dw1", "db1", "dw2", "db2"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _pad16(v):
    return (v + 15) // 16 * 16


def _meta_call(device, entry, *args):
    """``_launch.call`` for operands on the meta device, which reach the
    launch path without a card: no card to make current, stream 0."""
    return entry(*(0 if a is STREAM else a for a in args))


# -- the packed layouts ----------------------------------------------------------------


def _image_order(k_rows: int, n_cols: int, elem) -> list:
    """A K x N product's weights as ``tfw_pack`` lays their hi values out,
    built element by element: N tiles of 96 columns (64 where that pads N
    less), 32-row K stages, each stage block holding element (k, n) at
    (n / 8) 256 + (k / 4) 32 + (n % 8) 4 + k % 4; ``elem(k, n)`` names the
    weight at (k, n) of the product, None past K and N."""
    bn = 96 if -(-n_cols // 96) * 96 <= -(-n_cols // 64) * 64 else 64
    out = []
    for nt in range(-(-n_cols // bn)):
        for ks in range(-(-k_rows // 32)):
            block = [None] * (bn * 32)
            for k in range(32):
                for n in range(bn):
                    kk, nn = 32 * ks + k, bn * nt + n
                    if kk < k_rows and nn < n_cols:
                        block[(n // 8) * 256 + (k // 4) * 32 + (n % 8) * 4 + k % 4] = elem(kk, nn)
            out.extend(block)
    return out


def _expected_attn_pack(c: int, heads: int) -> list:
    """B8 f32's packed weights built element by element from their rule:
    Wqkv as C rows of 3 heads pad16(d) columns (part p, head h, column j:
    wqkv[r, p C + h d + j], zero for j >= d), Wproj^T as C rows of heads
    pad16(d) columns (wproj[h d + j, r]), then the first matrix transposed,
    each in the stage images' order. Each element names the weight it
    holds, ("qkv", row, col) or ("proj", row, col), or None."""
    d = c // heads
    dp = _pad16(d)
    hd = heads * dp

    def qkv(r, col):
        p, rest = divmod(col, hd)
        h, j = divmod(rest, dp)
        return ("qkv", r, p * c + h * d + j) if j < d else None

    def proj(r, col):
        h, j = divmod(col, dp)
        return ("proj", h * d + j, r) if j < d else None

    return (_image_order(c, 3 * hd, qkv) + _image_order(c, hd, proj)
            + _image_order(3 * hd, c, lambda k, n: qkv(n, k)))


def _expected_mlp_pack(c: int, hidden: int) -> list:
    """B7 f32's packed weights built element by element: W1 (C rows of
    hidden padded to 4: w1[r, j]), W2^T (C rows: w2[j, r]) and W1^T (hidden
    padded to 4 rows of C: w1[r, j]), zero at j >= hidden, each in the stage
    images' order."""
    hp = (hidden + 3) // 4 * 4
    w1 = lambda r, j: ("w1", r, j) if j < hidden else None  # noqa: E731
    return (_image_order(c, hp, w1) + _image_order(c, hp, lambda r, j: ("w2", j, r) if j < hidden else None)
            + _image_order(hp, c, lambda j, r: w1(r, j)))


def _hi_lo_planes(packed, gathered, products):
    """Hold the pack's values to its rule: each stage block of BN x 32 of
    the gathered values as tf32(v), then tf32(v - tf32(v))."""
    at = 0
    for k_rows, n_cols in products:
        bnk = (96 if -(-n_cols // 96) * 96 <= -(-n_cols // 64) * 64 else 64) * 32
        count = -(-k_rows // 32) * -(-n_cols // (bnk // 32)) * bnk
        blocks = gathered[at:at + count].reshape(-1, bnk)
        pk = packed[2 * at:2 * (at + count)].reshape(-1, 2, bnk)
        hi = tf32x3.tf32_round(blocks)
        assert torch.equal(pk[:, 0], hi) and torch.equal(pk[:, 1], tf32x3.tf32_round(blocks - hi))
        at += count
    assert 2 * at == packed.numel()


@pytest.mark.parametrize("c,heads", ATTN_GEOMETRIES)
def test_attn_f32_packed_layout_follows_its_rule_element_by_element(c, heads):
    want = [4 * c * c if e is None else (e[1] * 3 * c + e[2] if e[0] == "qkv" else 3 * c * c + e[1] * c + e[2])
            for e in _expected_attn_pack(c, heads)]
    np.testing.assert_array_equal(attn_f32_pack_index(c, heads), np.array(want))
    rng = np.random.default_rng(c + heads)
    wqkv = _t(rng.standard_normal((c, 3 * c)).astype(np.float32))
    wproj = _t(rng.standard_normal((c, c)).astype(np.float32))
    src = torch.cat([wqkv.reshape(-1), wproj.reshape(-1), torch.zeros(1)])
    gathered = src[torch.from_numpy(np.array(want))]
    d = c // heads
    hd = heads * _pad16(d)
    _hi_lo_planes(pack_attn_bwd_f32_weights(wqkv, wproj, heads), gathered, [(c, 3 * hd), (c, hd), (3 * hd, c)])
    assert attn_f32_takes(c, heads, 8)


@pytest.mark.parametrize("c,heads", ATTN_GEOMETRIES)
def test_attn_f32_unpack_of_pack_is_the_identity(c, heads):
    rng = np.random.default_rng(c + heads)
    wqkv = _t(rng.standard_normal((c, 3 * c)).astype(np.float32))
    wproj = _t(rng.standard_normal((c, c)).astype(np.float32))
    index = torch.from_numpy(attn_f32_pack_index(c, heads))
    src = torch.cat([wqkv.reshape(-1), wproj.reshape(-1), torch.zeros(1)])
    flat = torch.zeros(4 * c * c + 1)
    flat[index] = src[index]
    assert torch.equal(flat[: 3 * c * c].reshape(c, 3 * c), wqkv)
    assert torch.equal(flat[3 * c * c : 4 * c * c].reshape(c, c), wproj)
    # the q|k|v columns twice (the projection and the dln product), Wproj once
    counts = np.bincount(attn_f32_pack_index(c, heads), minlength=4 * c * c + 1)
    assert (counts[: 3 * c * c] == 2).all() and (counts[3 * c * c : 4 * c * c] == 1).all()


@pytest.mark.parametrize("c,hidden", MLP_GEOMETRIES)
def test_mlp_f32_packed_layout_follows_its_rule_element_by_element(c, hidden):
    zero = 2 * c * hidden
    want = np.array([zero if e is None else (e[1] * hidden + e[2] if e[0] == "w1" else c * hidden + e[1] * c + e[2])
                     for e in _expected_mlp_pack(c, hidden)])
    np.testing.assert_array_equal(mlp_f32_pack_index(c, hidden), want)
    rng = np.random.default_rng(c + hidden)
    w1 = _t(rng.standard_normal((c, hidden)).astype(np.float32))
    w2 = _t(rng.standard_normal((hidden, c)).astype(np.float32))
    gathered = torch.cat([w1.reshape(-1), w2.reshape(-1), torch.zeros(1)])[torch.from_numpy(want)]
    hp = (hidden + 3) // 4 * 4
    _hi_lo_planes(pack_mlp_bwd_f32_weights(w1, w2), gathered, [(c, hp), (c, hp), (hp, c)])
    assert mlp_f32_takes(c, hidden)


@pytest.mark.parametrize("c,hidden", MLP_GEOMETRIES)
def test_mlp_f32_unpack_of_pack_is_the_identity(c, hidden):
    rng = np.random.default_rng(c + hidden)
    w1 = _t(rng.standard_normal((c, hidden)).astype(np.float32))
    w2 = _t(rng.standard_normal((hidden, c)).astype(np.float32))
    index = torch.from_numpy(mlp_f32_pack_index(c, hidden))
    src = torch.cat([w1.reshape(-1), w2.reshape(-1), torch.zeros(1)])
    flat = torch.zeros(2 * c * hidden + 1)
    flat[index] = src[index]
    assert torch.equal(flat[: c * hidden].reshape(c, hidden), w1)
    assert torch.equal(flat[c * hidden : 2 * c * hidden].reshape(hidden, c), w2)
    counts = np.bincount(mlp_f32_pack_index(c, hidden), minlength=2 * c * hidden + 1)
    assert (counts[: c * hidden] == 2).all() and (counts[c * hidden : 2 * c * hidden] == 1).all()


# -- the routing -----------------------------------------------------------------------


class _FakeLibrary:
    """Stands in for the built kernel libraries: records the C entries a
    wrapper calls and answers the packed layouts' sizes as the built
    libraries do; every launch returns status 0."""

    def __init__(self):
        self.calls = []

    def attn_bwd_mma_f32_pack_elems(self, c, heads):
        return attn_f32_pack_index(c, heads).size

    def attn_bwd_mma_pack_elems(self, c, heads):
        return attn_pack_index(c, heads).size

    def mlp_bwd_mma_pack_elems(self, c, hidden):
        return mlp_pack_index(c, hidden).size

    def mlp_bwd_mma_f32_pack_elems(self, c, hidden):
        return mlp_f32_pack_index(c, hidden).size

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


def _fake(monkeypatch, module):
    from studiosr_tpu_torch.ops.cuda import _build

    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda name, signatures, restypes=None: lib)
    monkeypatch.setattr(module, "call", _meta_call)
    engagement.reset()
    return lib


@pytest.mark.parametrize("dtype,ws,c,heads,entry", [
    (torch.float32, 8, 180, 6, "attn_bwd_mma_f32"),  # SwinFIR's step
    (torch.float32, 8, 128, 4, "attn_bwd_mma_f32"),  # MaxSR's
    (torch.float32, 7, 128, 4, "attn_bwd_mma_f32"),
    (torch.float32, 2, 32, 2, "attn_bwd_mma_f32"),
    (torch.float32, 4, 240, 8, "attn_bwd_mma_f32"),
    (torch.float32, 8, 96, 2, "attn_bwd_f32"),  # head dim 48: the older kernel, by rule
    (torch.float32, 8, 90, 6, "attn_bwd_f32"),  # C not a multiple of 4
    (torch.float32, 8, 264, 6, "attn_bwd_f32"),  # C above 256
    (torch.float32, 12, 180, 6, "attn_bwd16_f32"),  # windows from 9: the older families
    (torch.float32, 17, 128, 4, "attn_bwd_large_f32"),
    (torch.bfloat16, 8, 180, 6, "attn_bwd_mma_bf16"),  # bf16 keeps its route
])
def test_attention_bwd_f32_routes_by_window_and_width(monkeypatch, dtype, ws, c, heads, entry):
    """f32 at windows 2-8 with a head dim up to 32 and C a multiple of 4 up
    to 256 launches ``attn_bwd_mma_f32``, counted under ``attention_bwd``;
    the f32 entry is handed the window and the packed weights' index table,
    and the head-padded weight gradients come back at their parameters'
    shapes."""
    import studiosr_tpu_torch.ops.cuda.attn_bwd as module

    lib = _fake(monkeypatch, module)
    n, f32 = ws * ws, torch.float32
    meta = lambda *s, dt=dtype: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    x = meta(2, 2 * ws, 3 * ws, c)
    grads = attention_bwd(x, meta(2, 2 * ws, 3 * ws, c), meta(c, dt=f32), meta(c, dt=f32), meta(c, 3 * c),
                          meta(3 * c, dt=f32), meta(c, c), meta(c, dt=f32), meta(heads, n, n, dt=f32), heads=heads,
                          window_size=ws, shift=ws // 2, drop_path=meta(2, dt=f32))
    shapes = [x.shape, (c,), (c,), (c, 3 * c), (3 * c,), (c, c), (c,), (heads, n, n)]
    assert [tuple(t.shape) for t in grads] == [tuple(s) for s in shapes]
    assert grads[0].dtype == dtype and all(t.dtype == f32 for t in grads[1:])
    launches = [(name, args) for name, args in lib.calls if not name.endswith(("_scratch", "_elems"))]
    assert [name for name, _ in launches] == [entry]
    assert launches[0][1][6:9] == (c, heads, ws)  # (x, g, dx, B, H, W, C, heads, ws, ...)
    if entry == "attn_bwd_mma_f32":  # (..., shift, ln_w, ln_b, bqkv, bias, dp, wqkv, wproj, index, elems, ...)
        assert launches[0][1][9] == ws // 2 and launches[0][1][18] == attn_f32_pack_index(c, heads).size
        assert len(launches[0][1]) == len(module._SIGNATURES_F32[entry])  # ctypes types every argument
    if dtype == torch.float32:
        assert attn_f32_takes(c, heads, ws) == (entry == "attn_bwd_mma_f32")
    name = "attention_bwd" + ("_large" if ws > 16 else "_ws16" if ws > 8 else "")
    assert engagement.counters() == {name: 1}
    assert engagement.entries() == {name: {entry: 1}}
    engagement.reset()


@pytest.mark.parametrize("dtype,c,hidden,entry", [
    (torch.float32, 180, 360, "mlp_bwd_mma_f32"),  # SwinFIR's step
    (torch.float32, 128, 512, "mlp_bwd_mma_f32"),  # MaxSR's feed-forward
    (torch.float32, 20, 37, "mlp_bwd_mma_f32"),
    (torch.float32, 64, 576, "mlp_bwd_mma_f32"),  # any hidden width
    (torch.float32, 90, 180, "mlp_bwd_f32"),  # C not a multiple of 4: the older kernel, by rule
    (torch.float32, 260, 520, "mlp_bwd_f32"),  # C above 256
    (torch.bfloat16, 180, 360, "mlp_bwd_mma_bf16"),  # bf16 keeps its route
])
def test_mlp_bwd_f32_routes_by_width(monkeypatch, dtype, c, hidden, entry):
    """f32 with C a multiple of 4 up to 256 launches ``mlp_bwd_mma_f32``,
    counted under ``mlp_bwd``, with its packed weights' index table."""
    import studiosr_tpu_torch.ops.cuda.mlp_bwd as module

    lib = _fake(monkeypatch, module)
    f32 = torch.float32
    meta = lambda *s, dt=dtype: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    rows = 2 * 100
    grads = mlp_bwd(meta(rows, c), meta(rows, c), meta(c, dt=f32), meta(c, dt=f32), meta(c, hidden),
                    meta(hidden, dt=f32), meta(hidden, c), drop_path=meta(2, dt=f32), rows_per_sample=100)
    shapes = [(rows, c), (c,), (c,), (c, hidden), (hidden,), (hidden, c), (c,)]
    assert [tuple(t.shape) for t in grads] == shapes
    assert grads[0].dtype == dtype and all(t.dtype == f32 for t in grads[1:])
    launches = [(name, args) for name, args in lib.calls if not name.endswith(("_scratch", "_elems"))]
    assert [name for name, _ in launches] == [entry]
    if entry == "mlp_bwd_mma_f32":  # (x, g, dx, rows, C, hidden, ..., rows_per_sample, index, elems, ...)
        assert launches[0][1][3:6] == (rows, c, hidden) and launches[0][1][14] == mlp_f32_pack_index(c, hidden).size
        assert len(launches[0][1]) == len(module._SIGNATURES_F32[entry])  # ctypes types every argument
    if dtype == torch.float32:
        assert mlp_f32_takes(c, hidden) == (entry == "mlp_bwd_mma_f32")
    assert engagement.counters() == {"mlp_bwd": 1}
    assert engagement.entries() == {"mlp_bwd": {entry: 1}}
    engagement.reset()


# -- 3xTF32 ------------------------------------------------------------------------------


def test_tf32_round_is_round_to_nearest_ties_away():
    """``cvt.rna.tf32.f32``: 10 mantissa bits, half an ulp rounds away from
    zero; hi + lo holds an f32 value to 2^-22 of it."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, -(1 + ulp / 2), 3 * 2.0 ** -20, 0.0,
                      1 + ulp / 2 - 2.0 ** -23], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + ulp, 1.0, 1 + ulp, -(1 + ulp), 3 * 2.0 ** -20, 0.0, 1.0], dtype=torch.float32)
    assert torch.equal(tf32x3.tf32_round(x), want)
    v = _t(np.random.default_rng(0).standard_normal(4096).astype(np.float32)) * 10.0
    hi, lo = tf32x3.split(v)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all() and ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    assert float(((hi.double() + lo.double() - v.double()).abs() / v.double().abs()).max()) <= 2.0 ** -21


def _attn_half64(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, *, heads, ws, shift, dp):
    """y = x + d proj(WA(LN x)) in f64, the reference the gradients are
    taken of: roll, partition, LN, q|k|v, softmax(q k^T / sqrt(d) + bias (+
    the shift's mask)) v, proj, reverse, roll back."""
    b, h, w, c = x.shape
    n, d = ws * ws, c // heads
    z = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
    ln = F.layer_norm(z, (c,), ln_w, ln_b, 1e-5)
    qkv = (window_partition(ln, ws).reshape(-1, n, c) @ wqkv + bqkv).reshape(-1, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    s = (qkv[0] * d**-0.5) @ qkv[1].transpose(-1, -2) + bias
    if shift:
        mask = torch.from_numpy(port_calculate_mask((h, w), ws, shift)).double()
        s = (s.reshape(b, -1, heads, n, n) + mask[None, :, None]).reshape(s.shape)
    o = (torch.softmax(s, -1) @ qkv[2]).transpose(1, 2).reshape(-1, n, c) @ wproj + bproj
    y = window_reverse(o.reshape(-1, ws, ws, c), ws, h, w)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    return x + (y if dp is None else dp.reshape(-1, 1, 1, 1) * y)


def _mlp_half64(x, ln_w, ln_b, w1, b1, w2, b2, *, d):
    """y = x + d fc2(gelu(fc1(LN x))) in f64 (d a scale a row, or None)."""
    y = F.gelu(F.layer_norm(x, (x.shape[-1],), ln_w, ln_b, 1e-5) @ w1 + b1) @ w2 + b2
    return x + (y if d is None else d * y)


def _grads64(fn, tensors, g, **kw):
    leaves = [t.double().requires_grad_() for t in tensors]
    return torch.autograd.grad(fn(*leaves, **kw), leaves, g.double())


def _f32_close(got, want):
    """The f32 kernels' rule on the card: max |k - p| <= 1e-4 max |p| + 1e-5."""
    got, want = got.double(), want.double()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-5


def _attn_operands(rng, c, heads, ws):
    n = ws * ws
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    return dict(ln_w=1.0 + f(c, k=0.1), ln_b=f(c, k=0.1), wqkv=f(c, 3 * c, k=c**-0.5), bqkv=f(3 * c, k=0.1),
                wproj=f(c, c, k=c**-0.5), bproj=f(c, k=0.1), bias=f(heads, n, n, k=0.5))


@pytest.mark.parametrize("ws,shift,dp", [(8, 4, (0.0, 1.25)), (8, 0, None), (4, 2, (1.25, 0.0)), (7, 3, None)])
def test_b8_in_3xtf32_holds_f32_against_f64_and_pallas(ws, shift, dp):
    """The plain version with every product in 3xTF32 (the f32 kernel's
    arithmetic) against the same function in f64 at the f32 rule, and against
    ``pairs_attention_bwd`` in interpret mode at the JAX tests' tolerances:
    batch 2, C 32, 2 heads of 16, two windows by two."""
    rng = np.random.default_rng(90 + ws + shift)
    b, c, heads = 2, 32, 2
    h = w = 2 * ws
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    ops = _attn_operands(rng, c, heads, ws)
    dps = None if dp is None else np.asarray(dp, np.float32)
    kw = dict(heads=heads, window_size=ws, shift=shift, drop_path=None if dps is None else _t(dps))
    got = attention_bwd_plain(_t(x), _t(g), *[_t(v) for v in ops.values()], mm=tf32x3.matmul, **kw)
    exact = _grads64(_attn_half64, [_t(x), *[_t(v) for v in ops.values()]], _t(g), heads=heads, ws=ws, shift=shift,
                     dp=None if dps is None else _t(dps).double())
    for name, a, e in zip(ATTN_NAMES, got, exact):
        assert a.dtype == torch.float32, name
        _f32_close(a, e)
    mask = jnp.asarray(calculate_mask((h, w), ws, shift)) if shift else None
    roll = lambda a: jnp.roll(jnp.asarray(a), (-shift, -shift), axis=(1, 2))  # noqa: E731
    want = pairs_attention_bwd(roll(x), roll(g), *[jnp.asarray(v) for v in ops.values()], mask,
                               None if dps is None else jnp.asarray(dps), heads=heads, window_size=ws, interpret=True)
    want = [np.asarray(jnp.roll(want[0], (shift, shift), axis=(1, 2)))] + [np.asarray(a) for a in want[1:]]
    for name, a, e in zip(ATTN_NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), e, atol=3e-4, rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("c,hidden,rows_per_sample,dp", [(16, 32, 150, (0.0, 1.25)), (24, 48, 300, None),
                                                          (20, 37, 100, (1.25, 0.0))])
def test_b7_in_3xtf32_holds_f32_against_f64_and_pallas(c, hidden, rows_per_sample, dp):
    """The plain version with every product in 3xTF32 against the same
    function in f64 at the f32 rule, and against the gradients of
    ``mlp_block_vjp`` / ``mlp_block_dp_vjp`` (their backward the Pallas
    kernel ``_bwd`` in interpret mode) at the JAX tests' tolerances: two
    samples of ``rows_per_sample`` rows."""
    rng = np.random.default_rng(c + hidden + rows_per_sample)
    rows = 2 * rows_per_sample
    x = rng.standard_normal((rows, c)).astype(np.float32)
    g = rng.standard_normal((rows, c)).astype(np.float32)
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    ops = dict(ln_w=1.0 + f(c, k=0.1), ln_b=f(c, k=0.1), w1=f(c, hidden, k=c**-0.5), b1=f(hidden, k=0.1),
               w2=f(hidden, c, k=hidden**-0.5), b2=f(c, k=0.1))
    dps = None if dp is None else np.asarray(dp, np.float32)
    kw = dict(drop_path=None if dps is None else _t(dps), rows_per_sample=rows_per_sample)
    five = [_t(v) for k, v in ops.items() if k != "b2"]
    got = mlp_bwd_plain(_t(x), _t(g), *five, mm=tf32x3.matmul, **kw)
    d = None if dps is None else _t(dps).double().repeat_interleave(rows_per_sample)[:, None]
    exact = _grads64(_mlp_half64, [_t(x), *[_t(v) for v in ops.values()]], _t(g), d=d)
    for name, a, e in zip(MLP_NAMES, got, exact):
        _f32_close(a, e)
    args = [jnp.asarray(v) for v in (x, *ops.values())]
    if dps is None:
        _, vjp = jax.vjp(jax_mlp_block_vjp, *args)
    else:
        _, vjp = jax.vjp(lambda *a: jax_mlp_block_dp_vjp(*a, jnp.asarray(dps), rows_per_sample), *args)
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    for name, a, e in zip(MLP_NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), e, atol=5e-4, rtol=1e-3, err_msg=name)


def test_f32_wrappers_on_cpu_take_the_plain_version():
    """CPU tensors take the plain version (in f32 products) and count no
    launch, whatever the geometry."""
    rng = np.random.default_rng(7)
    x = _t(rng.standard_normal((2, 8, 8, 32)).astype(np.float32))
    ops = [_t(v) for v in _attn_operands(rng, 32, 2, 8).values()]
    kw = dict(heads=2, window_size=8, shift=4)
    engagement.reset()
    got = attention_bwd(x, x * 0.5, *ops, **kw)
    for a, e in zip(got, attention_bwd_plain(x, x * 0.5, *ops, **kw)):
        assert torch.equal(a, e)
    rows = x.reshape(-1, 32)
    mlp = [ops[0], ops[1], ops[2][:, :64], ops[3][:64], ops[2][:, :64].t().contiguous()]
    for a, e in zip(mlp_bwd(rows, rows * 0.5, *mlp), mlp_bwd_plain(rows, rows * 0.5, *mlp)):
        assert torch.equal(a, e)
    assert engagement.counters() == {}
