"""B5 and B6's f32 route written for the H100 (``csrc/window_attention_f32.cu``,
``csrc/mlp_block_f32.cu`` on ``csrc/tf32x3.cuh``), on the CPU: the packed
weight layouts, built element by element from their rules and unpacked back
to the identity; the wrappers' routing by dtype, window and width (launches
on meta tensors through a fake library); and the plain versions with every
product in 3xTF32 (``ops/cuda/tf32x3.py``, the kernels' arithmetic) against
the same functions in f64, and against the Pallas kernels in interpret mode.

Inputs come from numpy seeds and go to both packages. Tolerances: against
f64, the f32 kernels' rule on the card (max |k - p| <= 1e-4 max |p| +
1e-5); against the Pallas kernels, the JAX package's tests of the forwards
(tests/ops/test_fused_swin.py: atol 5e-5, rtol 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from studiosr_tpu.ops.pallas.swin_block import fused_mlp_block as jax_fused_mlp_block
from studiosr_tpu.ops.pallas.swin_block import fused_window_attention_block as jax_fused_window_attention_block
from studiosr_tpu.ops.windows import calculate_mask
from studiosr_tpu_torch.ops import attention
from studiosr_tpu_torch.ops.cuda import engagement, tf32x3
from studiosr_tpu_torch.ops.cuda._launch import STREAM
from studiosr_tpu_torch.ops.cuda.mlp_block import (
    _f32_pack_index as mlp_f32_pack_index, _mma_pack_index, f32_mma_takes as mlp_f32_takes, fused_mlp_block,
    mlp_block_plain, pack_mlp_block_f32_weights,
)
from studiosr_tpu_torch.ops.cuda.window_attention import (
    _f32_fwd_pack_index as attn_f32_pack_index, _fwd_pack_index, f32_mma_takes as attn_f32_takes,
    fused_window_attention_block, pack_window_attention_f32_weights, window_attention_plain,
)
from studiosr_tpu_torch.ops.windows import calculate_mask as port_calculate_mask, window_partition, window_reverse

torch.set_num_threads(2)

# (C, heads): SwinIR's, SwinFIR's and HAT's 6 heads of 30, MaxSR's 4 of 32,
# the trained fixtures' 2 of 16, head dims 8, 12 and 24, and one C above 184
ATTN_GEOMETRIES = [(180, 6), (128, 4), (32, 2), (16, 2), (24, 2), (48, 2), (240, 8)]
# (C, hidden): mlp ratio 2, MaxSR's 4, a hidden width not a multiple of 4,
# and C 256 at the widest hidden the kernel takes
MLP_GEOMETRIES = [(180, 360), (128, 512), (32, 64), (20, 37), (256, 512)]
ATOL, RTOL = 5e-5, 1e-4  # the forwards, as tests/ops/test_fused_swin.py


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
    """B5 f32's packed weights built element by element from their rule:
    Wqkv as C rows of 3 heads pad16(d) columns (part p, head h, column j:
    wqkv[r, p C + h d + j], zero for j >= d), then Wproj as heads pad16(d)
    rows of C columns (row h pad16(d) + j: wproj[h d + j, n], zero for j >=
    d), each in the stage images' order. Each element names the weight it
    holds, ("qkv", row, col) or ("proj", row, col), or None."""
    d = c // heads
    dp = _pad16(d)
    hd = heads * dp

    def qkv(r, col):
        p, rest = divmod(col, hd)
        h, j = divmod(rest, dp)
        return ("qkv", r, p * c + h * d + j) if j < d else None

    def proj(row, n):
        h, j = divmod(row, dp)
        return ("proj", h * d + j, n) if j < d else None

    return _image_order(c, 3 * hd, qkv) + _image_order(hd, c, proj)


def _expected_mlp_pack(c: int, hidden: int) -> list:
    """B6 f32's packed weights built element by element: W1 (C rows of
    hidden padded to 4: w1[r, j]) and W2 (hidden padded to 4 rows of C:
    w2[j, n]), zero at j >= hidden, each in the stage images' order."""
    hp = (hidden + 3) // 4 * 4
    return (_image_order(c, hp, lambda r, j: ("w1", r, j) if j < hidden else None)
            + _image_order(hp, c, lambda j, n: ("w2", j, n) if j < hidden else None))


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
def test_b5_f32_packed_layout_follows_its_rule_element_by_element(c, heads):
    want = [4 * c * c if e is None else (e[1] * 3 * c + e[2] if e[0] == "qkv" else 3 * c * c + e[1] * c + e[2])
            for e in _expected_attn_pack(c, heads)]
    np.testing.assert_array_equal(attn_f32_pack_index(c, heads), np.array(want))
    rng = np.random.default_rng(c + heads)
    wqkv = _t(rng.standard_normal((c, 3 * c)).astype(np.float32))
    wproj = _t(rng.standard_normal((c, c)).astype(np.float32))
    gathered = torch.cat([wqkv.reshape(-1), wproj.reshape(-1), torch.zeros(1)])[torch.from_numpy(np.array(want))]
    hd = heads * _pad16(c // heads)
    _hi_lo_planes(pack_window_attention_f32_weights(wqkv, wproj, heads), gathered, [(c, 3 * hd), (hd, c)])
    assert attn_f32_takes(c, heads, 8)


@pytest.mark.parametrize("c,heads", ATTN_GEOMETRIES)
def test_b5_f32_unpack_of_pack_is_the_identity(c, heads):
    rng = np.random.default_rng(c + heads)
    wqkv = _t(rng.standard_normal((c, 3 * c)).astype(np.float32))
    wproj = _t(rng.standard_normal((c, c)).astype(np.float32))
    index = torch.from_numpy(attn_f32_pack_index(c, heads))
    src = torch.cat([wqkv.reshape(-1), wproj.reshape(-1), torch.zeros(1)])
    flat = torch.zeros(4 * c * c + 1)
    flat[index] = src[index]
    assert torch.equal(flat[: 3 * c * c].reshape(c, 3 * c), wqkv)
    assert torch.equal(flat[3 * c * c : 4 * c * c].reshape(c, c), wproj)
    # every weight once; hi + lo of the packed images holds it to 2^-21 of itself
    counts = np.bincount(attn_f32_pack_index(c, heads), minlength=4 * c * c + 1)
    assert (counts[: 4 * c * c] == 1).all()
    hd = heads * _pad16(c // heads)
    hi, lo = _planes(pack_window_attention_f32_weights(wqkv, wproj, heads), [(c, 3 * hd), (hd, c)])
    values = src[index]
    assert float(((hi.double() + lo.double() - values.double()).abs() - 2.0**-21 * values.double().abs()).max()) <= 0


def _planes(packed, products):
    """(hi, lo) of a pack, each in the gathered values' order."""
    his, los, at = [], [], 0
    for k_rows, n_cols in products:
        bnk = (96 if -(-n_cols // 96) * 96 <= -(-n_cols // 64) * 64 else 64) * 32
        count = -(-k_rows // 32) * -(-n_cols // (bnk // 32)) * bnk
        pk = packed[2 * at:2 * (at + count)].reshape(-1, 2, bnk)
        his.append(pk[:, 0].reshape(-1))
        los.append(pk[:, 1].reshape(-1))
        at += count
    return torch.cat(his), torch.cat(los)


@pytest.mark.parametrize("c,hidden", MLP_GEOMETRIES)
def test_b6_f32_packed_layout_follows_its_rule_element_by_element(c, hidden):
    zero = 2 * c * hidden
    want = np.array([zero if e is None else (e[1] * hidden + e[2] if e[0] == "w1" else c * hidden + e[1] * c + e[2])
                     for e in _expected_mlp_pack(c, hidden)])
    np.testing.assert_array_equal(mlp_f32_pack_index(c, hidden), want)
    rng = np.random.default_rng(c + hidden)
    w1 = _t(rng.standard_normal((c, hidden)).astype(np.float32))
    w2 = _t(rng.standard_normal((hidden, c)).astype(np.float32))
    gathered = torch.cat([w1.reshape(-1), w2.reshape(-1), torch.zeros(1)])[torch.from_numpy(want)]
    hp = (hidden + 3) // 4 * 4
    _hi_lo_planes(pack_mlp_block_f32_weights(w1, w2), gathered, [(c, hp), (hp, c)])
    assert mlp_f32_takes(c, hidden)


@pytest.mark.parametrize("c,hidden", MLP_GEOMETRIES)
def test_b6_f32_unpack_of_pack_is_the_identity(c, hidden):
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
    assert (counts[: 2 * c * hidden] == 1).all()
    hp = (hidden + 3) // 4 * 4
    hi, lo = _planes(pack_mlp_block_f32_weights(w1, w2), [(c, hp), (hp, c)])
    values = src[index]
    assert float(((hi.double() + lo.double() - values.double()).abs() - 2.0**-21 * values.double().abs()).max()) <= 0


# -- the routing -----------------------------------------------------------------------


class _FakeLibrary:
    """Stands in for the built kernel libraries: records the C entries a
    wrapper calls and answers the packed layouts' sizes as the built
    libraries do; every launch returns status 0."""

    def __init__(self):
        self.calls = []

    def window_attention_mma_f32_pack_elems(self, c, heads):
        return attn_f32_pack_index(c, heads).size

    def window_attention_mma_pack_elems(self, c, heads):
        return _fwd_pack_index(c, heads).size

    def mlp_block_mma_f32_pack_elems(self, c, hidden):
        return mlp_f32_pack_index(c, hidden).size

    def mlp_block_mma_pack_elems(self, c, hidden):
        return _mma_pack_index(c, hidden).size

    def mlp_block_mma_f32_scratch(self, rows, c, hidden, extra):
        return 1

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


def _launches(lib):
    return [(name, args) for name, args in lib.calls if not name.endswith(("_scratch", "_elems"))]


@pytest.mark.parametrize("dtype,ws,c,heads,entry", [
    (torch.float32, 8, 180, 6, "window_attention_mma_f32"),  # SwinFIR's step
    (torch.float32, 8, 128, 4, "window_attention_mma_f32"),  # MaxSR's
    (torch.float32, 7, 128, 4, "window_attention_mma_f32"),
    (torch.float32, 2, 32, 2, "window_attention_mma_f32"),
    (torch.float32, 4, 240, 8, "window_attention_mma_f32"),
    (torch.float32, 8, 96, 2, "window_attention_f32"),  # head dim 48: the older kernel, by rule
    (torch.float32, 8, 90, 6, "window_attention_f32"),  # C not a multiple of 4
    (torch.float32, 8, 288, 9, "window_attention_f32"),  # C above 256
    (torch.float32, 16, 180, 6, "window_attention16_mma_f32"),  # windows 9-16: the second family
    (torch.float32, 17, 128, 4, "window_attention_large_f32"),  # from 17: the older family
    (torch.bfloat16, 8, 180, 6, "window_attention_mma_bf16"),  # bf16 keeps its route
])
def test_window_attention_f32_routes_by_window_and_width(monkeypatch, dtype, ws, c, heads, entry):
    """f32 at windows 2-8 with a head dim up to 32 and C a multiple of 4 up
    to 256 launches ``window_attention_mma_f32``, counted under
    ``fused_window_attention_block`` (9-16: ``window_attention16_mma_f32``,
    under ``fused_window_attention_block_ws16``); the f32 entry is handed the window,
    the shift and the packed weights' index table."""
    import studiosr_tpu_torch.ops.cuda.window_attention as module

    lib = _fake(monkeypatch, module)
    n, f32 = ws * ws, torch.float32
    meta = lambda *s, dt=dtype: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    x = meta(2, 2 * ws, 3 * ws, c)
    out = fused_window_attention_block(x, meta(c, dt=f32), meta(c, dt=f32), meta(c, 3 * c), meta(3 * c, dt=f32),
                                       meta(c, c), meta(c, dt=f32), meta(heads, n, n, dt=f32), heads=heads,
                                       window_size=ws, shift=ws // 2, drop_path=meta(2, dt=f32))
    assert out.shape == x.shape and out.dtype == dtype
    launches = _launches(lib)
    assert [name for name, _ in launches] == [entry]
    assert launches[0][1][5:8] == (c, heads, ws)  # (x, out, B, H, W, C, heads, ws, ...)
    if entry.endswith("_mma_f32"):  # (..., shift, ln_w, ln_b, bqkv, bproj, bias, dp, wqkv, wproj, index, elems)
        assert launches[0][1][8] == ws // 2 and launches[0][1][18] == attn_f32_pack_index(c, heads).size
        assert len(launches[0][1]) == len(module._SIGNATURES_F32[entry])  # ctypes types every argument
    if dtype == torch.float32:
        assert attn_f32_takes(c, heads, ws) == entry.endswith("_mma_f32")
    name = "fused_window_attention_block" + ("_large" if ws > 16 else "_ws16" if ws > 8 else "")
    assert engagement.counters() == {name: 1}
    assert engagement.entries() == {name: {entry: 1}}
    engagement.reset()


@pytest.mark.parametrize("dtype,c,hidden,mode,entry", [
    (torch.float32, 180, 360, "drop_path", "mlp_block_mma_f32"),  # SwinFIR's step
    (torch.float32, 128, 512, None, "mlp_block_mma_f32"),  # MaxSR's feed-forward
    (torch.float32, 20, 37, "drop_path", "mlp_block_mma_f32"),
    (torch.float32, 180, 360, "extra", "mlp_block_extra_mma_f32"),  # HAT's CAB join
    (torch.float32, 90, 180, None, "mlp_block_f32"),  # C not a multiple of 4: the older kernel, by rule
    (torch.float32, 260, 520, "drop_path", "mlp_block_f32"),  # C above 256
    (torch.float32, 64, 576, "extra", "mlp_block_extra_f32"),  # hidden above 512
    (torch.bfloat16, 180, 360, "drop_path", "mlp_block_mma_bf16"),  # bf16 keeps its route
])
def test_mlp_block_f32_routes_by_width(monkeypatch, dtype, c, hidden, mode, entry):
    """f32 with C a multiple of 4 up to 256 and a hidden width up to 512
    launches ``mlp_block_mma_f32`` (with the CAB join
    ``mlp_block_extra_mma_f32``), counted under ``fused_mlp_block``
    (``_extra``), with its packed weights' index table and scratch."""
    import studiosr_tpu_torch.ops.cuda.mlp_block as module

    lib = _fake(monkeypatch, module)
    f32 = torch.float32
    meta = lambda *s, dt=dtype: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    rows = 2 * 100
    kw = {}
    if mode == "drop_path":
        kw = dict(drop_path=meta(2, dt=f32), rows_per_sample=100)
    elif mode == "extra":
        kw = dict(extra=meta(rows, c), extra_scale=meta(c, dt=f32))
    out = fused_mlp_block(meta(rows, c), meta(c, dt=f32), meta(c, dt=f32), meta(c, hidden), meta(hidden, dt=f32),
                          meta(hidden, c), meta(c, dt=f32), **kw)
    assert out.shape == (rows, c) and out.dtype == dtype
    launches = _launches(lib)
    assert [name for name, _ in launches] == [entry]
    assert launches[0][1][2:5] == (rows, c, hidden)  # (x, out, rows, C, hidden, ...)
    if entry.endswith("mma_f32"):  # (..., index, elems, scratch, f_elems, stream)
        assert launches[0][1][-5:-3] == (0, mlp_f32_pack_index(c, hidden).size)
        assert launches[0][1][-2] == 1  # the scratch the entry sized
        assert len(launches[0][1]) == len(module._SIGNATURES_F32[entry])  # ctypes types every argument
    if dtype == torch.float32:
        assert mlp_f32_takes(c, hidden) == entry.endswith("mma_f32")
    name = "fused_mlp_block_extra" if mode == "extra" else "fused_mlp_block"
    assert engagement.counters() == {name: 1}
    assert engagement.entries() == {name: {entry: 1}}
    engagement.reset()


def test_f32_geometries_neither_route_takes_raise(monkeypatch):
    """What neither the f32 kernels written for the H100 nor the older ones
    take raises before any launch: a window past the largest, a dtype
    other than f32 and bf16, and the bf16 serving blob handed over in f32."""
    import studiosr_tpu_torch.ops.cuda.mlp_block as mlp_module
    import studiosr_tpu_torch.ops.cuda.window_attention as attn_module

    lib = _fake(monkeypatch, attn_module)
    monkeypatch.setattr(mlp_module, "call", _meta_call)
    meta = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    c, heads = 32, 2
    ops = (meta(c), meta(c), meta(c, 3 * c), meta(3 * c), meta(c, c), meta(c))
    with pytest.raises(NotImplementedError, match="window sizes"):
        fused_window_attention_block(meta(1, 257, 257, c), *ops, meta(heads, 257**2, 257**2), heads=heads,
                                     window_size=257)
    with pytest.raises(TypeError, match="dtype"):
        fused_window_attention_block(meta(1, 16, 16, c, dt=torch.float16), *ops, meta(heads, 64, 64), heads=heads,
                                     window_size=8)
    with pytest.raises(ValueError, match="packed weights"):
        fused_window_attention_block(meta(1, 16, 16, c), ops[0], ops[1], meta(100), ops[3], None, ops[5], None,
                                     heads=heads, window_size=8)
    mlp = (meta(c), meta(c), meta(c, 64), meta(64), meta(64, c), meta(c))
    with pytest.raises(TypeError, match="dtype"):
        fused_mlp_block(meta(64, c, dt=torch.float16), *mlp)
    with pytest.raises(ValueError, match="packed weights"):
        fused_mlp_block(meta(64, c), mlp[0], mlp[1], meta(_mma_pack_index(c, 64).size), mlp[3], None, mlp[5])
    assert _launches(lib) == [] and engagement.counters() == {}


# -- the plain versions in 3xTF32 --------------------------------------------------------


def _attn_half64(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, *, heads, ws, shift, dp):
    """y = x + d proj(WA(LN x)) in f64: roll, partition, LN, q|k|v,
    softmax(q k^T / sqrt(d) + bias (+ the shift's mask)) v, proj, reverse,
    roll back."""
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


def _mlp_half64(x, ln_w, ln_b, w1, b1, w2, b2, *, d, extra=None, escale=None):
    """y = x' + d fc2(gelu(fc1(LN x'))) in f64, x' = x (+ extra escale)."""
    if extra is not None:
        x = x + extra * escale
    y = F.gelu(F.layer_norm(x, (x.shape[-1],), ln_w, ln_b, 1e-5) @ w1 + b1) @ w2 + b2
    return x + (y if d is None else d * y)


def _f32_close(got, want):
    """The f32 kernels' rule on the card: max |k - p| <= 1e-4 max |p| + 1e-5."""
    got, want = got.double(), want.double()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-5


@pytest.mark.parametrize("ws,shift,dp", [(8, 4, (0.0, 1.25)), (8, 0, None), (4, 2, (1.25, 0.0)), (7, 3, None),
                                         (7, 0, (1.25, 0.0))])
def test_b5_in_3xtf32_holds_f32_against_f64_and_pallas(ws, shift, dp):
    """The plain version with every product in 3xTF32 (the f32 kernel's
    arithmetic) against the same function in f64 at the f32 rule, and
    against ``fused_window_attention_block`` in interpret mode at the JAX
    tests' tolerances: batch 2, C 32, 2 heads of 16, two windows by two (a
    dropped sample passes through exactly)."""
    rng = np.random.default_rng(110 + ws + shift)
    b, c, heads, n = 2, 32, 2, ws * ws
    h = w = 2 * ws
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    ops = dict(ln_w=1.0 + f(c, k=0.1), ln_b=f(c, k=0.1), wqkv=f(c, 3 * c, k=c**-0.5), bqkv=f(3 * c, k=0.1),
               wproj=f(c, c, k=c**-0.5), bproj=f(c, k=0.1), bias=f(heads, n, n, k=0.5))
    dps = None if dp is None else np.asarray(dp, np.float32)
    kw = dict(heads=heads, window_size=ws, shift=shift, drop_path=None if dps is None else _t(dps))
    got = window_attention_plain(_t(x), *[_t(v) for v in ops.values()], mm=tf32x3.matmul, **kw)
    assert got.dtype == torch.float32
    exact = _attn_half64(_t(x).double(), *[_t(v).double() for v in ops.values()], heads=heads, ws=ws, shift=shift,
                         dp=None if dps is None else _t(dps).double())
    _f32_close(got, exact)
    mask = jnp.asarray(calculate_mask((h, w), ws, shift)) if shift else None
    jx = jnp.roll(jnp.asarray(x), (-shift, -shift), axis=(1, 2))
    want = jax_fused_window_attention_block(jx, *[jnp.asarray(v) for v in ops.values()], mask, heads=heads,
                                            window_size=ws, drop_path=None if dps is None else jnp.asarray(dps),
                                            interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.roll(want, (shift, shift), axis=(1, 2))), atol=ATOL,
                               rtol=RTOL)
    if dps is not None:
        dropped = int(np.argmin(dps))
        assert torch.equal(got[dropped], _t(x)[dropped])


@pytest.mark.parametrize("c,hidden,rows_per_sample,mode", [(16, 32, 150, "drop_path"), (24, 48, 300, None),
                                                            (20, 37, 100, "drop_path"), (24, 48, 128, "extra")])
def test_b6_in_3xtf32_holds_f32_against_f64_and_pallas(c, hidden, rows_per_sample, mode):
    """The plain version with every product in 3xTF32 against the same
    function in f64 at the f32 rule, and against ``fused_mlp_block`` in
    interpret mode at the JAX tests' tolerances: two samples of
    ``rows_per_sample`` rows, with drop-path scales (0, 1.25), without, and
    with HAT's CAB join (``extra``)."""
    rng = np.random.default_rng(c + hidden + rows_per_sample)
    rows = 2 * rows_per_sample
    x = rng.standard_normal((rows, c)).astype(np.float32)
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    ops = dict(ln_w=1.0 + f(c, k=0.1), ln_b=f(c, k=0.1), w1=f(c, hidden, k=c**-0.5), b1=f(hidden, k=0.1),
               w2=f(hidden, c, k=hidden**-0.5), b2=f(c, k=0.1))
    dps = np.asarray((0.0, 1.25), np.float32) if mode == "drop_path" else None
    extra = f(rows, c) if mode == "extra" else None
    escale = f(c, k=0.5) if mode == "extra" else None
    kw = dict(drop_path=None if dps is None else _t(dps), rows_per_sample=rows_per_sample)
    if extra is not None:
        kw = dict(extra=_t(extra), extra_scale=_t(escale))
    got = mlp_block_plain(_t(x), *[_t(v) for v in ops.values()], mm=tf32x3.matmul, **kw)
    d = None if dps is None else _t(dps).double().repeat_interleave(rows_per_sample)[:, None]
    exact = _mlp_half64(_t(x).double(), *[_t(v).double() for v in ops.values()], d=d,
                        extra=None if extra is None else _t(extra).double(),
                        escale=None if escale is None else _t(escale).double())
    _f32_close(got, exact)
    jkw = {}
    if dps is not None:
        jkw = dict(drop_path=jnp.asarray(dps), rows_per_sample=rows_per_sample)
    elif extra is not None:
        jkw = dict(extra=jnp.asarray(extra), extra_scale=jnp.asarray(escale))
    want = np.asarray(jax_fused_mlp_block(jnp.asarray(x), *[jnp.asarray(v) for v in ops.values()], block_rows=64,
                                          interpret=True, **jkw))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    if dps is not None:
        assert torch.equal(got[:rows_per_sample], _t(x)[:rows_per_sample])  # sample 0's scale is 0


def test_plain_versions_take_their_products_through_mm():
    """The ``mm=`` keyword of ``attention_core``, ``window_attention_plain``
    and ``mlp_block_plain`` (default ``torch.matmul``, the same bits as
    naming it) takes every product of the plain versions: counted, and with
    ``tf32x3.matmul`` away from the f32 products by 3xTF32's error only; a
    product other than the default always takes the plain core, even under
    the "pallas" backend."""
    rng = np.random.default_rng(5)
    c, heads, ws = 16, 2, 4
    x = _t(rng.standard_normal((1, 8, 8, c)).astype(np.float32))
    ops = [_t((rng.standard_normal(s) * k).astype(np.float32)) for s, k in
           (((c,), 0.1), ((c,), 0.1), ((c, 3 * c), 0.25), ((3 * c,), 0.1), ((c, c), 0.25), ((c,), 0.1),
            ((heads, 16, 16), 0.5))]
    ops[0] = ops[0] + 1
    kw = dict(heads=heads, window_size=ws, shift=2)
    calls = []

    def counted(a, b):
        calls.append(1)
        return torch.matmul(a, b)

    base = window_attention_plain(x, *ops, **kw)
    assert torch.equal(base, window_attention_plain(x, *ops, mm=torch.matmul, **kw))
    assert torch.equal(base, window_attention_plain(x, *ops, mm=counted, **kw)) and len(calls) == 4
    attention.set_attention_backend("pallas")
    try:
        engagement.reset()
        assert torch.equal(window_attention_plain(x, *ops, mm=tf32x3.matmul, **kw),
                           window_attention_plain(x, *ops, mm=tf32x3.matmul, **kw))
        assert engagement.declines() == {} and engagement.counters() == {}
    finally:
        attention.set_attention_backend("xla")
    assert float((window_attention_plain(x, *ops, mm=tf32x3.matmul, **kw) - base).abs().max()) < 1e-5
    rows = x.reshape(-1, c)
    mlp = [ops[0], ops[1], ops[2][:, :32], ops[3][:32], ops[2][:, :32].t().contiguous(), ops[5]]
    calls.clear()
    plain = mlp_block_plain(rows, *mlp)
    assert torch.equal(plain, mlp_block_plain(rows, *mlp, mm=counted)) and len(calls) == 2
    assert float((mlp_block_plain(rows, *mlp, mm=tf32x3.matmul) - plain).abs().max()) < 1e-5


def test_f32_forward_wrappers_on_cpu_take_the_plain_version():
    """CPU tensors take the plain version (in f32 products) and count no
    launch, whatever the geometry."""
    rng = np.random.default_rng(8)
    c, heads = 32, 2
    x = _t(rng.standard_normal((2, 8, 8, c)).astype(np.float32))
    ops = [_t((rng.standard_normal(s) * 0.2).astype(np.float32)) for s in
           ((c,), (c,), (c, 3 * c), (3 * c,), (c, c), (c,), (heads, 64, 64))]
    kw = dict(heads=heads, window_size=8, shift=4)
    engagement.reset()
    assert torch.equal(fused_window_attention_block(x, *ops, **kw), window_attention_plain(x, *ops, **kw))
    rows = x.reshape(-1, c)
    mlp = [ops[0], ops[1], ops[2][:, :64], ops[3][:64], ops[2][:, :64].t().contiguous(), ops[5]]
    assert torch.equal(fused_mlp_block(rows, *mlp), mlp_block_plain(rows, *mlp))
    assert engagement.counters() == {}
