"""B7 and B5's bf16 routes written for the H100 (``csrc/mlp_bwd_mma.cu``,
``csrc/window_attention_mma.cu``), on the CPU: the packed layouts the kernels
stream, checked element by element against their rules and unpacked back to
the identity; the plain versions on packed and on dense weights against the
Pallas kernels in interpret mode; the wrappers' routing by dtype, window,
head dim and width (launches on meta tensors through a fake library); and
the autograd Functions against autograd of the plain versions.

Inputs come from numpy seeds and go to both packages. Tolerances are the JAX
package's: B7's gradients as tests/ops/test_mlp_vjp.py (atol 5e-4, rtol
1e-3), B5's forward as tests/ops/test_fused_swin.py (atol 5e-5, rtol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.ops.pallas.mlp_vjp import mlp_block_dp_vjp as jax_mlp_block_dp_vjp
from studiosr_tpu.ops.pallas.mlp_vjp import mlp_block_vjp as jax_mlp_block_vjp
from studiosr_tpu.ops.pallas.swin_block import fused_window_attention_block as jax_fused_window_attention_block
from studiosr_tpu.ops.windows import calculate_mask
from studiosr_tpu_torch.ops.attn_vjp import attention_map_vjp
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.mlp_block import mlp_block_plain
from studiosr_tpu_torch.ops.cuda.mlp_bwd import _f32_pack_index as mlp_f32_pack_index
from studiosr_tpu_torch.ops.cuda.mlp_bwd import _pack_index as mlp_pack_index
from studiosr_tpu_torch.ops.cuda.mlp_bwd import mlp_bwd, pack_mlp_bwd_weights
from studiosr_tpu_torch.ops.cuda.mlp_bwd import mma_takes as mlp_mma_takes
from studiosr_tpu_torch.ops.cuda.window_attention import (
    _bias_order, _fwd_pack_index, fused_window_attention_block, mma_takes, pack_window_attention,
    unpack_window_attention, window_attention_plain,
)
from studiosr_tpu_torch.ops.mlp_vjp import mlp_block_dp_vjp
from studiosr_tpu_torch.ops.cuda._launch import STREAM

torch.set_num_threads(2)


def _meta_call(device, entry, *args):
    """``_launch.call`` for operands on the meta device, which reach the
    launch path without a card: no card to make current, stream 0."""
    return entry(*(0 if a is STREAM else a for a in args))


# (C, heads): SwinIR's and HAT's 6 heads of 30, MaxSR's 4 of 32, the trained
# fixtures' 2 of 16, and head dims 8, 12 and 24 of the card tests; B7 takes
# each C with hidden 2 C
GEOMETRIES = [(180, 6), (128, 4), (32, 2), (16, 2), (24, 2), (48, 2)]
MLP_NAMES = ["dx", "ds", "db", "dw1", "db1", "dw2", "db2"]
ATOL_B7, RTOL_B7 = 5e-4, 1e-3
ATOL_B5, RTOL_B5 = 5e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _pad16(v):
    return (v + 15) // 16 * 16


def _np_width(c):
    return next(w for w in (16, 32, 48, 64, 96, 128, 184) if c <= w)


def _stage(out, rows, cols, weight):
    """Append the K-major image of a rows x cols stage: core matrices of 8
    columns x 8 K rows, 16 contiguous bytes a column's 8 rows."""
    img = [None] * (rows * cols)
    for n in range(cols):
        for k in range(rows):
            img[(n // 8) * rows * 8 + (k // 8) * 64 + (n % 8) * 8 + k % 8] = weight(k, n)
    out.extend(img)


# -- B5's packed layout -------------------------------------------------------------


def _expected_b5_pack(c: int, heads: int) -> list:
    """The forward's packed weights built element by element from the rule:
    per head, in stages of 96 K rows (of pad16(C)), LN @ Wqkv's q|k|v columns
    (N = 3 pad16(d)); then attn @ Wproj (K = heads pad16(d), each head's
    attention columns padded, N the product width) in stages of 64 K rows.
    Each element names the weight it holds, ("qkv", row, col) or ("proj",
    row, col), or None."""
    d, dp, kc = c // heads, _pad16(c // heads), _pad16(c)
    out = []
    for h in range(heads):
        for k0 in range(0, kc, 96):
            _stage(out, min(96, kc - k0), 3 * dp, lambda k, n: ("qkv", k0 + k, (n // dp) * c + h * d + n % dp)
                   if k0 + k < c and n % dp < d else None)
    hd = heads * dp
    for s0 in range(0, hd, 64):
        def col(k, n, s0=s0):
            hh, j = divmod(s0 + k, dp)
            return ("proj", hh * d + j, n) if j < d and n < c else None
        _stage(out, min(64, hd - s0), _np_width(c), col)
    return out


def _expected_bias_order(heads: int, ws: int) -> list:
    """The bias in the attention pass's fragment order, element by element:
    thread wt (warp wt / 32, lane 4 g + t) of the block of query chunk r
    holds, for key chunk c and 8-column tile nt, its score fragment (q, col),
    (q, col + 1), (q + 8, col), (q + 8, col + 1) with q = 64 r + 16 warp + g
    and col = 64 c + 8 nt + 2 t, over the window's ws^2 tokens padded to
    whole chunks of 64. Each element names (head, query, key), or "-inf" for
    a padding key's column and "0" for a padding query's row at a real key."""
    n = ws * ws
    nch = -(-n // 64)
    out = []
    for h in range(heads):
        for r in range(nch):
            for c in range(nch):
                for nt in range(8):
                    for wt in range(128):
                        q, col = 64 * r + 16 * (wt // 32) + (wt % 32) // 4, 64 * c + 8 * nt + 2 * (wt % 4)
                        out += ["-inf" if k >= n else ("0" if qq >= n else (h, qq, k))
                                for qq, k in ((q, col), (q, col + 1), (q + 8, col), (q + 8, col + 1))]
    return out


@pytest.mark.parametrize("c,heads", GEOMETRIES)
def test_b5_packed_layout_follows_its_rule_element_by_element(c, heads):
    """The weights (at exact small integers, bf16 holds them) and the window-8
    bias order of the serving blob, against the rules built here."""
    wqkv = (torch.arange(3 * c * c, dtype=torch.float32).reshape(c, 3 * c) + 1).remainder(251)  # exact in bf16
    wproj = -(torch.arange(c * c, dtype=torch.float32).reshape(c, c) + 1).remainder(241)
    bias = torch.arange(heads * 64 * 64, dtype=torch.float32).reshape(heads, 64, 64) * 0.5 - 7
    blob = pack_window_attention(wqkv, wproj, bias, heads)
    nw = _fwd_pack_index(c, heads).size
    want = np.array([0.0 if e is None else float((wqkv if e[0] == "qkv" else wproj)[e[1], e[2]])
                     for e in _expected_b5_pack(c, heads)])
    assert nw == want.size and blob.numel() == nw + 2 * heads * 64 * 64
    np.testing.assert_array_equal(blob[:nw].float().numpy(), want)
    got_bias = blob[nw:].view(torch.float32).numpy()
    np.testing.assert_array_equal(got_bias, np.array([float(bias[e]) for e in _expected_bias_order(heads, 8)]))
    assert mma_takes(c, heads)


@pytest.mark.parametrize("c,heads", GEOMETRIES)
def test_b5_unpack_of_pack_is_the_identity(c, heads):
    rng = np.random.default_rng(c + heads)
    for ws in (8, 16):
        n = ws * ws
        wqkv = _t(rng.standard_normal((c, 3 * c)).astype(np.float32)).to(torch.bfloat16)
        wproj = _t(rng.standard_normal((c, c)).astype(np.float32)).to(torch.bfloat16)
        bias = _t(rng.standard_normal((heads, n, n)).astype(np.float32))
        blob = pack_window_attention(wqkv, wproj, bias, heads)
        assert blob.dtype == torch.bfloat16
        a, b, e = unpack_window_attention(blob, c, heads, ws)
        assert torch.equal(a, wqkv) and torch.equal(b, wproj) and torch.equal(e, bias)
    # every weight is in the pack once; the rest is zero padding
    counts = np.bincount(_fwd_pack_index(c, heads), minlength=4 * c * c + 1)
    assert (counts[: 4 * c * c] == 1).all()


@pytest.mark.parametrize("ws", [7, 12])
def test_b5_blob_bias_at_a_padded_window_follows_its_rule(ws):
    """At windows whose ws^2 tokens are not whole 64-token tiles (7: 49 in
    one tile; 12: 144 in three), the serving blob's bias element by element:
    the gathered bias in fragment order, -inf at the padding keys (they take
    no probability) and 0 at the padding queries' real keys; and unpacking
    gives the weights and the bias back."""
    c, heads, n = 32, 2, ws * ws
    wqkv = (torch.arange(3 * c * c, dtype=torch.float32).reshape(c, 3 * c) + 1).remainder(251)
    wproj = -(torch.arange(c * c, dtype=torch.float32).reshape(c, c) + 1).remainder(241)
    bias = torch.arange(heads * n * n, dtype=torch.float32).reshape(heads, n, n) * 0.5 + 3
    blob = pack_window_attention(wqkv, wproj, bias, heads)
    nw, npad = _fwd_pack_index(c, heads).size, -(-n // 64) * 64
    assert blob.numel() == nw + 2 * heads * npad * npad
    want = np.array([float(e) if isinstance(e, str) else float(bias[e]) for e in _expected_bias_order(heads, ws)])
    np.testing.assert_array_equal(blob[nw:].view(torch.float32).numpy(), want)
    order = _bias_order(heads, ws)
    assert np.array_equal(np.sort(order[order < heads * n * n]), np.arange(heads * n * n))
    a, b, e = unpack_window_attention(blob, c, heads, ws)
    assert torch.equal(a.float(), wqkv) and torch.equal(b.float(), wproj) and torch.equal(e, bias)


@pytest.mark.parametrize("ws,heads", [(17, 2), (24, 2), (32, 1), (33, 1)])
def test_b5_large_window_bias_order_follows_its_rule(ws, heads):
    """The streaming family's bias order (NCH 5, 9, 16 and 18 chunks of 64
    tokens) element by element against the rule, each real element once;
    and the serving blob unpacks to the weights and the bias it packed."""
    n = ws * ws
    order = _bias_order(heads, ws)
    code = {"0": heads * n * n, "-inf": heads * n * n + 1}
    want = np.array([code[e] if isinstance(e, str) else (e[0] * n + e[1]) * n + e[2]
                     for e in _expected_bias_order(heads, ws)])
    np.testing.assert_array_equal(order, want)
    assert np.array_equal(np.sort(order[order < heads * n * n]), np.arange(heads * n * n))
    rng = np.random.default_rng(ws)
    c = 16 * heads
    wqkv = _t(rng.standard_normal((c, 3 * c)).astype(np.float32)).to(torch.bfloat16)
    wproj = _t(rng.standard_normal((c, c)).astype(np.float32)).to(torch.bfloat16)
    bias = _t(rng.standard_normal((heads, n, n)).astype(np.float32))
    a, b, e = unpack_window_attention(pack_window_attention(wqkv, wproj, bias, heads), c, heads, ws)
    assert torch.equal(a, wqkv) and torch.equal(b, wproj) and torch.equal(e, bias)


def test_b5_window16_bias_order_follows_its_rule():
    heads = 2
    order = _bias_order(heads, 16)
    want = np.array([(h * 256 + q) * 256 + k for h, q, k in _expected_bias_order(heads, 16)])
    np.testing.assert_array_equal(order, want)
    assert np.array_equal(np.sort(order), np.arange(heads * 256 * 256))


# -- B7's packed layout -------------------------------------------------------------


def _expected_b7_pack(c: int, hidden: int) -> list:
    """B7's packed weights element by element: per chunk of 96 hidden units
    (of pad16(hidden)), in stages of 64 K rows (of pad16(C)), LN @ W1's
    columns of the chunk, then g_b @ W2^T's; then dh1 @ W1^T (K = pad16(hidden),
    N the product width) in stages of 64 K rows. Each element names ("w1",
    row, col), ("w2", row, col) or None."""
    kc, hp = _pad16(c), _pad16(hidden)
    out = []
    for ch in range(-(-hp // 96)):
        for k0 in range(0, kc, 64):
            rows = min(64, kc - k0)
            ok = lambda k, n: k0 + k < c and 96 * ch + n < hidden  # noqa: E731
            _stage(out, rows, 96, lambda k, n: ("w1", k0 + k, 96 * ch + n) if ok(k, n) else None)
            _stage(out, rows, 96, lambda k, n: ("w2", 96 * ch + n, k0 + k) if ok(k, n) else None)
    for s0 in range(0, hp, 64):
        _stage(out, min(64, hp - s0), _np_width(c),
               lambda k, n, s0=s0: ("w1", n, s0 + k) if s0 + k < hidden and n < c else None)
    return out


@pytest.mark.parametrize("c,heads", GEOMETRIES)
def test_b7_packed_layout_follows_its_rule_element_by_element(c, heads):
    hidden = 2 * c
    w1 = torch.arange(c * hidden, dtype=torch.float64).reshape(c, hidden) + 1
    w2 = -torch.arange(hidden * c, dtype=torch.float64).reshape(hidden, c) - 1
    got = pack_mlp_bwd_weights(w1, w2).numpy()
    want = np.array([0.0 if e is None else float((w1 if e[0] == "w1" else w2)[e[1], e[2]])
                     for e in _expected_b7_pack(c, hidden)])
    assert got.shape == want.shape == (mlp_pack_index(c, hidden).size,)
    np.testing.assert_array_equal(got, want)
    assert mlp_mma_takes(c, hidden)


@pytest.mark.parametrize("c,heads", GEOMETRIES)
def test_b7_unpack_of_pack_is_the_identity(c, heads):
    hidden = 2 * c
    rng = np.random.default_rng(c + 7)
    w1 = _t(rng.standard_normal((c, hidden)).astype(np.float32)).to(torch.bfloat16)
    w2 = _t(rng.standard_normal((hidden, c)).astype(np.float32)).to(torch.bfloat16)
    packed = pack_mlp_bwd_weights(w1, w2)
    flat = packed.new_zeros(2 * c * hidden + 1)
    flat[torch.from_numpy(mlp_pack_index(c, hidden))] = packed
    assert torch.equal(flat[: c * hidden].reshape(c, hidden), w1)
    assert torch.equal(flat[c * hidden : 2 * c * hidden].reshape(hidden, c), w2)
    # W1 twice (its columns and W1^T), W2 once; the rest is zero padding
    counts = np.bincount(mlp_pack_index(c, hidden), minlength=2 * c * hidden + 1)
    assert (counts[: c * hidden] == 2).all() and (counts[c * hidden : 2 * c * hidden] == 1).all()


# -- the plain versions against the Pallas kernels -----------------------------------


def _mlp_operands(rng, c, hidden):
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    return dict(ln_w=1.0 + f(c, k=0.1), ln_b=f(c, k=0.1), w1=f(c, hidden, k=0.2), b1=f(hidden, k=0.1),
                w2=f(hidden, c, k=0.2), b2=f(c, k=0.1))


@pytest.mark.parametrize("c,rows_per_sample,dp", [
    (16, 150, None), (16, 150, (0.0, 1.25)), (24, 300, None), (24, 300, (1.25, 0.0)),
])
def test_b7_plain_on_packed_and_dense_weights_matches_pallas(c, rows_per_sample, dp):
    """``mlp_bwd``'s plain version, on the dense weights and on the weights read
    back from the packed layout, against the gradients of ``mlp_block_vjp``
    (no drop-path) / ``mlp_block_dp_vjp`` (per-sample scales), whose
    backward is the Pallas kernel ``_bwd`` in interpret mode: two samples of
    ``rows_per_sample`` rows (not a multiple of its 512-row blocks)."""
    rng = np.random.default_rng(c + rows_per_sample + (dp is not None))
    hidden, rows = 2 * c, 2 * rows_per_sample
    x = rng.standard_normal((rows, c)).astype(np.float32)
    g = rng.standard_normal((rows, c)).astype(np.float32)
    ops = _mlp_operands(rng, c, hidden)
    args = [jnp.asarray(v) for v in (x, *ops.values())]
    if dp is None:
        _, vjp = jax.vjp(jax_mlp_block_vjp, *args)
    else:
        dps = jnp.asarray(dp, jnp.float32)
        _, vjp = jax.vjp(lambda *a: jax_mlp_block_dp_vjp(*a, dps, rows_per_sample), *args)
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    dense = {k: _t(v) for k, v in ops.items()}
    flat = torch.zeros(2 * c * hidden + 1, dtype=torch.float64)
    flat[torch.from_numpy(mlp_pack_index(c, hidden))] = pack_mlp_bwd_weights(dense["w1"].double(),
                                                                            dense["w2"].double())
    w1 = flat[: c * hidden].reshape(c, hidden).float()
    w2 = flat[c * hidden : 2 * c * hidden].reshape(hidden, c).float()
    kw = dict(drop_path=None if dp is None else _t(np.asarray(dp, np.float32)), rows_per_sample=rows_per_sample)
    engagement.reset()
    got = mlp_bwd(_t(x), _t(g), dense["ln_w"], dense["ln_b"], dense["w1"], dense["b1"], dense["w2"], **kw)
    packed = mlp_bwd(_t(x), _t(g), dense["ln_w"], dense["ln_b"], w1, dense["b1"], w2, **kw)
    assert engagement.counters() == {}  # CPU tensors take the plain version
    for name, a, p, e in zip(MLP_NAMES, got, packed, want):
        assert torch.equal(a, p), name
        np.testing.assert_allclose(a.numpy(), e, atol=ATOL_B7, rtol=RTOL_B7, err_msg=name)
    if dp is not None:
        dropped = slice(0, rows_per_sample) if dp[0] == 0 else slice(rows_per_sample, rows)
        np.testing.assert_array_equal(got[0][dropped].numpy(), g[dropped])


def _attn_operands(rng, c, heads, ws):
    n = ws * ws
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    return dict(ln_w=1.0 + f(c, k=0.1), ln_b=f(c, k=0.1), wqkv=f(c, 3 * c, k=c**-0.5), bqkv=f(3 * c, k=0.1),
                wproj=f(c, c, k=c**-0.5), bproj=f(c, k=0.1), bias=f(heads, n, n, k=0.5))


@pytest.mark.parametrize("ws,shift,dp", [
    (8, 0, None), (8, 4, None), (8, 0, (0.0, 1.25)), (8, 4, (1.25, 0.0)), (16, 0, None), (16, 8, None),
] + [(ws, s, dp) for ws in (4, 6, 7, 10, 12, 17, 20, 24, 33) for s in (0, ws // 2) for dp in (None, (0.0, 1.25))])
def test_b5_plain_on_packed_and_dense_weights_matches_pallas(ws, shift, dp):
    """The plain version, on the dense weights and on the serving blob
    (``pack_window_attention``, bf16-exact weights), against
    ``fused_window_attention_block`` in interpret mode (its window-pair
    layout at windows up to 8, one window a program above), at ATOL_B5 and
    RTOL_B5: C 32, 2 heads of 16, two windows by two, batch 2. The shifted
    JAX block is roll(+s) . block . roll(-s) with the mask."""
    rng = np.random.default_rng(90 + ws + shift + (dp is not None))
    b, c, heads = 2, 32, 2
    h = w = 2 * ws
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    ops = _attn_operands(rng, c, heads, ws)
    for k in ("wqkv", "wproj"):  # weights bf16 holds exactly, so the blob is lossless
        ops[k] = _t(ops[k]).to(torch.bfloat16).float().numpy()
    dps = None if dp is None else np.asarray(dp, np.float32)
    mask = jnp.asarray(calculate_mask((h, w), ws, shift)) if shift else None
    jx = jnp.roll(jnp.asarray(x), (-shift, -shift), axis=(1, 2))
    # the JAX kernel folds drop-path in its window-pair layout only; above it
    # the JAX package scales outside the kernel (ops/attn_vjp.py _map_fwd),
    # which is the reference here
    fold = dps is not None and 2 * ws * ws <= 128
    want = jax_fused_window_attention_block(jx, *[jnp.asarray(v) for v in ops.values()], mask, heads=heads,
                                            window_size=ws, drop_path=jnp.asarray(dps) if fold else None,
                                            interpret=True)
    want = np.asarray(jnp.roll(want, (shift, shift), axis=(1, 2)))
    if dps is not None and not fold:
        want = x + dps.reshape(-1, 1, 1, 1) * (want - x)
    dense = {k: _t(v) for k, v in ops.items()}
    blob = pack_window_attention(dense["wqkv"], dense["wproj"], dense["bias"], heads)
    kw = dict(heads=heads, window_size=ws, shift=shift, drop_path=None if dps is None else _t(dps))
    engagement.reset()
    got = fused_window_attention_block(_t(x), **dense, **kw)
    packed = fused_window_attention_block(_t(x), **dict(dense, wqkv=blob, wproj=None, bias=None), **kw)
    assert engagement.counters() == {}  # CPU tensors take the plain version
    assert torch.equal(got, packed)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_B5, rtol=RTOL_B5)
    if dps is not None:
        dropped = int(np.argmin(dps))
        np.testing.assert_array_equal(got[dropped].numpy(), x[dropped])


# -- the wrappers' routing --------------------------------------------------------------


class _FakeLibrary:
    """Stands in for the built kernel libraries: records the C entries a
    wrapper calls and answers the packed layouts' sizes as the built
    libraries do; every launch returns status 0 (and sizes nothing)."""

    def __init__(self):
        self.calls = []

    def window_attention_mma_pack_elems(self, c, heads):
        return _fwd_pack_index(c, heads).size

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


def _launches(lib):
    return [name for name, _ in lib.calls if not name.endswith(("_scratch", "_elems"))]


@pytest.mark.parametrize("dtype,ws,c,heads,packed,entry", [
    (torch.bfloat16, 8, 180, 6, False, "window_attention_mma_bf16"),
    (torch.bfloat16, 16, 180, 6, False, "window_attention16_mma_bf16"),
    (torch.bfloat16, 16, 180, 6, True, "window_attention16_mma_bf16"),  # HAT serving's blob
    (torch.bfloat16, 16, 128, 4, False, "window_attention16_mma_bf16"),
    (torch.bfloat16, 8, 32, 2, True, "window_attention_mma_bf16"),  # the fixtures' geometry
    (torch.bfloat16, 16, 96, 2, False, "window_attention16_bf16"),  # head dim 48: the older kernel, by rule
    (torch.bfloat16, 8, 90, 6, False, "window_attention_bf16"),  # C not a multiple of 4
    (torch.float32, 8, 180, 6, False, "window_attention_f32"),
    (torch.float32, 16, 180, 6, False, "window_attention16_f32"),
    # the other windows, by family: 2-8 count as fused_window_attention_block, 9-16 as _ws16
    (torch.bfloat16, 3, 128, 4, False, "window_attention_mma_bf16"),
    (torch.bfloat16, 7, 128, 4, False, "window_attention_mma_bf16"),  # MaxSR at a 48 x 48 crop
    (torch.bfloat16, 7, 32, 2, True, "window_attention_mma_bf16"),
    (torch.bfloat16, 10, 128, 4, False, "window_attention16_mma_bf16"),  # MaxSR at 96 x 96
    (torch.bfloat16, 12, 180, 6, True, "window_attention16_mma_bf16"),
    (torch.bfloat16, 15, 128, 4, False, "window_attention16_mma_bf16"),
    (torch.bfloat16, 5, 96, 2, False, "window_attention_bf16"),
    (torch.bfloat16, 12, 96, 2, False, "window_attention16_bf16"),
    (torch.float32, 6, 180, 6, False, "window_attention_f32"),
    (torch.float32, 12, 180, 6, False, "window_attention16_f32"),
    # from 17 the streaming family, counted as _large
    (torch.bfloat16, 17, 128, 4, False, "window_attention_large_mma_bf16"),  # MaxSR at a 289 x 289 crop
    (torch.bfloat16, 24, 180, 6, True, "window_attention_large_mma_bf16"),  # SwinIR served at window 24
    (torch.bfloat16, 33, 180, 6, False, "window_attention_large_mma_bf16"),
    (torch.bfloat16, 20, 128, 2, False, "window_attention_large_bf16"),  # head dim 64
    (torch.float32, 24, 180, 6, False, "window_attention_large_f32"),
])
def test_window_attention_routes_by_dtype_window_and_head_dim(monkeypatch, dtype, ws, c, heads, packed, entry):
    """bf16 with a head dim up to 32 and C a multiple of 4 up to 184 goes to
    the kernels written for the H100 (dense weights or the serving blob),
    other bf16 geometries and f32 to the older kernels; windows 2-8 to the
    small family's entries, counted under ``fused_window_attention_block``,
    windows 9-16 to the large family's, under ``_ws16``, windows from 17 to
    the streaming family's, under ``_large``; each launch counts under its
    kernel and its C entry, which is handed the window."""
    import studiosr_tpu_torch.ops.cuda.window_attention as module

    lib = _fake(monkeypatch, module)
    n, f32 = ws * ws, torch.float32
    meta = lambda *s, dt=dtype: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    x = meta(2, 2 * ws, 3 * ws, c)
    weights = dict(wqkv=meta(c, 3 * c), wproj=meta(c, c), bias=meta(heads, n, n, dt=f32))
    if packed:
        npad = -(-n // 64) * 64
        weights = dict(wqkv=meta(_fwd_pack_index(c, heads).size + 2 * heads * npad * npad), wproj=None, bias=None)
    out = fused_window_attention_block(x, meta(c, dt=f32), meta(c, dt=f32), bqkv=meta(3 * c, dt=f32),
                                       bproj=meta(c, dt=f32), **weights, heads=heads, window_size=ws, shift=ws // 2,
                                       drop_path=None if packed else meta(2, dt=f32))
    assert out.shape == x.shape and out.dtype == dtype
    assert _launches(lib) == [entry]
    assert mma_takes(c, heads) == (c % 4 == 0 and c // heads <= 32)
    name = "fused_window_attention_block" + ("_large" if ws > 16 else "_ws16" if ws > 8 else "")
    assert engagement.counters() == {name: 1}
    assert engagement.entries() == {name: {entry: 1}}
    args = dict(lib.calls)[entry]
    assert args[5:8] == (c, heads, ws)  # (x, out, B, H, W, C, heads, ws, shift, ...)
    if "mma" in entry:  # dense weights are gathered by the entry; the blob is handed over as it is
        assert (args[16] is None) == packed and (args[19] is None) == (not packed)
    engagement.reset()


@pytest.mark.parametrize("dtype,c,hidden,entry", [
    (torch.bfloat16, 180, 360, "mlp_bwd_mma_bf16"),
    (torch.bfloat16, 32, 64, "mlp_bwd_mma_bf16"),
    (torch.bfloat16, 128, 384, "mlp_bwd_mma_bf16"),
    (torch.bfloat16, 128, 512, "mlp_bwd_mma_bf16"),  # MaxSR's feed-forward
    (torch.bfloat16, 90, 180, "mlp_bwd_bf16"),  # C not a multiple of 4: the older kernel, by rule
    (torch.bfloat16, 64, 576, "mlp_bwd_bf16"),  # hidden above 512
    (torch.float32, 180, 360, "mlp_bwd_mma_f32"),  # f32: csrc/mlp_bwd_f32.cu
    (torch.float32, 90, 180, "mlp_bwd_f32"),  # f32 with C not a multiple of 4: the older kernel, by rule
])
def test_mlp_bwd_routes_by_dtype_and_width(monkeypatch, dtype, c, hidden, entry):
    """bf16 with C a multiple of 4 up to 184 and hidden up to 512 goes to the
    kernel written for the H100, f32 with C a multiple of 4 up to 256 to the
    f32 one, other widths to the older kernel; each launch counts under
    ``mlp_bwd`` and its C entry."""
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
    assert _launches(lib) == [entry]
    assert (dtype == torch.bfloat16 and mlp_mma_takes(c, hidden)) == (entry == "mlp_bwd_mma_bf16")
    assert engagement.counters() == {"mlp_bwd": 1}
    assert engagement.entries() == {"mlp_bwd": {entry: 1}}
    engagement.reset()


# -- the autograd Functions ---------------------------------------------------------------


@pytest.mark.parametrize("c,rows_per_sample,dp", [(32, 96, (0.0, 1.25)), (24, 80, None)])
def test_mlp_block_dp_vjp_grads_match_autograd_of_plain(c, rows_per_sample, dp):
    """``mlp_block_dp_vjp`` (B6 forward, B7 backward) against autograd of the
    plain forward, with and without drop-path scales."""
    rng = np.random.default_rng(c + 3)
    hidden, rows = 2 * c, 2 * rows_per_sample
    x = _t(rng.standard_normal((rows, c)).astype(np.float32)).requires_grad_()
    g = _t((rng.standard_normal((rows, c)) * 0.1).astype(np.float32))
    ops = {k: _t(v).requires_grad_() for k, v in _mlp_operands(rng, c, hidden).items()}
    dps = None if dp is None else torch.tensor(dp)
    args = (x, *ops.values())
    got = torch.autograd.grad((mlp_block_dp_vjp(*args, dps, rows_per_sample) * g).sum(), args)
    want = torch.autograd.grad(
        (mlp_block_plain(*args, drop_path=dps, rows_per_sample=rows_per_sample) * g).sum(), args)
    for name, a, e in zip(["dx"] + list(ops), got, want):
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("ws,shift", [(8, 4), (16, 0), (6, 3), (10, 5)])
def test_attention_map_vjp_grads_match_autograd_of_plain_at_fixture_width(ws, shift):
    """``attention_map_vjp`` (B5 forward, B8 / B9 backward) against autograd
    of the plain forward at the trained fixtures' width (C 32, 2 heads of
    16), with a 0 drop-path scale."""
    rng = np.random.default_rng(40 + ws)
    b, c, heads = 2, 32, 2
    x = _t(rng.standard_normal((b, 2 * ws, 2 * ws, c)).astype(np.float32)).requires_grad_()
    g = _t((rng.standard_normal((b, 2 * ws, 2 * ws, c)) * 0.1).astype(np.float32))
    ops = {k: _t(v).requires_grad_() for k, v in _attn_operands(rng, c, heads, ws).items()}
    dp = torch.tensor([1.25, 0.0])
    args = (x, *ops.values())
    got = torch.autograd.grad((attention_map_vjp(*args, dp, shift, heads, ws) * g).sum(), args)
    want = torch.autograd.grad(
        (window_attention_plain(*args, heads=heads, window_size=ws, shift=shift, drop_path=dp) * g).sum(), args)
    for name, a, e in zip(["dx"] + list(ops), got, want):
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=1e-4, rtol=1e-4, err_msg=name)
