"""B8 and B9's bf16 route written for the H100 (``csrc/attn_bwd_mma.cu``), on
the CPU: the packed weight layout the kernels stream, the plain version on
packed and on dense weights against the Pallas kernels in interpret mode,
the wrapper's routing by dtype, window and head dim (launches on meta
tensors through a fake library), and the autograd Function at both windows.

Inputs come from numpy seeds and go to both packages; tolerances are those
of the JAX package's tests/ops/test_attn_bwd.py (atol 3e-4, rtol 2e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.ops.pallas.attn_bwd import pairs_attention_bwd, v5_attention_bwd
from studiosr_tpu.ops.windows import calculate_mask
from studiosr_tpu_torch.ops.attn_vjp import attention_map_vjp
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.attn_bwd import (
    _f32_pack_index, _pack_index, attention_bwd, mma_takes, pack_attn_bwd_weights,
)
from studiosr_tpu_torch.ops.cuda.window_attention import window_attention_plain
from studiosr_tpu_torch.ops.cuda._launch import STREAM

torch.set_num_threads(2)


def _meta_call(device, entry, *args):
    """``_launch.call`` for operands on the meta device, which reach the
    launch path without a card: no card to make current, stream 0."""
    return entry(*(0 if a is STREAM else a for a in args))


GRAD_NAMES = ["dx", "ds", "db", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias"]
# (C, heads): SwinIR's and HAT's 6 heads of 30, MaxSR's 4 of 32, the trained
# fixtures' 2 of 16, and head dims 8, 12 and 24 of the card tests
GEOMETRIES = [(180, 6), (128, 4), (32, 2), (16, 2), (24, 2), (48, 2)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def unpack_attn_bwd_weights(packed: torch.Tensor, c: int, heads: int):
    """(wqkv, wproj) read back from the packed layout (every place of a weight
    holds the same value)."""
    flat = packed.new_zeros(4 * c * c + 1)
    flat[torch.from_numpy(_pack_index(c, heads))] = packed
    return flat[: 3 * c * c].reshape(c, 3 * c), flat[3 * c * c : 4 * c * c].reshape(c, c)


def _expected_pack(c: int, heads: int) -> list:
    """The packed layout built element by element from its rule: per head,
    in stages of 96 K rows (of pad16(C)), LN @ Wqkv's q|k|v columns (N = 3
    pad16(d)) and g_b @ Wproj^T's columns (N = pad16(d)), then dqkv @ Wqkv^T (K the 3
    heads pad16(d) padded dq|dk|dv columns, N the product width) in stages
    of 64 K rows; each stage a K-major image of core matrices of 8 columns x
    8 K rows (16 contiguous bytes a column's 8 rows). Each element names the
    weight it holds, ("qkv", row, col) or ("proj", row, col), or None."""
    d = c // heads
    dp = (d + 15) // 16 * 16
    kc = (c + 15) // 16 * 16
    npw = next(w for w in (16, 32, 48, 64, 96, 128, 184) if c <= w)
    out = []

    def stage(rows, cols, weight):
        img = [None] * (rows * cols)
        for n in range(cols):
            for k in range(rows):
                pos = (n // 8) * rows * 8 + (k // 8) * 64 + (n % 8) * 8 + k % 8
                img[pos] = weight(k, n)
        out.extend(img)

    for h in range(heads):
        for k0 in range(0, kc, 96):
            stage(min(96, kc - k0), 3 * dp, lambda k, n: ("qkv", k0 + k, (n // dp) * c + h * d + n % dp)
                  if k0 + k < c and n % dp < d else None)
            stage(min(96, kc - k0), dp, lambda k, n: ("proj", h * d + n, k0 + k) if k0 + k < c and n < d else None)
    k3 = 3 * heads * dp
    for s0 in range(0, k3, 64):
        def col(k, n, s0=s0):
            p, rest = divmod(s0 + k, heads * dp)
            hh, j = divmod(rest, dp)
            return ("qkv", n, p * c + hh * d + j) if j < d and n < c else None
        stage(min(64, k3 - s0), npw, col)
    return out


@pytest.mark.parametrize("c,heads", GEOMETRIES)
def test_packed_layout_follows_its_rule_element_by_element(c, heads):
    wqkv = torch.arange(3 * c * c, dtype=torch.float64).reshape(c, 3 * c) + 1
    wproj = -torch.arange(c * c, dtype=torch.float64).reshape(c, c) - 1
    got = pack_attn_bwd_weights(wqkv, wproj, heads).numpy()
    want = np.array([0.0 if e is None else float((wqkv if e[0] == "qkv" else wproj)[e[1], e[2]])
                     for e in _expected_pack(c, heads)])
    assert got.shape == want.shape == (_pack_index(c, heads).size,)
    np.testing.assert_array_equal(got, want)
    assert mma_takes(c, heads)


@pytest.mark.parametrize("c,heads", GEOMETRIES)
def test_unpack_of_pack_is_the_identity(c, heads):
    rng = np.random.default_rng(c + heads)
    wqkv = _t(rng.standard_normal((c, 3 * c)).astype(np.float32)).to(torch.bfloat16)
    wproj = _t(rng.standard_normal((c, c)).astype(np.float32)).to(torch.bfloat16)
    packed = pack_attn_bwd_weights(wqkv, wproj, heads)
    assert packed.dtype == torch.bfloat16
    a, b = unpack_attn_bwd_weights(packed, c, heads)
    assert torch.equal(a, wqkv) and torch.equal(b, wproj)
    # every weight is in the pack, the q|k|v columns twice (the projection
    # and the dln stages), Wproj once; the rest is zero padding
    counts = np.bincount(_pack_index(c, heads), minlength=4 * c * c + 1)
    assert (counts[: 3 * c * c] == 2).all() and (counts[3 * c * c : 4 * c * c] == 1).all()


def _operands(rng, c, heads, ws):
    n = ws * ws
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    return dict(ln_w=1.0 + f(c, k=0.1), ln_b=f(c, k=0.1), wqkv=f(c, 3 * c, k=0.3), bqkv=f(3 * c, k=0.1),
                wproj=f(c, c, k=0.3), bproj=f(c, k=0.1), bias=f(heads, n, n, k=0.05))


# windows 8 and 16, then the others the kernels take by padding to whole
# 64-token tiles: 4, 6 and 7 (pairs_attention_bwd, 2 ws^2 <= 128), 10 and 12
# (v5_attention_bwd), and 17, 20, 24 and 33 (v5_attention_bwd; the streaming
# family in the port); each with and without the shift ws // 2 and drop-path
PLAIN_CASES = [
    (8, 0, None), (8, 4, None), (8, 0, (0.0, 1.25)), (8, 4, (0.0, 1.25)),
    (16, 0, None), (16, 8, None), (16, 0, (0.0, 1.25)), (16, 8, (0.0, 1.25)),
] + [(ws, s, dp) for ws in (4, 6, 7, 10, 12, 17, 20, 24, 33) for s in (0, ws // 2) for dp in (None, (1.25, 0.0))]


@pytest.mark.parametrize("ws,shift,dp", PLAIN_CASES)
def test_plain_on_packed_and_dense_weights_matches_pallas(ws, shift, dp):
    """The plain version, on the dense weights and on the weights read back
    from the packed layout, against ``pairs_attention_bwd`` (windows up to 8)
    / ``v5_attention_bwd`` (the larger ones) in interpret mode, at atol 3e-4,
    rtol 2e-3: b 2, C 16, 2 heads of 8, two windows by two."""
    rng = np.random.default_rng(70 + ws + shift + (dp is not None))
    b, c, heads = 2, 16, 2
    h = w = 2 * ws
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    ops = _operands(rng, c, heads, ws)
    dps = None if dp is None else np.asarray(dp, np.float32)
    mask = jnp.asarray(calculate_mask((h, w), ws, shift)) if shift else None
    roll = lambda a: jnp.roll(jnp.asarray(a), (-shift, -shift), axis=(1, 2))  # noqa: E731
    pallas = pairs_attention_bwd if 2 * ws * ws <= 128 else v5_attention_bwd
    want = pallas(roll(x), roll(g), *[jnp.asarray(v) for v in ops.values()], mask,
                  None if dps is None else jnp.asarray(dps), heads=heads, window_size=ws, interpret=True)
    want = [np.asarray(jnp.roll(want[0], (shift, shift), axis=(1, 2)))] + [np.asarray(a) for a in want[1:]]
    dense = {k: _t(v) for k, v in ops.items()}
    wqkv, wproj = unpack_attn_bwd_weights(pack_attn_bwd_weights(dense["wqkv"], dense["wproj"], heads), c, heads)
    kw = dict(heads=heads, window_size=ws, shift=shift, drop_path=None if dps is None else _t(dps))
    engagement.reset()
    got = attention_bwd(_t(x), _t(g), **dense, **kw)
    packed = attention_bwd(_t(x), _t(g), **dict(dense, wqkv=wqkv, wproj=wproj), **kw)
    assert engagement.counters() == {}  # CPU tensors take the plain version
    for name, a, p, e in zip(GRAD_NAMES, got, packed, want):
        assert torch.equal(a, p), name
        np.testing.assert_allclose(a.numpy(), e, atol=3e-4, rtol=2e-3, err_msg=name)
    if dps is not None:
        dropped = int(np.argmin(dps))
        np.testing.assert_array_equal(got[0][dropped].numpy(), g[dropped])


class _FakeLibrary:
    """Stands in for the built kernel libraries: records the C entries a
    wrapper calls and answers the packed layout's size as the built library
    does; every launch returns status 0."""

    def __init__(self):
        self.calls = []

    def attn_bwd_mma_pack_elems(self, c, heads):
        return _pack_index(c, heads).size

    def attn_bwd_mma_f32_pack_elems(self, c, heads):
        return _f32_pack_index(c, heads).size

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.mark.parametrize("dtype,ws,c,heads,entry", [
    (torch.bfloat16, 8, 180, 6, "attn_bwd_mma_bf16"),
    (torch.bfloat16, 16, 180, 6, "attn_bwd16_mma_bf16"),
    (torch.bfloat16, 16, 128, 4, "attn_bwd16_mma_bf16"),
    (torch.bfloat16, 8, 32, 2, "attn_bwd_mma_bf16"),
    (torch.bfloat16, 16, 96, 2, "attn_bwd16_bf16"),  # head dim 48: the older bf16 kernel, by rule
    (torch.bfloat16, 8, 90, 6, "attn_bwd_bf16"),  # C not a multiple of 4
    (torch.float32, 8, 180, 6, "attn_bwd_mma_f32"),  # f32 at windows 2-8: csrc/attn_bwd_f32.cu
    (torch.float32, 16, 180, 6, "attn_bwd16_mma_f32"),  # and at 9-16, its second family
    # the other windows, by family: 2-8 count as attention_bwd, 9-16 as _ws16
    (torch.bfloat16, 2, 128, 4, "attn_bwd_mma_bf16"),
    (torch.bfloat16, 4, 128, 4, "attn_bwd_mma_bf16"),
    (torch.bfloat16, 7, 128, 4, "attn_bwd_mma_bf16"),  # MaxSR at a 48 x 48 crop
    (torch.bfloat16, 9, 128, 4, "attn_bwd16_mma_bf16"),
    (torch.bfloat16, 10, 128, 4, "attn_bwd16_mma_bf16"),  # MaxSR at 96 x 96
    (torch.bfloat16, 12, 180, 6, "attn_bwd16_mma_bf16"),
    (torch.bfloat16, 6, 96, 2, "attn_bwd_bf16"),
    (torch.bfloat16, 12, 96, 2, "attn_bwd16_bf16"),
    (torch.float32, 6, 180, 6, "attn_bwd_mma_f32"),
    (torch.float32, 6, 96, 2, "attn_bwd_f32"),  # f32 at head dim 48: the older kernel, by rule
    (torch.float32, 12, 180, 6, "attn_bwd16_mma_f32"),
    (torch.float32, 12, 96, 2, "attn_bwd16_f32"),  # f32 at head dim 48 from 9: the older kernel, by rule
    # from 17 the streaming family, counted as _large
    (torch.bfloat16, 17, 128, 4, "attn_bwd_large_mma_bf16"),  # MaxSR at a 289 x 289 crop
    (torch.bfloat16, 24, 180, 6, "attn_bwd_large_mma_bf16"),
    (torch.bfloat16, 33, 128, 4, "attn_bwd_large_mma_bf16"),
    (torch.bfloat16, 20, 128, 2, "attn_bwd_large_bf16"),  # head dim 64
    (torch.float32, 17, 128, 4, "attn_bwd_large_f32"),
])
def test_attention_bwd_routes_by_dtype_window_and_head_dim(monkeypatch, dtype, ws, c, heads, entry):
    """bf16 with a head dim up to 32 and C a multiple of 4 up to 184 goes to
    the kernels written for the H100, and f32 at windows 2-16 with a head dim
    up to 32 to the f32 one; other geometries to the older kernels;
    windows 2-8 to the small family's entries, counted under
    ``attention_bwd``, windows 9-16 to the large family's, counted under
    ``attention_bwd_ws16``, windows from 17 to the streaming family's,
    counted under ``attention_bwd_large``; each launch counts under its kernel and its C
    entry, which is handed the window, and the padded weight gradients come
    back at their parameters' shapes."""
    import studiosr_tpu_torch.ops.cuda.attn_bwd as module
    from studiosr_tpu_torch.ops.cuda import _build

    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda name, signatures, restypes=None: lib)
    monkeypatch.setattr(module, "call", _meta_call)
    engagement.reset()
    n, f32 = ws * ws, torch.float32
    meta = lambda *s, dt=dtype: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    x = meta(2, 2 * ws, 3 * ws, c)
    grads = attention_bwd(x, meta(2, 2 * ws, 3 * ws, c), meta(c, dt=f32), meta(c, dt=f32), meta(c, 3 * c),
                          meta(3 * c, dt=f32), meta(c, c), meta(c, dt=f32), meta(heads, n, n, dt=f32), heads=heads,
                          window_size=ws, shift=ws // 2, drop_path=meta(2, dt=f32))
    shapes = [x.shape, (c,), (c,), (c, 3 * c), (3 * c,), (c, c), (c,), (heads, n, n)]
    assert [tuple(t.shape) for t in grads] == [tuple(s) for s in shapes]
    assert grads[0].dtype == dtype and all(t.dtype == f32 for t in grads[1:])
    launches = [(name, args) for name, args in lib.calls if not name.endswith("_scratch")]
    assert [name for name, _ in launches] == [entry]
    assert launches[0][1][6:9] == (c, heads, ws)  # (x, g, dx, B, H, W, C, heads, ws, ...)
    assert mma_takes(c, heads) == (c % 4 == 0 and c // heads <= 32)
    name = "attention_bwd" + ("_large" if ws > 16 else "_ws16" if ws > 8 else "")
    assert engagement.counters() == {name: 1}
    assert engagement.entries() == {name: {entry: 1}}
    engagement.reset()


@pytest.mark.parametrize("ws,shift", [(8, 4), (16, 8), (5, 2), (7, 3), (12, 6)])
def test_attention_map_vjp_grads_match_autograd_of_plain_at_maxsr_head_dim(ws, shift):
    """``attention_map_vjp`` (B5 forward, B8 / B9 backward) against autograd
    of the plain forward at MaxSR's head dim 32 (C 64, 2 heads, zero qkv
    bias), with the shift mask and a 0 drop-path scale."""
    rng = np.random.default_rng(80 + ws)
    b, c, heads = 2, 64, 2
    x = _t(rng.standard_normal((b, 2 * ws, 3 * ws, c)).astype(np.float32)).requires_grad_()
    g = _t((rng.standard_normal((b, 2 * ws, 3 * ws, c)) * 0.1).astype(np.float32))
    ops = _operands(rng, c, heads, ws)
    ops["bqkv"] = np.zeros_like(ops["bqkv"])
    ops = {k: _t(v).requires_grad_() for k, v in ops.items()}
    dp = torch.tensor([0.0, 1.25])
    args = (x, *ops.values())
    got = torch.autograd.grad((attention_map_vjp(*args, dp, shift, heads, ws) * g).sum(), args)
    want = torch.autograd.grad(
        (window_attention_plain(*args, heads=heads, window_size=ws, shift=shift, drop_path=dp) * g).sum(), args)
    for name, a, e in zip(["dx"] + list(ops), got, want):
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=1e-4, rtol=1e-4, err_msg=name)
