"""B5 and B9 in f32 at windows 9-16 on the kernels written for the H100
(``csrc/window_attention_f32.cu`` ``window_attention16_mma_f32``,
``csrc/attn_bwd_f32.cu`` ``attn_bwd16_mma_f32``, their attention pass in
``csrc/tf_window16.cuh``), on the CPU: the wrappers' routing by dtype,
window and width (launches on meta tensors through a fake library); the
plain versions with every product in 3xTF32 (``ops/cuda/tf32x3.py``, the
kernels' arithmetic) against the same functions in f64 and against the
Pallas kernels in interpret mode, at windows 9 (two tiles, 47 padding
tokens), 12 and 16; and a plain mirror of the attention passes' partition
(``_f32_ws16_partition``) and their fixed-order sums.

Inputs come from numpy seeds and go to both packages. Tolerances: against
f64, the f32 kernels' rule on the card (max |k - p| <= 1e-4 max |p| +
1e-5); against the Pallas kernels, the JAX package's tests (B5
tests/ops/test_fused_swin.py: atol 5e-5, rtol 1e-4; B9
tests/ops/test_attn_bwd.py: atol 3e-4, rtol 2e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from studiosr_tpu.ops.pallas.attn_bwd import v5_attention_bwd
from studiosr_tpu.ops.pallas.swin_block import fused_window_attention_block as jax_fused_window_attention_block
from studiosr_tpu.ops.windows import calculate_mask
from studiosr_tpu_torch.ops.cuda import attn_bwd as bwd_module
from studiosr_tpu_torch.ops.cuda import engagement, tf32x3
from studiosr_tpu_torch.ops.cuda import window_attention as fwd_module
from studiosr_tpu_torch.ops.cuda._launch import STREAM
from studiosr_tpu_torch.ops.cuda.attn_bwd import (
    _f32_pack_index as bwd_pack_index, attention_bwd, attention_bwd_plain,
)
from studiosr_tpu_torch.ops.cuda.window_attention import (
    _f32_fwd_pack_index as fwd_pack_index, f32_mma_takes, fused_window_attention_block, window_attention_plain,
)
from studiosr_tpu_torch.ops.windows import calculate_mask as port_calculate_mask, window_partition, window_reverse

torch.set_num_threads(2)

NAMES = ["dx", "ds", "db", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias"]
FWD_ATOL, FWD_RTOL = 5e-5, 1e-4
BWD_ATOL, BWD_RTOL = 3e-4, 2e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _meta_call(device, entry, *args):
    """``_launch.call`` for operands on the meta device, which reach the
    launch path without a card: no card to make current, stream 0."""
    return entry(*(0 if a is STREAM else a for a in args))


class _FakeLibrary:
    """Stands in for the built kernel libraries: records the C entries a
    wrapper calls and answers the packed layouts' sizes as the built
    libraries do; every launch returns status 0."""

    def __init__(self):
        self.calls = []

    def window_attention_mma_pack_elems(self, c, heads):
        return fwd_module._fwd_pack_index(c, heads).size

    def attn_bwd_mma_pack_elems(self, c, heads):
        return bwd_module._pack_index(c, heads).size

    def window_attention_mma_f32_pack_elems(self, c, heads):
        return fwd_pack_index(c, heads).size

    def attn_bwd_mma_f32_pack_elems(self, c, heads):
        return bwd_pack_index(c, heads).size

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


# -- the routing -----------------------------------------------------------------------

# (dtype, window, C, heads, stem): f32 at windows 9, 12 and 16 with head dims
# up to 32 (HAT's 6 of 30, MaxSR's 4 of 32, 2 of 16) takes the 3xTF32
# entries "16_mma_f32"; head dim 64, C not a multiple of 4 and C above 256
# keep the first design "16_f32" (up to C 416, F32_FIRST_MAX_C); window 17
# the streaming family "_large_f32"; bf16 keeps its routes. The C11
# geometries (C 264 and 256 above the 3xTF32 kernels' C or head dim) have
# had the first design since its passes were restaged.
ROUTES = [
    (torch.float32, 9, 32, 2, "16_mma_f32"),
    (torch.float32, 10, 128, 4, "16_mma_f32"),
    (torch.float32, 12, 180, 6, "16_mma_f32"),
    (torch.float32, 16, 180, 6, "16_mma_f32"),
    (torch.float32, 16, 128, 2, "16_f32"),  # head dim 64
    (torch.float32, 12, 192, 3, "16_f32"),  # head dim 64
    (torch.float32, 12, 90, 6, "16_f32"),  # C not a multiple of 4
    (torch.float32, 17, 128, 4, "_large_f32"),
    (torch.bfloat16, 16, 180, 6, "16_mma_bf16"),
    (torch.float32, 12, 264, 6, "16_f32"),  # C11: C above 256
    (torch.float32, 12, 264, 12, "16_f32"),
    (torch.float32, 16, 256, 4, "16_f32"),  # C11: head dim 64 at C 256
    (torch.float32, 9, 224, 4, "16_f32"),
    (torch.float32, 17, 224, 4, "_large_f32"),
    (torch.float32, 12, 416, 8, "16_f32"),  # the first design's widest f32 C
]


@pytest.mark.parametrize("dtype,ws,c,heads,stem", ROUTES)
def test_b5_ws16_routes_by_dtype_window_and_width(monkeypatch, dtype, ws, c, heads, stem):
    """B5's launch at windows 9-16 goes to ``window_attention{stem}``, counted
    under ``fused_window_attention_block_ws16`` (``_large`` from 17); the f32
    entry written for the H100 is handed the window, the shift and the
    packed weights' index table, every argument typed by ctypes."""
    lib = _fake(monkeypatch, fwd_module)
    n, f32 = ws * ws, torch.float32
    meta = lambda *s, dt=dtype: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    x = meta(2, 2 * ws, 3 * ws, c)
    out = fused_window_attention_block(x, meta(c, dt=f32), meta(c, dt=f32), meta(c, 3 * c), meta(3 * c, dt=f32),
                                       meta(c, c), meta(c, dt=f32), meta(heads, n, n, dt=f32), heads=heads,
                                       window_size=ws, shift=ws // 2, drop_path=meta(2, dt=f32))
    assert out.shape == x.shape and out.dtype == dtype
    entry = "window_attention" + stem
    launches = _launches(lib)
    assert [name for name, _ in launches] == [entry]
    assert launches[0][1][5:9] == (c, heads, ws, ws // 2)  # (x, out, B, H, W, C, heads, ws, shift, ...)
    if entry == "window_attention16_mma_f32":
        assert launches[0][1][18] == fwd_pack_index(c, heads).size
        assert len(launches[0][1]) == len(fwd_module._SIGNATURES_F32[entry])
    if dtype == f32:
        assert f32_mma_takes(c, heads, ws) == (entry == "window_attention16_mma_f32")
    name = "fused_window_attention_block" + ("_large" if ws > 16 else "_ws16")
    assert engagement.counters() == {name: 1} and engagement.entries() == {name: {entry: 1}}
    engagement.reset()


@pytest.mark.parametrize("dtype,ws,c,heads,stem", ROUTES)
def test_b9_ws16_routes_by_dtype_window_and_width(monkeypatch, dtype, ws, c, heads, stem):
    """B9's launch at windows 9-16 goes to ``attn_bwd{stem}``, counted under
    ``attention_bwd_ws16`` (``_large`` from 17); the f32 entry written for
    the H100 is handed the window, the shift and the packed weights' index
    table, and the head-padded weight gradients come back at their
    parameters' shapes."""
    lib = _fake(monkeypatch, bwd_module)
    n, f32 = ws * ws, torch.float32
    meta = lambda *s, dt=dtype: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    x = meta(2, 2 * ws, 3 * ws, c)
    grads = attention_bwd(x, meta(2, 2 * ws, 3 * ws, c), meta(c, dt=f32), meta(c, dt=f32), meta(c, 3 * c),
                          meta(3 * c, dt=f32), meta(c, c), meta(c, dt=f32), meta(heads, n, n, dt=f32), heads=heads,
                          window_size=ws, shift=ws // 2, drop_path=meta(2, dt=f32))
    shapes = [x.shape, (c,), (c,), (c, 3 * c), (3 * c,), (c, c), (c,), (heads, n, n)]
    assert [tuple(t.shape) for t in grads] == [tuple(s) for s in shapes]
    entry = "attn_bwd" + stem
    launches = _launches(lib)
    assert [name for name, _ in launches] == [entry]
    assert launches[0][1][6:10] == (c, heads, ws, ws // 2)  # (x, g, dx, B, H, W, C, heads, ws, shift, ...)
    if entry == "attn_bwd16_mma_f32":
        assert launches[0][1][18] == bwd_pack_index(c, heads).size
        assert len(launches[0][1]) == len(bwd_module._SIGNATURES_F32[entry])
    name = "attention_bwd" + ("_large" if ws > 16 else "_ws16")
    assert engagement.counters() == {name: 1} and engagement.entries() == {name: {entry: 1}}
    engagement.reset()


# f32 geometries no kernel takes from window 9: the 3xTF32 kernels decline
# them (head dim above 32, C above 256, window above 16) and the first
# design's passes need more than the card's 227 KB of shared memory above C
# 416 (F32_FIRST_MAX_C, computed by window_attention.first_design_max_c from
# the layout functions; the attention pass at head dim 64 bounds it).
DECLINED = [(12, 448, 8), (12, 420, 7), (16, 512, 8), (9, 480, 8), (17, 448, 8)]


@pytest.mark.parametrize("ws,c,heads", DECLINED)
def test_f32_geometries_no_kernel_takes_raise_before_any_launch(monkeypatch, ws, c, heads):
    """B5 and B9 raise NotImplementedError on such a CUDA-bound f32 map
    (here on meta tensors) before they call any C entry or count a launch;
    C 416 at the same window and heads still launches its kernel."""
    assert fwd_module.F32_FIRST_MAX_C == fwd_module.first_design_max_c(torch.float32) == 416
    assert not f32_mma_takes(c, heads, ws) and c > fwd_module.F32_FIRST_MAX_C
    n, f32 = ws * ws, torch.float32
    for module in (fwd_module, bwd_module):
        lib = _fake(monkeypatch, module)

        def run(width):
            meta = lambda *s: torch.empty(*s, dtype=f32, device="meta")  # noqa: E731
            ops = (meta(width), meta(width), meta(width, 3 * width), meta(3 * width), meta(width, width),
                   meta(width), meta(heads, n, n))
            x, kw = meta(2, 2 * ws, 3 * ws, width), dict(heads=heads, window_size=ws, shift=ws // 2)
            if module is fwd_module:
                return fused_window_attention_block(x, *ops, **kw)
            return attention_bwd(x, meta(*x.shape), *ops, **kw)

        with pytest.raises(NotImplementedError, match=f"C up to {fwd_module.F32_FIRST_MAX_C}"):
            run(c)
        assert lib.calls == [] and engagement.counters() == {}
        width = fwd_module.F32_FIRST_MAX_C
        if width % heads == 0 and width // heads <= 64:
            run(width)
            stem = "16_mma_f32" if f32_mma_takes(width, heads, ws) else "_large_f32" if ws > 16 else "16_f32"
            assert [name for name, _ in _launches(lib)] == [
                ("window_attention" if module is fwd_module else "attn_bwd") + stem]
        engagement.reset()


# -- 3xTF32 against f64 and the Pallas kernels ------------------------------------------


def _operands(rng, c, heads, ws, wscale=None):
    n = ws * ws
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    k = c**-0.5 if wscale is None else wscale
    return dict(ln_w=1.0 + f(c, k=0.1), ln_b=f(c, k=0.1), wqkv=f(c, 3 * c, k=k), bqkv=f(3 * c, k=0.1),
                wproj=f(c, c, k=k), bproj=f(c, k=0.1), bias=f(heads, n, n, k=0.5))


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


def _f32_close(got, want, name=""):
    """The f32 kernels' rule on the card: max |k - p| <= 1e-4 max |p| + 1e-5."""
    got, want = got.double(), want.double()
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()) + 1e-5, f"{name}: {err}"


# (window, shift): two tiles with 47 padding tokens (9), three tiles (12), four (16), each
# unshifted and shifted by half a window
F64_CASES = [(9, 0), (9, 4), (12, 0), (12, 6), (16, 0), (16, 8)]


@pytest.mark.parametrize("ws,shift", F64_CASES)
def test_b5_b9_ws16_in_3xtf32_hold_f32_against_f64(ws, shift):
    """The plain B5 and B9 with every product in 3xTF32 (the f32 kernels'
    arithmetic) against the same functions in f64 (B9: autograd of B5's f64
    form) at the f32 rule: batch 2 (a 0 drop-path scale and 1.25), C 32, 2
    heads of 16, two windows by two. The dropped sample passes through
    exactly: y = x, dx = g."""
    rng = np.random.default_rng(300 + ws + shift)
    b, c, heads = 2, 32, 2
    h = w = 2 * ws
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    ops = _operands(rng, c, heads, ws)
    dps = np.asarray([0.0, 1.25], np.float32)
    kw = dict(heads=heads, window_size=ws, shift=shift, drop_path=_t(dps))
    y = window_attention_plain(_t(x), *[_t(v) for v in ops.values()], mm=tf32x3.matmul, **kw)
    grads = attention_bwd_plain(_t(x), _t(g), *[_t(v) for v in ops.values()], mm=tf32x3.matmul, **kw)
    leaves = [_t(x).double().requires_grad_(), *[_t(v).double().requires_grad_() for v in ops.values()]]
    y64 = _attn_half64(*leaves, heads=heads, ws=ws, shift=shift, dp=_t(dps).double())
    exact = torch.autograd.grad(y64, leaves, _t(g).double())
    assert y.dtype == torch.float32
    _f32_close(y, y64.detach(), "y")
    for name, a, e in zip(NAMES, grads, exact):
        assert a.dtype == torch.float32, name
        _f32_close(a, e, name)
    assert torch.equal(y[0], _t(x)[0]) and torch.equal(grads[0][0], _t(g)[0])


# (window, shift): the JAX tests' geometry (C 12, 2 heads of 6) on maps of two
# windows by two
PALLAS_CASES = [(9, 0), (9, 4), (12, 6), (16, 0), (16, 8)]


@pytest.mark.parametrize("ws,shift", PALLAS_CASES)
def test_b5_b9_ws16_in_3xtf32_match_pallas(ws, shift):
    """The plain B5 and B9 in 3xTF32 against ``fused_window_attention_block``
    and ``v5_attention_bwd`` in interpret mode at the JAX tests' tolerances
    (batch 2, C 12, 2 heads, as tests/test_torch_hat_train.py): B5 without a
    drop-path scale (the JAX per-head kernel takes none at these windows),
    B9 with one. The shifted JAX blocks are roll(+s) . f(roll(-s), mask)."""
    rng = np.random.default_rng(400 + ws + shift)
    b, c, heads = 2, 12, 2
    h = w = 2 * ws
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    ops = _operands(rng, c, heads, ws, wscale=0.1)
    dps = np.asarray([0.0, 1.25], np.float32)
    mask = jnp.asarray(calculate_mask((h, w), ws, shift)) if shift else None
    roll = lambda a: jnp.roll(jnp.asarray(a), (-shift, -shift), axis=(1, 2))  # noqa: E731
    unroll = lambda a: np.asarray(jnp.roll(a, (shift, shift), axis=(1, 2)))  # noqa: E731
    y = window_attention_plain(_t(x), *[_t(v) for v in ops.values()], heads=heads, window_size=ws, shift=shift,
                               mm=tf32x3.matmul)
    want = jax_fused_window_attention_block(roll(x), *[jnp.asarray(v) for v in ops.values()], mask, heads=heads,
                                            window_size=ws, interpret=True)
    np.testing.assert_allclose(y.numpy(), unroll(want), atol=FWD_ATOL, rtol=FWD_RTOL)
    grads = attention_bwd_plain(_t(x), _t(g), *[_t(v) for v in ops.values()], heads=heads, window_size=ws,
                                shift=shift, drop_path=_t(dps), mm=tf32x3.matmul)
    want = v5_attention_bwd(roll(x), roll(g), *[jnp.asarray(v) for v in ops.values()], mask, jnp.asarray(dps),
                            heads=heads, window_size=ws, interpret=True)
    assert want is not None
    want = [unroll(want[0])] + [np.asarray(a) for a in want[1:]]
    for name, a, e in zip(NAMES, grads, want):
        np.testing.assert_allclose(a.numpy(), e, atol=BWD_ATOL, rtol=BWD_RTOL, err_msg=name)


# -- the attention passes' partition and their sums --------------------------------------


def _core(q, k, v, add, g):
    """The attention core's forward and gradients in f32 on (windows, heads,
    N, d): attn, the rows' statistics' products, dq, dk, dv and d bias."""
    p = torch.softmax(q @ k.transpose(-1, -2) + add, -1)
    dp = g @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    return p @ v, ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ g, ds.sum(0)


SLAB = 128  # csrc/attn_bwd_f32.cu AB16_SLAB: query rows a step of B9 f32's second sweep


def _f32_ws16_partition(windows: int, heads: int, ws: int, sms: int) -> dict:
    """The attention passes of the f32 kernels at windows 9 to 16 as their
    blocks take them, one block an SM, restated from csrc/tf_window16.cuh
    and csrc/attn_bwd_f32.cu. ``rows``: ``tw_rows_kernel`` (B5's attention
    pass and B9's first sweep), block b is (group b // heads, head b %
    heads) and walks the windows g, g + groups, ...: its (window, head)
    units in order. ``main``: B9's second sweep (``ab16_main_kernel``),
    block b is (group b // (heads NCH), head (b // NCH) % heads, key chunk b
    % NCH) and walks its windows a slab of :data:`SLAB` queries at a time:
    its (window, head, slab, chunk) units in order; ``groups`` its group
    count (``tf32x3.groups``, the rule the launch uses), the order d bias's
    partials are summed in. NCH = ceil(ws^2 / 64) chunks of 64 keys."""
    nch = -(-ws * ws // 64)
    rgroups = min(-(-sms // heads), windows)
    rows = [[(w, b % heads) for w in range(b // heads, windows, rgroups)] for b in range(rgroups * heads)]
    groups = tf32x3.groups(windows, heads * nch, sms)
    slabs = -(-64 * nch // SLAB)
    main = [[(w, (b // nch) % heads, s, b % nch) for w in range(b // (nch * heads), windows, groups)
             for s in range(slabs)] for b in range(groups * heads * nch)]
    return dict(rows=rows, main=main, groups=groups)


def _by_partition(q, k, v, add, g, ws, sms):
    """The core as the two sweeps' blocks take it (``_f32_ws16_partition``):
    sweep 1 each (window, head)'s attn; sweep 2 each block's d-bias slice
    accumulated over its windows and written to its group's partial, dq as
    each (window, head)'s key-chunk partials summed in chunk order, dk and
    dv of a chunk accumulated over its slabs; then the groups' d-bias
    partials summed in group order. Plain f32 products, the window's tokens
    padded to whole 64-token chunks as the kernels lay them out (padding keys
    score -inf, padding queries' cotangents are zero)."""
    windows, heads, nv, d = q.shape
    nch = -(-nv // 64)
    n = 64 * nch
    pad = lambda t: F.pad(t, (0, 0, 0, n - nv))  # noqa: E731
    qp, kp, vp, gp = pad(q), pad(k), pad(v), pad(g)
    addp = torch.zeros(add.shape[0], heads, n, n)
    addp[..., :nv, :nv] = add
    addp[..., nv:] = -torch.inf
    s = qp @ kp.transpose(-1, -2) + addp
    p = torch.softmax(s, -1)
    dp = gp @ vp.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    plan = _f32_ws16_partition(windows, heads, int(round(nv**0.5)), sms)
    attn = torch.full_like(qp, torch.nan)
    seen = set()
    for units in plan["rows"]:
        for w, h in units:
            assert (w, h) not in seen
            seen.add((w, h))
            attn[w, h] = p[w, h] @ vp[w, h]
    assert len(seen) == windows * heads
    slab, groups = SLAB, plan["groups"]
    dq_parts = torch.zeros(windows, heads, nch, n, d)
    dk, dv = torch.zeros_like(kp), torch.zeros_like(vp)
    db_parts = torch.zeros(groups, heads, n, n)
    seen = set()
    for blk, units in enumerate(plan["main"]):
        grp = blk // (heads * nch)
        for w, h, sl, c in units:
            assert (w, h, sl, c) not in seen
            seen.add((w, h, sl, c))
            rows, keys = slice(sl * slab, min(n, (sl + 1) * slab)), slice(64 * c, 64 * c + 64)
            tile = ds[w, h, rows, keys]
            db_parts[grp, h, rows, keys] += tile
            dq_parts[w, h, c, rows] = tile @ kp[w, h, keys]
            dk[w, h, keys] += tile.T @ qp[w, h, rows]
            dv[w, h, keys] += p[w, h, rows, keys].T @ gp[w, h, rows]
    assert len(seen) == windows * heads * -(-n // slab) * nch
    dq = dq_parts[:, :, 0].clone()
    for c in range(1, nch):
        dq += dq_parts[:, :, c]
    dbias = db_parts[0].clone()
    for i in range(1, groups):
        dbias += db_parts[i]
    assert torch.equal(dk[..., nv:, :], torch.zeros_like(dk[..., nv:, :]))  # padding keys take nothing
    return [t[..., :nv, :] for t in (attn, dq, dk, dv)] + [dbias[:, :nv, :nv]]


@pytest.mark.parametrize("windows,heads,ws,d,sms", [(5, 2, 9, 16, 4), (7, 3, 12, 30, 8), (3, 6, 16, 30, 132),
                                                    (40, 2, 12, 8, 16)])
def test_ws16_f32_partition_covers_every_unit_once_and_reproduces_plain(windows, heads, ws, d, sms):
    """Each (window, head) is one sweep-1 block's work and each (window,
    head, slab, key chunk) one sweep-2 block's, exactly once, and the
    blocks' partials summed in their fixed orders give the core's plain
    gradients (atol 1e-5, rtol 1e-4), the shift's mask included."""
    rng = np.random.default_rng(windows * ws + d)
    nv = ws * ws
    f = lambda *s, k=1.0: _t((rng.standard_normal(s) * k).astype(np.float32))  # noqa: E731
    q, k, v, g = f(windows, heads, nv, d, k=d**-0.5), f(windows, heads, nv, d), f(windows, heads, nv, d), \
        f(windows, heads, nv, d)
    mask = _t(port_calculate_mask((2 * ws, 2 * ws), ws, ws // 2))  # (4, nv, nv): four window positions
    add = f(heads, nv, nv)[None] + mask[torch.arange(windows) % 4][:, None]
    got = _by_partition(q, k, v, add, g, ws, sms)
    want = _core(q, k, v, add, g)
    for name, a, e in zip(("attn", "dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
