"""B13 and B15 in f32 on the kernels written for the H100
(``csrc/oca_bwd_f32.cu``, ``csrc/window_attn.cu`` ``wf32_kernel``), on the
CPU: the wrappers' routing by dtype and geometry (launches on meta tensors
through a fake library); numpy emulations of each kernel's 3xTF32
arithmetic (the ``cvt.rna`` split of ``ops/cuda/tf32x3.py``, a fresh
accumulator for each 32-row stage of a product's K dimension, B13's dq
summed over 64-key chunks, B15's online softmax over 64-key chunks) held
against the same functions in f64 and against the Pallas kernels in
interpret mode; and a plain mirror of B13's main-pass partition and its
fixed-order sums.

Inputs come from numpy seeds and go to both packages. Tolerances: against
f64, the f32 kernels' rule on the card (max |k - p| <= 1e-4 max |p| +
1e-5); against the Pallas kernels, the JAX package's tests (B13
tests/ops/test_oca_vjp.py: atol 3e-4, rtol 2e-3; B15
tests/ops/test_pallas_attention.py: atol 2e-5, rtol 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.ops.pallas.oca_core import oca_core_bwd as jax_oca_core_bwd
from studiosr_tpu.ops.pallas.window_attn import window_attention_pallas
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda import oca_core as oca_module
from studiosr_tpu_torch.ops.cuda import window_attn as wa_module
from studiosr_tpu_torch.ops.cuda._launch import STREAM
from studiosr_tpu_torch.ops.cuda.ocab import overlap_window

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _meta_call(device, entry, *args):
    """``_launch.call`` for operands on the meta device, which reach the
    launch path without a card: no card to make current, stream 0."""
    return entry(*(0 if a is STREAM else a for a in args))


class _FakeLibrary:
    """Stands in for the built kernel libraries: records the C entries a
    wrapper calls; every launch and every scratch query returns status 0."""

    def __init__(self):
        self.calls = []

    def oca_core_bwd_scratch(self, bw, heads, nq, nk):
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


# -- the routing -----------------------------------------------------------------------


def _hat_geometry(ws):
    owin, _ = overlap_window(ws, 0.5)
    return ws * ws, owin * owin


# (dtype, window, d, entry): f32 B13 at HAT's windows 8, 12 and 16
# (d 30) and at the trained fixtures' d 16 on its 3xTF32 entry; above window
# 16 and at d 48 the first design; bf16 keeps its routes.
B13_ROUTES = [
    (torch.float32, 8, 30, "oca_core_bwd_mma_f32"),
    (torch.float32, 12, 30, "oca_core_bwd_mma_f32"),
    (torch.float32, 16, 30, "oca_core_bwd_mma_f32"),
    (torch.float32, 8, 16, "oca_core_bwd_mma_f32"),
    (torch.float32, 24, 30, "oca_core_bwd_f32"),
    (torch.float32, 16, 48, "oca_core_bwd_f32"),
    (torch.bfloat16, 16, 30, "oca_core_bwd_mma_bf16"),
    (torch.bfloat16, 24, 30, "oca_core_bwd_large_mma_bf16"),
    (torch.bfloat16, 16, 48, "oca_core_bwd_bf16"),
]


@pytest.mark.parametrize("dtype,ws,d,entry", B13_ROUTES)
def test_b13_routes_by_dtype_and_geometry(monkeypatch, dtype, ws, d, entry):
    """f32 B13 with a head dim up to 32, at most 256 queries and 576 keys
    launches ``oca_core_bwd_mma_f32`` with its scratch sized by the library;
    each launch counts under ``oca_core_bwd`` (``_large`` above 256 queries
    or 576 keys) and its C entry; ctypes types every argument."""
    lib = _fake(monkeypatch, oca_module)
    heads, bw = 6, 5
    nq, nk = _hat_geometry(ws)
    view = lambda n: torch.empty(bw, n, heads, d, dtype=dtype, device="meta").transpose(1, 2)  # noqa: E731
    q, k = view(nq), view(nk)
    dq, dk, dv, dbias = oca_module.oca_core_bwd(q, k, k, torch.empty(heads, nq, nk, device="meta"), q)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape and dbias.shape == (heads, nq, nk)
    assert dq.dtype == dtype and dbias.dtype == torch.float32
    launches = _launches(lib)
    assert [name for name, _ in launches] == [entry]
    if entry == "oca_core_bwd_mma_f32":
        scratch = [args for name, args in lib.calls if name == "oca_core_bwd_mma_f32_scratch"]
        assert len(scratch) == 1 and scratch[0][:5] == (bw, heads, nq, nk, d)
        assert len(launches[0][1]) == len(oca_module._SIGNATURES_F32[entry])
        assert launches[0][1][10:15] == (bw, heads, nq, nk, d)  # (9 pointers, strides, bw, heads, nq, nk, d, ...)
    assert (dtype == torch.float32 and oca_module.mma_takes(heads, nq, nk, d)) == (entry == "oca_core_bwd_mma_f32")
    name = oca_module.counter("oca_core_bwd", nq, nk)
    assert (ws > 16) == name.endswith("_large")
    assert engagement.counters() == {name: 1} and engagement.entries() == {name: {entry: 1}}
    engagement.reset()


# (label, windows, heads, N, d, bias, mask windows): MaxSR x4's adaptive and
# static serving shapes, a mask over two images, MaxSR light's d 12 at a 7 x 7
# window
B15_ROUTES = [("adaptive", 256, 4, 256, 32, False, 0), ("static", 1024, 4, 64, 32, True, 0),
              ("masked", 128, 4, 64, 32, True, 64), ("d 12", 64, 4, 49, 12, False, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,bw,heads,n,d,with_bias,nw", B15_ROUTES)
def test_b15_routes_by_dtype(monkeypatch, dtype, label, bw, heads, n, d, with_bias, nw):
    """f32 B15 launches ``window_attn_flash_f32`` and bf16
    ``window_attn_flash_bf16`` at MaxSR's shapes, the q, k, v slices of one
    projection and the transposed output handed over in place, counted
    under ``window_attention_pallas``; ctypes types every argument."""
    lib = _fake(monkeypatch, wa_module)
    qkv = torch.empty(bw, n, 3, heads, d, dtype=dtype, device="meta").permute(2, 0, 3, 1, 4)
    bias = torch.empty(heads, n, n, device="meta") if with_bias else None
    mask = torch.empty(nw, n, n, device="meta") if nw else None
    out = wa_module.window_attention(qkv[0], qkv[1], qkv[2], bias=bias, mask=mask)
    assert out.shape == (bw, heads, n, d) and out.dtype == dtype
    entry = "window_attn_flash_f32" if dtype == torch.float32 else "window_attn_flash_bf16"
    launches = _launches(lib)
    assert [name for name, _ in launches] == [entry]
    args = launches[0][1]
    assert len(args) == len(wa_module._SIGNATURES[entry])
    assert args[7:13] == (bw, heads, n, n, d, nw or 1)
    assert (args[3] is None) == (not with_bias) and (args[4] is None) == (not nw)
    assert engagement.entries() == {"window_attention_pallas": {entry: 1}}
    engagement.reset()


# -- 3xTF32 --------------------------------------------------------------------------------


def _tf32(x):
    """``cvt.rna.tf32.f32``: half an ulp of the 10-bit mantissa added to the
    magnitude, the low 13 bits cleared (finite values)."""
    bits = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return ((bits + 0x1000) & -0x2000).astype(np.int32).view(np.float32)


def _mm3(a, b):
    """a @ b in 3xTF32 as one accumulator: a_lo b_hi + a_hi b_lo + a_hi b_hi,
    each TF32 product exact in f32, accumulated in f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _mm3_staged(a, b, stage=32):
    """a @ b in 3xTF32 with a fresh accumulator for each ``stage`` rows of
    the K dimension, the stages added in order in f32."""
    acc = None
    for s0 in range(0, a.shape[-1], stage):
        part = _mm3(a[..., s0:s0 + stage], b[..., s0:s0 + stage, :])
        acc = part if acc is None else acc + part
    return acc


def _b13_emulated(q, k, v, bias, g):
    """B13's arithmetic in f32: scores and dprobs in 3xTF32 (d <= 32, one
    stage), the max-subtracted softmax's row statistics, p and dscores in
    f32; dq as the 64-key chunks' partials (each of two 32-key stages) summed
    in chunk order, dk and dv over 32-query stages, d bias summed over the
    windows."""
    s = _mm3(q, k.swapaxes(-1, -2)) + bias[None]
    dp = _mm3(g, v.swapaxes(-1, -2))
    m = s.max(-1, keepdims=True)
    e = np.exp(s - m)
    linv = np.float32(1) / e.sum(-1, keepdims=True)
    p = e * linv
    D = (e * dp).sum(-1, keepdims=True) * linv
    ds = (p * (dp - D)).astype(np.float32)
    dq = None
    for c0 in range(0, k.shape[2], 64):
        part = _mm3_staged(ds[..., c0:c0 + 64], k[:, :, c0:c0 + 64])
        dq = part if dq is None else dq + part
    dk = _mm3_staged(ds.swapaxes(-1, -2), q)
    dv = _mm3_staged(p.swapaxes(-1, -2), g)
    return dq, dk, dv, ds.sum(0)


def _b13_f64(q, k, v, bias, g):
    q, k, v, bias, g = (np.asarray(t, np.float64) for t in (q, k, v, bias, g))
    s = q @ k.swapaxes(-1, -2) + bias[None]
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    dp = g @ v.swapaxes(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdims=True))
    return ds @ k, ds.swapaxes(-1, -2) @ q, p.swapaxes(-1, -2) @ g, ds.sum(0)


def _b15_emulated(q, k, v, add):
    """B15's arithmetic in f32: 64-key chunks with an online max-subtracted
    softmax, the scores in 3xTF32 over 32-column stages of d, the
    probabilities kept in f32, p v over two 32-key stages a chunk, the row
    sum divided out at the end."""
    m = np.full(q.shape[:-1] + (1,), -np.inf, np.float32)
    lsum = np.zeros_like(m)
    o = np.zeros(q.shape, np.float32)
    for c0 in range(0, k.shape[2], 64):
        s = _mm3_staged(q, k[:, :, c0:c0 + 64].swapaxes(-1, -2)) + add[..., c0:c0 + 64]
        mn = np.maximum(m, s.max(-1, keepdims=True))
        corr = np.exp(m - mn)
        p = np.exp(s - mn)
        lsum = lsum * corr + p.sum(-1, keepdims=True)
        o = o * corr + _mm3_staged(p, v[:, :, c0:c0 + 64])
        m = mn
    return o / lsum


def _b15_f64(q, k, v, add):
    q, k, v, add = (np.asarray(t, np.float64) for t in (q, k, v, add))
    s = q @ k.swapaxes(-1, -2) + add
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


def _hold(got, want, name):
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()) + 1e-5, f"{name}: {err}"


# (bw, heads, nq, nk, d): HAT's window 8 at d 30, window 12's 144 queries
# over 328 keys (the Pallas kernel takes key counts in eights; a ragged last
# chunk), window 16's 256 | 576 at the trained fixtures' d 16
B13_CASES = [(3, 2, 64, 144, 30), (2, 2, 144, 328, 30), (2, 1, 256, 576, 16)]


@pytest.mark.parametrize("bw,heads,nq,nk,d", B13_CASES)
def test_b13_in_3xtf32_holds_f32_against_f64_and_pallas(bw, heads, nq, nk, d):
    """The emulated kernel against f64 at the kernels' f32 rule, and against
    ``oca_core_bwd(interpret=True)`` at the JAX package's tolerance; scores
    of a few units, so the row max matters."""
    rng = np.random.default_rng(nq + nk + d)
    q = (rng.standard_normal((bw, heads, nq, d)) * 2 * d**-0.5).astype(np.float32)
    k = rng.standard_normal((bw, heads, nk, d)).astype(np.float32)
    v = rng.standard_normal((bw, heads, nk, d)).astype(np.float32)
    bias = (rng.standard_normal((heads, nq, nk)) * 2).astype(np.float32)
    g = rng.standard_normal((bw, heads, nq, d)).astype(np.float32)
    got = _b13_emulated(q, k, v, bias, g)
    want = _b13_f64(q, k, v, bias, g)
    jax_got = jax_oca_core_bwd(*map(jnp.asarray, (q, k, v, bias, g)), interpret=True)
    for name, a, e, j in zip(("dq", "dk", "dv", "dbias"), got, want, jax_got):
        _hold(a, e, name)
        np.testing.assert_allclose(a, np.asarray(j), atol=3e-4, rtol=2e-3, err_msg=name)


# (windows, heads, N, d, bias, mask windows): MaxSR's adaptive shape (no
# bias) cut to four windows, its static shape with a bias, a mask over
# every window (the Pallas kernel's batch-1 case), a 7 x 7 window at d 12,
# N 100 over two key chunks at d 40 (two stages of d)
B15_CASES = [(4, 2, 256, 32, False, 0), (8, 2, 64, 32, True, 0), (6, 2, 64, 32, True, 6), (5, 3, 49, 12, False, 0),
             (3, 2, 100, 40, True, 0)]


@pytest.mark.parametrize("bw,heads,n,d,with_bias,nw", B15_CASES)
def test_b15_in_3xtf32_holds_f32_against_f64_and_pallas(bw, heads, n, d, with_bias, nw):
    """The emulated kernel against f64 at the kernels' f32 rule, and against
    ``window_attention_pallas(interpret=True)`` at the JAX package's
    tolerance."""
    rng = np.random.default_rng(bw + n + d)
    q = (rng.standard_normal((bw, heads, n, d)) * 2 * d**-0.5).astype(np.float32)
    k = rng.standard_normal((bw, heads, n, d)).astype(np.float32)
    v = rng.standard_normal((bw, heads, n, d)).astype(np.float32)
    bias = (rng.standard_normal((heads, n, n)) * 2).astype(np.float32) if with_bias else None
    mask = np.where(rng.random((nw, n, n)) > 0.7, -100.0, 0.0).astype(np.float32) if nw else None
    add = np.zeros((bw, heads, n, n), np.float32)
    if bias is not None:
        add += bias[None]
    if mask is not None:
        add += np.tile(mask, (bw // nw, 1, 1))[:, None]
    got = _b15_emulated(q, k, v, add)
    _hold(got, _b15_f64(q, k, v, add), "out")
    want = window_attention_pallas(*map(jnp.asarray, (q, k, v)), bias=None if bias is None else jnp.asarray(bias),
                                   mask=None if mask is None else jnp.asarray(mask), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-4)


# -- B13's partition and its sums ------------------------------------------------------------


def _by_partition(q, k, v, bias, g, sms):
    """B13's gradients as the f32 main pass's blocks take them
    (``f32_partition``): each block accumulates its d-bias slice over its
    windows in order and writes its group's partial; dq as each (window,
    head, slab)'s chunk partials summed in chunk order; dk and dv of a
    chunk accumulated over its slabs; then the groups' d-bias partials
    summed in group order. Plain f32 products."""
    bw, heads, nq, d = q.shape
    nk = k.shape[2]
    slab = oca_module.F32_SLAB
    s = q @ k.transpose(-1, -2) + bias[None]
    p = torch.softmax(s, -1)
    dp = g @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    blocks = oca_module.f32_partition(bw, heads, nq, nk, sms)
    kt, groups = -(-nk // 64), len(blocks) // (heads * -(-nk // 64))
    dq_parts = torch.zeros(bw, heads, kt, nq, d)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    db_parts = torch.zeros(groups, heads, nq, nk)
    seen = set()
    for b, units in enumerate(blocks):
        grp = b // (heads * kt)
        for w, h, sl, c in units:
            assert (w, h, sl, c) not in seen
            seen.add((w, h, sl, c))
            rows, keys = slice(sl * slab, min(nq, (sl + 1) * slab)), slice(64 * c, min(nk, 64 * c + 64))
            tile = ds[w, h, rows, keys]
            db_parts[grp, h, rows, keys] += tile
            dq_parts[w, h, c, rows] = tile @ k[w, h, keys]
            dk[w, h, keys] += tile.T @ q[w, h, rows]
            dv[w, h, keys] += p[w, h, rows, keys].T @ g[w, h, rows]
    assert len(seen) == bw * heads * -(-nq // slab) * kt
    dq = dq_parts[:, :, 0].clone()
    for c in range(1, kt):
        dq += dq_parts[:, :, c]
    dbias = db_parts[0].clone()
    for i in range(1, groups):
        dbias += db_parts[i]
    return dq, dk, dv, dbias


@pytest.mark.parametrize("bw,heads,nq,nk,d,sms", [(5, 2, 64, 144, 16, 4), (7, 3, 144, 324, 30, 8),
                                                  (3, 2, 256, 576, 30, 132)])
def test_b13_f32_partition_covers_every_unit_once_and_reproduces_plain(bw, heads, nq, nk, d, sms):
    """Each (window, head, slab, key chunk) is one block's work exactly once,
    and the blocks' partials summed in their fixed orders give
    ``oca_core_bwd_plain`` (atol 1e-5, rtol 1e-4)."""
    rng = np.random.default_rng(bw * nq + d)
    q = _t((rng.standard_normal((bw, heads, nq, d)) * d**-0.5).astype(np.float32))
    k, v, g = (_t(rng.standard_normal(shape).astype(np.float32))
               for shape in ((bw, heads, nk, d), (bw, heads, nk, d), (bw, heads, nq, d)))
    bias = _t(rng.standard_normal((heads, nq, nk)).astype(np.float32))
    got = _by_partition(q, k, v, bias, g, sms)
    want = oca_module.oca_core_bwd_plain(q, k, v, bias, g)
    for name, a, e in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
