"""B6 and B13's bf16 routes written for the H100 (``csrc/mlp_block_mma.cu``,
``csrc/oca_bwd_mma.cu``), on the CPU: B6's packed weights checked element by
element against their rule and unpacked back to the identity; B13's operand
images (its pass 0) element by element, and its main pass's partition of
the work; the plain versions on packed and on dense weights, and on the
OCAB's strided d-30 views, against the Pallas kernels in interpret mode; the
wrappers' routing by dtype and geometry (launches on meta tensors through a
fake library); and the autograd Functions against autograd of the plain
versions.

Inputs come from numpy seeds and go to both packages. Tolerances are the JAX
package's: B6's forward as tests/ops/test_fused_swin.py (atol 5e-5, rtol
1e-4), B13's gradients as tests/ops/test_oca_vjp.py (atol 1e-4, rtol 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.ops.pallas.oca_core import oca_core_bwd as jax_oca_core_bwd
from studiosr_tpu.ops.pallas.swin_block import fused_mlp_block as jax_fused_mlp_block
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.mlp_block import (
    _f32_pack_index, _mma_pack_index, fused_mlp_block, mlp_block_plain, mma_takes, pack_mlp_block, unpack_mlp_block,
)
from studiosr_tpu_torch.ops.cuda.oca_core import (
    counter, main_partition, oca_core_bwd, oca_core_bwd_plain, oca_core_plain, pack_images,
)
from studiosr_tpu_torch.ops.cuda.oca_core import mma_takes as oca_mma_takes
from studiosr_tpu_torch.ops.mlp_vjp import mlp_block_dp_vjp
from studiosr_tpu_torch.ops.oca_vjp import oca_attention
from studiosr_tpu_torch.ops.cuda._launch import STREAM

torch.set_num_threads(2)


def _meta_call(device, entry, *args):
    """``_launch.call`` for operands on the meta device, which reach the
    launch path without a card: no card to make current, stream 0."""
    return entry(*(0 if a is STREAM else a for a in args))


ATOL_B6, RTOL_B6 = 5e-5, 1e-4
ATOL_B13, RTOL_B13 = 1e-4, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _mlp_operands(rng, c, hidden):
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    return dict(ln_w=1.0 + f(c, k=0.1), ln_b=f(c, k=0.1), w1=f(c, hidden, k=0.2), b1=f(hidden, k=0.1),
                w2=f(hidden, c, k=0.2), b2=f(c, k=0.1))


# -- B6's packed weights -------------------------------------------------------------------


def _expected_b6_pack(c: int, hidden: int) -> list:
    """The packed weights built element by element from the rule: per chunk
    of 64 hidden units (the last padded), fc1's columns of the chunk as a
    K-major image of pad16(C) rows x 64 (row r, column n = w1[r, 64 chunk +
    n]), then fc2's rows as a K-major image of 64 rows x NP (row k, column n
    = w2[64 chunk + k, n]), NP the least of 32, 64, 96, 128, 184 >= C. Each
    element names the weight it holds, ("w1", r, j) or ("w2", j, n), or None.
    A K-major image of R rows x N: core matrices of 8 columns x 8 rows, 16
    contiguous bytes a column's 8 rows."""
    kc = (c + 15) // 16 * 16
    npw = next(w for w in (32, 64, 96, 128, 184) if c <= w)
    out = []

    def stage(rows, cols, weight):
        img = [None] * (rows * cols)
        for n in range(cols):
            for k in range(rows):
                img[(n // 8) * rows * 8 + (k // 8) * 64 + (n % 8) * 8 + k % 8] = weight(k, n)
        out.extend(img)

    for ch in range(-(-hidden // 64)):
        stage(kc, 64, lambda r, n: ("w1", r, 64 * ch + n) if r < c and 64 * ch + n < hidden else None)
        stage(64, npw, lambda k, n: ("w2", 64 * ch + k, n) if 64 * ch + k < hidden and n < c else None)
    return out


@pytest.mark.parametrize("c,hidden", [(180, 360), (32, 64), (16, 40), (60, 120), (128, 512)])
def test_b6_packed_layout_matches_its_rule_element_by_element(c, hidden):
    index = _mma_pack_index(c, hidden)
    expected = _expected_b6_pack(c, hidden)
    assert index.size == len(expected)
    zero = 2 * c * hidden
    want = np.array([zero if e is None else (e[1] * hidden + e[2] if e[0] == "w1" else c * hidden + e[1] * c + e[2])
                     for e in expected])
    np.testing.assert_array_equal(index, want)
    # and the blob of distinct weights puts each where the rule says
    w1 = torch.arange(1, c * hidden + 1, dtype=torch.float64).reshape(c, hidden)
    w2 = -torch.arange(1, c * hidden + 1, dtype=torch.float64).reshape(hidden, c)
    blob = pack_mlp_block(w1, w2)
    ref = [0.0 if e is None else float((w1 if e[0] == "w1" else w2)[e[1], e[2]]) for e in expected]
    np.testing.assert_array_equal(blob.numpy(), np.array(ref))


@pytest.mark.parametrize("c,hidden", [(180, 360), (32, 64), (24, 100), (128, 512)])
def test_b6_unpacking_the_packed_weights_gives_them_back(c, hidden):
    rng = np.random.default_rng(c + hidden)
    w1 = _t(rng.standard_normal((c, hidden)).astype(np.float32)).to(torch.bfloat16)
    w2 = _t(rng.standard_normal((hidden, c)).astype(np.float32)).to(torch.bfloat16)
    blob = pack_mlp_block(w1, w2)
    assert blob.dtype == torch.bfloat16 and blob.dim() == 1
    back1, back2 = unpack_mlp_block(blob, c, hidden)
    assert torch.equal(back1, w1) and torch.equal(back2, w2)


@pytest.mark.parametrize("c,rows_per_sample,mode", [
    (16, 150, None), (16, 128, "drop_path"), (32, 100, "extra"), (24, 130, "extra"),
])
def test_b6_plain_on_packed_and_dense_weights_matches_pallas(c, rows_per_sample, mode):
    """``fused_mlp_block``'s plain version, on dense weights and on the
    serving blob, against the Pallas ``fused_mlp_block`` in interpret mode:
    two samples of ``rows_per_sample`` rows (not a multiple of its blocks),
    with per-sample drop-path scales (one of them 0) or HAT's CAB join."""
    rng = np.random.default_rng(c + rows_per_sample + len(mode or ""))
    hidden, rows = 2 * c, 2 * rows_per_sample
    x = rng.standard_normal((rows, c)).astype(np.float32)
    ops = _mlp_operands(rng, c, hidden)
    for k in ("w1", "w2"):  # weights bf16 holds exactly, so the blob is lossless
        ops[k] = _t(ops[k]).to(torch.bfloat16).float().numpy()
    jkw, kw = {}, {}
    if mode == "drop_path":
        dp = np.array([0.0, 1.25], np.float32)
        jkw = dict(drop_path=jnp.asarray(dp), rows_per_sample=rows_per_sample)
        kw = dict(drop_path=_t(dp), rows_per_sample=rows_per_sample)
    elif mode == "extra":
        extra = rng.standard_normal((rows, c)).astype(np.float32)
        escale = (rng.standard_normal(c) * 0.5).astype(np.float32)
        jkw = dict(extra=jnp.asarray(extra), extra_scale=jnp.asarray(escale))
        kw = dict(extra=_t(extra), extra_scale=_t(escale))
    want = np.asarray(jax_fused_mlp_block(jnp.asarray(x), *[jnp.asarray(v) for v in ops.values()], block_rows=64,
                                          interpret=True, **jkw))
    dense = {k: _t(v) for k, v in ops.items()}
    blob = pack_mlp_block(dense["w1"], dense["w2"])
    engagement.reset()
    got = fused_mlp_block(_t(x), **dense, **kw)
    packed = fused_mlp_block(_t(x), **dict(dense, w1=blob, w2=None), **kw)
    assert engagement.counters() == {}  # CPU tensors take the plain version
    assert torch.equal(got, packed)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_B6, rtol=RTOL_B6)
    if mode == "drop_path":
        np.testing.assert_array_equal(got[:rows_per_sample].numpy(), x[:rows_per_sample])


# -- B13's images and partition -------------------------------------------------------------


def _strided(rng, bw, heads, n, d, scale=1.0):
    """(bw, heads, n, d) as a transposed view of a (bw, n, heads, d) tensor, as the OCAB makes it."""
    return _t((rng.standard_normal((bw, n, heads, d)) * scale).astype(np.float32)).transpose(1, 2)


@pytest.mark.parametrize("bw,heads,nq,nk,d", [(2, 2, 64, 144, 16), (1, 3, 100, 70, 30), (2, 1, 256, 576, 8)])
def test_b13_operand_images_match_their_rule_element_by_element(bw, heads, nq, nk, d):
    """Pass 0's images: per (window, head) unit, q and g in ceil(nq / 64)
    tiles, then k and v in ceil(nk / 64), each 64 tokens x DP (16 at d <=
    16, else 32) with token t, column j at (t // 8) DP 8 + (j // 8) 64 + (t %
    8) 8 + j % 8, zero past the tokens and past d."""
    rng = np.random.default_rng(bw + nq + nk + d)
    q, g = _strided(rng, bw, heads, nq, d), _strided(rng, bw, heads, nq, d)
    k, v = _strided(rng, bw, heads, nk, d), _strided(rng, bw, heads, nk, d)
    img = pack_images(q, k, v, g).numpy()
    dp = 16 if d <= 16 else 32
    qt, kt = -(-nq // 64), -(-nk // 64)
    assert img.shape == (bw * heads, (2 * qt + 2 * kt) * 64 * dp)
    want = np.zeros_like(img)
    tile = 0
    for t, n in ((q, nq), (g, nq), (k, nk), (v, nk)):
        a = t.numpy()
        for ti in range(-(-n // 64)):
            for tok in range(64):
                for j in range(dp):
                    pos = tile * 64 * dp + (tok // 8) * dp * 8 + (j // 8) * 64 + (tok % 8) * 8 + j % 8
                    if 64 * ti + tok < n and j < d:
                        want[:, pos] = a[:, :, 64 * ti + tok, j].reshape(-1)
            tile += 1
    np.testing.assert_array_equal(img, want)


@pytest.mark.parametrize("bw,heads,nq,nk,sms", [
    (512, 6, 256, 576, 132), (37, 6, 256, 576, 132), (5, 2, 64, 144, 132), (7, 3, 200, 300, 16),
])
def test_b13_main_partition_covers_each_unit_once(bw, heads, nq, nk, sms):
    """The main pass's blocks, as ``ob_main_kernel`` takes them (a block a
    (group, head, key chunk), warpgroups over the query tiles, windows g, g +
    groups, ...), cover every (window, head, query tile, key chunk) exactly
    once, also where bw is not a whole number of groups; every block of a
    (group, head) walks the same windows, so d bias has one partial a group."""
    blocks = main_partition(bw, heads, nq, nk, sms)
    qt, kt = -(-nq // 64), -(-nk // 64)
    seen = [unit for block in blocks for unit in block]
    assert len(seen) == len(set(seen)) == bw * heads * qt * kt
    groups = len(blocks) // (heads * kt)
    assert 1 <= groups <= min(bw, 64) and len(blocks) == groups * heads * kt
    for b, block in enumerate(blocks):
        assert {u[3] for u in block} == {b % kt} and {u[1] for u in block} == {(b // kt) % heads}
        assert sorted({u[0] for u in block}) == list(range(b // (kt * heads), bw, groups))


@pytest.mark.parametrize("bw,heads,nq,nk,d", [(2, 2, 64, 144, 16), (2, 6, 64, 64, 30)])
def test_b13_plain_on_strided_views_matches_pallas(bw, heads, nq, nk, d):
    """``oca_core_bwd``'s plain version on the OCAB's transposed views (d 30
    at 6 heads, and the trained fixtures' 64 | 144 tokens at d 16) against
    the Pallas ``oca_core_bwd`` in interpret mode; scores of a few units."""
    rng = np.random.default_rng(nq + nk + d)
    q, k = _strided(rng, bw, heads, nq, d, 2 * d**-0.5), _strided(rng, bw, heads, nk, d)
    v, g = _strided(rng, bw, heads, nk, d), _strided(rng, bw, heads, nq, d)
    bias = _t((rng.standard_normal((heads, nq, nk)) * 2.0).astype(np.float32))
    want = jax_oca_core_bwd(*[jnp.asarray(t.contiguous().numpy()) for t in (q, k, v, bias, g)], interpret=True)
    engagement.reset()
    got = oca_core_bwd(q, k, v, bias, g)
    assert engagement.counters() == {}
    for name, a, e in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=ATOL_B13, rtol=RTOL_B13, err_msg=name)


# -- the wrappers' routing --------------------------------------------------------------


class _FakeLibrary:
    """Stands in for the built kernel libraries: records the C entries a
    wrapper calls and answers the packed layouts' and scratches' sizes as
    the built libraries do; every launch returns status 0 (and computes
    nothing)."""

    def __init__(self):
        self.calls = []

    def mlp_block_mma_pack_elems(self, c, hidden):
        return _mma_pack_index(c, hidden).size

    def mlp_block_mma_f32_pack_elems(self, c, hidden):
        return _f32_pack_index(c, hidden).size

    def mlp_block_mma_f32_scratch(self, rows, c, hidden, extra):
        return 1

    def mlp_block_pack_elems(self, c, hidden):
        return 1

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
    return [name for name, _ in lib.calls if not name.endswith(("_scratch", "_elems"))]


@pytest.mark.parametrize("dtype,c,hidden,mode,entry", [
    (torch.bfloat16, 180, 360, "drop_path", "mlp_block_mma_bf16"),
    (torch.bfloat16, 180, 360, "packed", "mlp_block_mma_bf16"),  # the serving blob, batch > 1
    (torch.bfloat16, 180, 360, "extra", "mlp_block_extra_mma_bf16"),  # HAT serving's join
    (torch.bfloat16, 32, 64, None, "mlp_block_mma_bf16"),  # the fixtures' width
    (torch.bfloat16, 90, 180, None, "mlp_block_bf16"),  # C not a multiple of 4: the older kernel, by rule
    (torch.bfloat16, 128, 512, None, "mlp_block_mma_bf16"),  # MaxSR's feed-forward
    (torch.bfloat16, 64, 576, "extra", "mlp_block_extra_bf16"),  # hidden above 512
    (torch.float32, 180, 360, "drop_path", "mlp_block_mma_f32"),  # f32: csrc/mlp_block_f32.cu
    (torch.float32, 180, 360, "extra", "mlp_block_extra_mma_f32"),
    (torch.float32, 90, 180, None, "mlp_block_f32"),  # f32, C not a multiple of 4: the older kernel, by rule
    (torch.float32, 64, 576, "extra", "mlp_block_extra_f32"),  # f32, hidden above 512
])
def test_fused_mlp_block_routes_by_dtype_and_width(monkeypatch, dtype, c, hidden, mode, entry):
    """bf16 with C a multiple of 4 up to 184 and hidden up to 512 goes to the
    kernel written for the H100 (dense weights, gathered by the entry, or
    the serving blob), f32 with C a multiple of 4 up to 256 and hidden up to
    512 to the f32 kernel written for the H100, other widths to the older
    kernel; each launch counts under its kernel and its C entry."""
    import studiosr_tpu_torch.ops.cuda.mlp_block as module

    lib = _fake(monkeypatch, module)
    f32 = torch.float32
    meta = lambda *s, dt=dtype: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    rows = 2 * 100
    w1, w2 = meta(c, hidden), meta(hidden, c)
    kw = {}
    if mode == "packed":
        w1, w2 = meta(_mma_pack_index(c, hidden).size), None
    elif mode == "drop_path":
        kw = dict(drop_path=meta(2, dt=f32), rows_per_sample=100)
    elif mode == "extra":
        kw = dict(extra=meta(rows, c), extra_scale=meta(c, dt=f32))
    ops = (meta(c, dt=f32), meta(c, dt=f32), w1, meta(hidden, dt=f32), w2, meta(c, dt=f32))
    out = fused_mlp_block(meta(rows, c), *ops, **kw)
    assert out.shape == (rows, c) and out.dtype == dtype
    assert _launches(lib) == [entry]
    assert (dtype == torch.bfloat16 and mma_takes(c, hidden)) == ("mma_bf16" in entry)
    name = "fused_mlp_block_extra" if mode == "extra" else "fused_mlp_block"
    assert engagement.entries() == {name: {entry: 1}}
    if "mma_bf16" in entry:  # dense weights are gathered by the entry; the blob is handed over as it is
        args = dict(lib.calls)[entry]
        assert (args[7] is None) == (mode == "packed") and (args[-4] is None) == (mode != "packed")
    engagement.reset()


def test_fused_mlp_block_packed_weights_outside_the_h100_rule_raise(monkeypatch):
    """The serving blob is the bf16 H100 kernel's layout: f32, or a geometry
    the kernel does not take, raises rather than reading it as dense."""
    import studiosr_tpu_torch.ops.cuda.mlp_block as module

    lib = _fake(monkeypatch, module)
    meta = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="packed weights"):
        fused_mlp_block(meta(200, 180), meta(180), meta(180), meta(_mma_pack_index(180, 360).size), meta(360), None,
                        meta(180))
    assert _launches(lib) == [] and engagement.counters() == {}


@pytest.mark.parametrize("dtype,heads,nq,nk,d,entry", [
    (torch.bfloat16, 6, 256, 576, 30, "oca_core_bwd_mma_bf16"),  # HAT's training step
    (torch.bfloat16, 2, 64, 144, 16, "oca_core_bwd_mma_bf16"),  # the trained fixtures' window 8
    (torch.bfloat16, 3, 200, 300, 24, "oca_core_bwd_mma_bf16"),  # ragged tiles
    (torch.bfloat16, 2, 64, 144, 48, "oca_core_bwd_bf16"),  # head dim above 32: the older kernel, by rule
    (torch.bfloat16, 2, 64, 640, 16, "oca_core_bwd_large_mma_bf16"),  # more than 576 keys: the large entry
    (torch.float32, 6, 256, 576, 30, "oca_core_bwd_mma_f32"),
])
def test_oca_core_bwd_routes_by_dtype_and_geometry(monkeypatch, dtype, heads, nq, nk, d, entry):
    """bf16 with a head dim up to 32 goes to the backward written for the
    H100 (its large entry above 256 queries or 576 keys), other bf16
    geometries to the older kernel, f32 in the same geometry to its 3xTF32
    entry; the outputs are the OCAB's
    transposed views; each launch counts under ``oca_core_bwd`` (above 256
    queries or 576 keys ``oca_core_bwd_large``) and its C entry."""
    import studiosr_tpu_torch.ops.cuda.oca_core as module

    lib = _fake(monkeypatch, module)
    bw = 3
    view = lambda n: torch.empty(bw, n, heads, d, dtype=dtype, device="meta").transpose(1, 2)  # noqa: E731
    q, k, v, g = view(nq), view(nk), view(nk), view(nq)
    dq, dk, dv, dbias = oca_core_bwd(q, k, v, torch.empty(heads, nq, nk, device="meta"), g)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape and dbias.shape == (heads, nq, nk)
    assert dq.dtype == dtype and dbias.dtype == torch.float32
    assert dq.stride() == (nq * heads * d, d, heads * d, 1)  # (bw, nq, heads, d) storage
    assert _launches(lib) == [entry]
    assert (dtype == torch.bfloat16 and oca_mma_takes(heads, nq, nk, d)) == (entry == "oca_core_bwd_mma_bf16")
    assert (dtype == torch.bfloat16 and d <= 32 and counter("", nq, nk) == "_large") == ("large" in entry)
    assert engagement.entries() == {counter("oca_core_bwd", nq, nk): {entry: 1}}
    engagement.reset()


# -- the autograd Functions ---------------------------------------------------------------


@pytest.mark.parametrize("c,rows_per_sample,dp", [(180, 64, (1.25, 0.0)), (16, 90, None)])
def test_mlp_block_dp_vjp_grads_match_autograd_of_plain(c, rows_per_sample, dp):
    """``mlp_block_dp_vjp`` (B6 forward, B7 backward) against autograd of the
    plain forward, at HAT's and SwinIR's width 180 and at 16."""
    rng = np.random.default_rng(c + 7)
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


@pytest.mark.parametrize("bw,heads,nq,nk,d", [(2, 2, 64, 144, 16), (1, 3, 100, 70, 30)])
def test_oca_attention_grads_match_autograd_of_plain(bw, heads, nq, nk, d):
    """``oca_attention`` (B12 forward, B13 backward) on the OCAB's strided
    views against autograd of the plain forward, the bias included."""
    rng = np.random.default_rng(bw + nq + nk)
    q = _strided(rng, bw, heads, nq, d, d**-0.5).detach().requires_grad_()
    k, v = _strided(rng, bw, heads, nk, d).requires_grad_(), _strided(rng, bw, heads, nk, d).requires_grad_()
    bias = _t(rng.standard_normal((heads, nq, nk)).astype(np.float32)).requires_grad_()
    g = _strided(rng, bw, heads, nq, d, 0.1)
    args = (q, k, v, bias)
    got = torch.autograd.grad((oca_attention(*args) * g).sum(), args)
    want = torch.autograd.grad((oca_core_plain(*args) * g).sum(), args)
    for name, a, e in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
