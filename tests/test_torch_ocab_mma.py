"""B10's bf16 route written for the H100 (``csrc/ocab_mma.cu``), on the CPU:
its key images (pass 2, ``oc_gather_kernel``) built element by element from
their rule; the block read back from the images the kernels read (q as the
projection pass writes it, k and v as the gather writes them) against the
Pallas ``fused_ocab_block`` in interpret mode and the JAX package's XLA
``_ocab``; the blob ``pack_ocab_block`` packs (B5's q|k|v and proj layout,
then B6's fc1 and fc2) and its unpacking; ``prepare_hat_serving``'s B10
layout and rel-pos bias against the JAX package's, and the bf16-prepared
fast forward against the JAX model; the wrapper's routing by dtype and
geometry (launches on meta tensors through a fake library).

Inputs come from numpy seeds and go to both packages. Tolerances: the JAX
package's tests/ops/test_fused_swin.py (atol 5e-5, rtol 1e-4), as
tests/test_torch_hat.py holds B10's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from studiosr_tpu.models.hat import HAT as JaxHAT
from studiosr_tpu.ops.pallas.ocab import fused_ocab_block as jax_fused_ocab_block
from studiosr_tpu.serving.hat_fast import _ocab as jax_ocab
from studiosr_tpu.serving.hat_fast import prepare_hat_serving as jax_prepare_hat_serving
from studiosr_tpu_torch import HAT
from studiosr_tpu_torch.ops.cuda import engagement
from studiosr_tpu_torch.ops.cuda.mlp_block import pack_mlp_block
from studiosr_tpu_torch.ops.cuda.oca_core import _kmajor_tiles, fwd_from_images
from studiosr_tpu_torch.ops.cuda.ocab import (
    fused_ocab_block, ocab_f32_mma_takes, ocab_mma_takes, overlap_window, pack_key_images, pack_ocab_block,
    packed_ocab_elems, unpack_ocab_block,
)
from studiosr_tpu_torch.ops.cuda.window_attention import pack_window_attention
from studiosr_tpu_torch.ops.windows import gather_rel_bias, relative_position_index_oca, window_partition, window_reverse
from studiosr_tpu_torch.serving.hat_fast import hat_fast_forward, prepare_hat_serving
from studiosr_tpu_torch.zoo import load_jax_params
from studiosr_tpu_torch.ops.cuda._launch import STREAM

torch.set_num_threads(2)


def _meta_call(device, entry, *args):
    """``_launch.call`` for operands on the meta device, which reach the
    launch path without a card: no card to make current, stream 0."""
    return entry(*(0 if a is STREAM else a for a in args))


ATOL, RTOL = 5e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _f(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bf16_exact(a):
    """``a`` rounded to bf16 and back: values the packed bf16 blob holds exactly."""
    return _t(a).to(torch.bfloat16).float().numpy()


# -- the key images (pass 2) ------------------------------------------------------------------


def _expected_key_images(k, v, ws, pad):
    """The key images built element by element from the rule: per (window,
    head) unit, windows row-major over the batch, KT = ceil(owin^2 / 64)
    chunks of k, then KT of v, 64 positions x DP each (DP 16 at d <= 16,
    else 32); position p of chunk c holds key 64 c + 16 ((p % 8) // 2) + 2 (p
    // 8) + p % 2 of the owin x owin window, whose pixel is (window row ws -
    pad + key // owin, window column ws - pad + key % owin); k's column j at
    (p // 8) DP 8 + (j // 8) 64 + (p % 8) 8 + j % 8, v's at (j // 8) 512 + (p
    // 8) 64 + (j % 8) 8 + p % 8; zero outside the image, past owin^2 and
    past d."""
    b, h, w, heads, d = k.shape
    owin = ws + 2 * pad
    nk, dp = owin * owin, 16 if d <= 16 else 32
    kt = -(-nk // 64)
    nwy, nwx = h // ws, w // ws
    out = np.zeros((b * nwy * nwx * heads, 2 * kt * 64 * dp), np.float32)
    cols = np.arange(d)
    for img in range(b):
        for wy in range(nwy):
            for wx in range(nwx):
                for hh in range(heads):
                    u = ((img * nwy + wy) * nwx + wx) * heads + hh
                    for part, t in ((0, k), (1, v)):
                        for c in range(kt):
                            for p in range(64):
                                key = 64 * c + 16 * ((p % 8) // 2) + 2 * (p // 8) + p % 2
                                y, x = wy * ws - pad + key // owin, wx * ws - pad + key % owin
                                if key >= nk or not (0 <= y < h and 0 <= x < w):
                                    continue
                                if part == 0:
                                    off = (p // 8) * dp * 8 + (cols // 8) * 64 + (p % 8) * 8 + cols % 8
                                else:
                                    off = (cols // 8) * 512 + (p // 8) * 64 + (cols % 8) * 8 + p % 8
                                out[u, (part * kt + c) * 64 * dp + off] = t[img, y, x, hh]
    return out


@pytest.mark.parametrize("ws,overlap,shape,heads,d", [
    (16, 0.5, (1, 32, 48), 2, 8),  # HAT's window: 24 x 24 keys, nine chunks
    (16, 0.5, (2, 32, 16), 1, 30),  # batch 2, H != W, HAT's head dim (DP 32)
    (8, 0.5, (1, 16, 24), 2, 16),  # 12 x 12 keys: 144, the last chunk part padding
    (8, 0.5, (2, 24, 8), 2, 8),
    (8, 1.0, (1, 16, 24), 3, 8),  # 16 x 16 keys
    (8, 1.0, (2, 8, 16), 2, 12),
])
def test_b10_key_images_match_their_rule_element_by_element(ws, overlap, shape, heads, d):
    """``pack_key_images`` (the gather pass's plain version) against the
    rule; in the first window the keys outside the image are zero rows and
    the positions past owin^2 are zero."""
    rng = np.random.default_rng(ws + shape[0] + shape[1] + d)
    k, v = _f(rng, *shape, heads, d), _f(rng, *shape, heads, d)
    owin, pad = overlap_window(ws, overlap)
    got = pack_key_images(_t(k), _t(v), ws, overlap).numpy()
    want = _expected_key_images(k, v, ws, pad)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    nk, dp = owin * owin, 16 if d <= 16 else 32
    kt = -(-nk // 64)
    keys = got[0, : kt * 64 * dp].reshape(kt, 64 // 8, dp // 8, 8, 8).transpose(0, 1, 3, 2, 4).reshape(kt * 64, dp)
    zero_rows = int((np.abs(keys).sum(1) == 0).sum())
    outside = nk - min(owin - pad, shape[1]) * min(owin - pad, shape[2])  # window 0's keys off the image
    assert zero_rows == outside + (kt * 64 - nk)


# -- the block read back from the kernels' images --------------------------------------------


def _block_ops(rng, c, heads, ws, owin, hidden):
    """B10's operands, the weights bf16-exact: (ln1_w, ln1_b, wqkv, bqkv,
    wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2), numpy f32."""
    return [1 + _f(rng, c, scale=0.1), _f(rng, c, scale=0.1), _bf16_exact(_f(rng, c, 3 * c, scale=c**-0.5)),
            _f(rng, 3 * c, scale=0.1), _bf16_exact(_f(rng, c, c, scale=c**-0.5)), _f(rng, c, scale=0.1),
            _f(rng, heads, ws * ws, owin * owin, scale=0.5), 1 + _f(rng, c, scale=0.1), _f(rng, c, scale=0.1),
            _bf16_exact(_f(rng, c, hidden, scale=c**-0.5)), _f(rng, hidden, scale=0.1),
            _bf16_exact(_f(rng, hidden, c, scale=hidden**-0.5)), _f(rng, c, scale=0.1)]


def _images(x, ops, heads, ws, overlap):
    """B12's unit images as B10's attention pass reads them: q of each
    window as the projection pass writes it (K-major in d, scaled), then the
    key images of ``pack_key_images``."""
    ln1_w, ln1_b, wqkv, bqkv = ops[:4]
    b, h, w, c = x.shape
    d = c // heads
    qkv = F.layer_norm(x, (c,), ln1_w, ln1_b, 1e-5) @ wqkv + bqkv
    q = window_partition(qkv[..., :c], ws).reshape(-1, ws * ws, heads, d).transpose(1, 2) * d**-0.5
    k, v = qkv[..., c:2 * c].reshape(b, h, w, heads, d), qkv[..., 2 * c:].reshape(b, h, w, heads, d)
    return torch.cat([_kmajor_tiles(q, ws * ws, 16 if d <= 16 else 32), pack_key_images(k, v, ws, overlap)], 1)


def _block_from_images(x, ops, img, heads, ws, overlap):
    """The block with its attention read from ``img`` (``fwd_from_images``,
    d's padding included), then proj, the residual and the MLP."""
    b, h, w, c = x.shape
    owin, _ = overlap_window(ws, overlap)
    wproj, bproj, bias, ln2_w, ln2_b, w1, b1, w2, b2 = ops[4:]
    bw = img.shape[0] // heads
    att = fwd_from_images(img, bias, bw, heads, ws * ws, owin * owin, c // heads)
    y = x + window_reverse(att.transpose(1, 2).reshape(-1, ws, ws, c) @ wproj, ws, h, w) + bproj
    return y + F.gelu(F.layer_norm(y, (c,), ln2_w, ln2_b, 1e-5) @ w1 + b1) @ w2 + b2


@pytest.mark.parametrize("ws,overlap,shape,c,heads,ref", [
    (16, 0.5, (1, 32, 48), 24, 2, "pallas"),  # every window's key window reaches off the image
    (8, 1.0, (2, 16, 24), 24, 3, "pallas"),
    (16, 0.5, (2, 32, 32), 32, 2, "xla"),
    (8, 0.5, (1, 16, 24), 32, 2, "xla"),  # 144 keys: the Pallas kernel declines owin 12
    (8, 1.0, (1, 16, 16), 16, 2, "xla"),
])
def test_b10_block_from_its_images_matches_jax(ws, overlap, shape, c, heads, ref):
    """The block read back from the images the H100 kernels read, and the
    CPU wrapper on the packed blob, against the Pallas ``fused_ocab_block``
    in interpret mode where it takes the geometry, else the JAX package's
    XLA ``_ocab`` (both on the gathered rel-pos bias of one table)."""
    rng = np.random.default_rng(ws + c + shape[0])
    owin, _ = overlap_window(ws, overlap)
    ops = _block_ops(rng, c, heads, ws, owin, 2 * c)
    table = _f(rng, (ws + owin - 1) ** 2, heads, scale=0.5)
    ops[6] = gather_rel_bias(_t(table), relative_position_index_oca(ws, overlap), heads).numpy()
    x = _f(rng, *shape, c)
    if ref == "pallas":
        want = jax_fused_ocab_block(jnp.asarray(x), *[jnp.asarray(a) for a in ops], heads=heads, ws=ws,
                                    overlap_ratio=overlap, interpret=True)
        assert want is not None
    else:
        p = {"norm1": {"scale": ops[0], "bias": ops[1]}, "qkv": {"kernel": ops[2], "bias": ops[3]},
             "proj": {"kernel": ops[4], "bias": ops[5]}, "relative_position_bias_table": table,
             "norm2": {"scale": ops[7], "bias": ops[8]},
             "mlp": {"fc1": {"kernel": ops[9], "bias": ops[10]}, "fc2": {"kernel": ops[11], "bias": ops[12]}}}
        want = jax_ocab(jnp.asarray(x), p, heads, ws, overlap)
    want = np.asarray(want)
    tops = [_t(a) for a in ops]
    img = _images(_t(x), tops, heads, ws, overlap)
    np.testing.assert_allclose(_block_from_images(_t(x), tops, img, heads, ws, overlap).numpy(), want, atol=ATOL,
                               rtol=RTOL)
    served = list(tops)
    served[2], served[4], served[9], served[11] = pack_ocab_block(tops[2], tops[4], tops[9], tops[11], heads), None, \
        None, None
    engagement.reset()
    got = fused_ocab_block(_t(x), *served, heads=heads, window_size=ws, overlap_ratio=overlap)
    assert engagement.counters() == {}  # CPU tensors take the plain version
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_b10_block_from_images_sees_a_misplaced_element():
    """The read-back is no identity: swapping a key row of a v chunk with a
    zero row (a key off the image) changes the block."""
    rng = np.random.default_rng(3)
    c, heads, ws, overlap = 16, 1, 8, 0.5
    ops = [_t(a) for a in _block_ops(rng, c, heads, ws, 12, 2 * c)]
    x = _t(_f(rng, 1, 8, 8, c))
    img = _images(x, ops, heads, ws, overlap)
    good = _block_from_images(x, ops, img, heads, ws, overlap)
    kt, dp = 3, 16
    v0 = (1 + kt) * 64 * dp  # v's chunk 0 after the q tile and the k chunks
    keys = [16 * ((p % 8) // 2) + 2 * (p // 8) + p % 2 for p in range(64)]
    off = [keys.index(0), keys.index(12 * 2 + 2)]  # key 0 (off the image), key (2, 2) (in it)
    a, b = (v0 + (p // 8) * 64 + p % 8 for p in off)  # column 0 of each
    assert img[0, a] == 0 and img[0, b] != 0
    img[0, [a, b]] = img[0, [b, a]].clone()
    assert not torch.allclose(_block_from_images(x, ops, img, heads, ws, overlap), good)


# -- the packed blob -------------------------------------------------------------------------------


@pytest.mark.parametrize("c,heads,hidden", [(180, 6, 360), (32, 2, 64), (24, 3, 48)])
def test_b10_blob_is_b5_then_b6_layout_and_unpacks_bitwise(c, heads, hidden):
    """The blob holds B5's packed q|k|v and proj (``pack_window_attention``
    without its bias), then B6's packed fc1 and fc2 (``pack_mlp_block``), in
    bf16; unpacking gives the weights back bit for bit."""
    rng = np.random.default_rng(c + hidden)
    w = [_t(_f(rng, *s)).to(torch.bfloat16) for s in ((c, 3 * c), (c, c), (c, hidden), (hidden, c))]
    blob = pack_ocab_block(*w, heads)
    n = blob.numel() - pack_mlp_block(w[2], w[3]).numel()
    assert blob.dtype == torch.bfloat16 and blob.numel() == packed_ocab_elems(c, heads, hidden)
    b5 = pack_window_attention(w[0], w[1], torch.zeros(heads, 64, 64), heads)
    assert torch.equal(blob[:n], b5[:n]) and torch.equal(blob[n:], pack_mlp_block(w[2], w[3]))
    for got, want in zip(unpack_ocab_block(blob, c, heads, hidden), w):
        assert torch.equal(got, want)


def test_b10_unpack_rejects_a_blob_that_does_not_fit():
    blob = pack_ocab_block(torch.zeros(32, 96), torch.zeros(32, 32), torch.zeros(32, 64), torch.zeros(64, 32), 2)
    with pytest.raises(ValueError, match="do not fit"):
        unpack_ocab_block(blob, 32, 2, 128)
    with pytest.raises(ValueError, match="do not fit"):
        unpack_ocab_block(blob.float(), 32, 2, 64)


# -- serving's load-time layout ---------------------------------------------------------------------


def _pair(ws, **kw):
    """A JAX HAT and the port's, every parameter rounded to bf16 on both
    sides, so that weights prepared in bf16 hold the model exactly."""
    config = dict(scale=4, embed_dim=32, depths=[2], num_heads=[2], window_size=ws, **kw)
    jax_model = JaxHAT.build(**config, fast_init=True)
    jax_model.variables = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16).astype(a.dtype), jax_model.variables)
    model = HAT.build(**config, device="cpu")
    load_jax_params(model.module, jax_model.variables["params"])
    return jax_model, model


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prepare_hat_serving_packs_b10_in_bf16_only(dtype):
    """bf16 serving packs the OCAB's q|k|v, proj, fc1 and fc2 into one blob
    at load time for the H100 kernels; f32 keeps them dense, the layout of
    ocab.cu. The bias comes in the map's dtype."""
    model = HAT.build(scale=4, embed_dim=32, depths=[1], num_heads=[2], window_size=8, device="cpu")
    ocab = prepare_hat_serving(model.module, model.config, dtype)["ocab"][0]
    oa = model.module.layers[0].residual_group.overlap_attn
    dense = [m.weight.detach().t().to(dtype) for m in (oa.qkv, oa.proj, oa.mlp.fc1, oa.mlp.fc2)]
    assert list(ocab) == ["ln1_w", "ln1_b", "wqkv", "bqkv", "wproj", "bproj", "bias", "ln2_w", "ln2_b", "w1", "b1",
                          "w2", "b2"]
    assert ocab["bias"].dtype == dtype and tuple(ocab["bias"].shape) == (2, 64, 144)
    if dtype == torch.bfloat16:
        assert ocab["wproj"] is None and ocab["w1"] is None and ocab["w2"] is None
        for got, want in zip(unpack_ocab_block(ocab["wqkv"], 32, 2, 64), dense):
            assert torch.equal(got, want)
    else:
        for got, want in zip((ocab["wqkv"], ocab["wproj"], ocab["w1"], ocab["w2"]), dense):
            assert torch.equal(got, want)


@pytest.mark.parametrize("ws", [16, 8])
def test_bf16_serving_oca_bias_is_the_jax_packages_bitwise(ws):
    """The gathered OCA bias bf16 serving hands B10 is the JAX package's
    ``prepare_ocab_weights(...)["bias"]`` (``prepare_hat_serving`` in bf16),
    bit for bit, from f32 tables that bf16 does not hold exactly."""
    config = dict(scale=4, embed_dim=32, depths=[1], num_heads=[2], window_size=ws)
    jax_model = JaxHAT.build(**config, fast_init=True)
    rng = np.random.default_rng(ws)
    jax_model.variables = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(_f(rng, *a.shape)) if "relative_position_bias_table" in jax.tree_util.keystr(path)
        else a, jax_model.variables)
    model = HAT.build(**config, device="cpu")
    load_jax_params(model.module, jax_model.variables["params"])
    want = jax_prepare_hat_serving(jax_model.variables, jax_model.config, jnp.bfloat16)["ocab"]["0"]["bias"]
    got = prepare_hat_serving(model.module, model.config, torch.bfloat16)["ocab"][0]["bias"]
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    table = model.module.layers[0].residual_group.overlap_attn.relative_position_bias_table
    assert not torch.equal(got.float(), gather_rel_bias(table.detach(), relative_position_index_oca(ws, 0.5), 2))


def test_fast_forward_on_bf16_prepared_weights_matches_jax():
    """The whole served HAT on the weights as bf16 serving lays them out
    (B10's blob and bf16 bias among them), through the plain versions in
    f32, against the JAX model on the same bf16-rounded weights, at the f32
    tolerance."""
    jax_model, model = _pair(16)
    x = np.random.default_rng(4).standard_normal((1, 32, 32, 3), dtype=np.float32)
    want = np.asarray(jax_model(jnp.asarray(x)))
    prep = prepare_hat_serving(model.module, model.config, torch.bfloat16)
    assert prep["ocab"][0]["wproj"] is None  # B10 packed
    engagement.reset()
    with torch.inference_mode():
        got = hat_fast_forward(model.module, torch.from_numpy(x), model.config, prep=prep)
    assert engagement.counters() == {}
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


# -- the wrapper's routing ------------------------------------------------------------------------


class _FakeLibrary:
    """Stands in for the built kernel libraries: records the C entries the
    wrapper calls and answers the packed layout's size as the built library
    does; every launch returns status 0 (and computes nothing)."""

    def __init__(self):
        self.calls = []

    def ocab_mma_pack_elems(self, c, heads, hidden):
        return packed_ocab_elems(c, heads, hidden)

    def ocab_mma_f32_pack_elems(self, c, heads, ws, pad, hidden):
        from studiosr_tpu_torch.ops.cuda.window_attention import _f32_fwd_pack_index

        return _f32_fwd_pack_index(c, heads).size

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.mark.parametrize("dtype,c,heads,ws,overlap,hidden,packed,entry", [
    (torch.bfloat16, 180, 6, 16, 0.5, 360, True, "ocab_mma_bf16"),  # HAT serving: the blob packed at load time
    (torch.bfloat16, 180, 6, 16, 0.5, 360, False, "ocab_mma_bf16"),  # dense weights, packed per call
    (torch.bfloat16, 32, 2, 8, 0.5, 64, False, "ocab_mma_bf16"),  # the trained fixtures: 144 keys
    (torch.bfloat16, 24, 3, 8, 1.0, 48, True, "ocab_mma_bf16"),
    (torch.bfloat16, 96, 2, 16, 0.5, 192, False, "ocab_bf16"),  # head dim 48: the older kernel, by rule
    (torch.bfloat16, 30, 2, 16, 0.5, 60, False, "ocab_bf16"),  # C not a multiple of 4
    (torch.bfloat16, 180, 6, 16, 0.5, 720, False, "ocab_bf16"),  # hidden above 384
    (torch.bfloat16, 32, 2, 16, 1.0, 64, False, "ocab_mma_bf16"),  # 32 x 32 keys: the streaming attention pass
    (torch.float32, 180, 6, 16, 0.5, 360, False, "ocab_mma_f32"),  # HAT's f32 serving: the 3xTF32 kernels
])
def test_fused_ocab_block_routes_by_dtype_and_geometry(monkeypatch, dtype, c, heads, ws, overlap, hidden, packed,
                                                       entry):
    """bf16 where ``ocab_mma_takes`` the geometry, and f32 where
    ``ocab_f32_mma_takes`` it, go to the kernels written for the H100 with
    the map's geometry and the bias's margin handed on; other bf16
    geometries take ocab.cu; each launch counts under ``fused_ocab_block``
    and its C entry."""
    import studiosr_tpu_torch.ops.cuda.ocab as module
    from studiosr_tpu_torch.ops.cuda import _build

    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda name, signatures, restypes=None: lib)
    monkeypatch.setattr(module, "call", _meta_call)
    engagement.reset()
    owin, pad = overlap_window(ws, overlap)
    f32 = torch.float32
    meta = lambda *s, dt=dtype: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    w = [meta(c, 3 * c), meta(c, c), meta(c, hidden), meta(hidden, c)]
    if packed:
        w = [pack_ocab_block(*w, heads), None, None, None]
    shape = (2, 2 * ws, 3 * ws, c)
    out = fused_ocab_block(meta(*shape), meta(c, dt=f32), meta(c, dt=f32), w[0], meta(3 * c, dt=f32), w[1],
                           meta(c, dt=f32), meta(heads, ws * ws, owin * owin, dt=f32), meta(c, dt=f32),
                           meta(c, dt=f32), w[2], meta(hidden, dt=f32), w[3], meta(c, dt=f32), heads=heads,
                           window_size=ws, overlap_ratio=overlap)
    assert out.shape == shape and out.dtype == dtype
    launches = [(name, args) for name, args in lib.calls if not name.endswith(("_scratch", "_elems"))]
    assert [name for name, _ in launches] == [entry]
    assert launches[0][1][2:10] == (*shape[:3], c, heads, ws, pad, hidden)
    takes = ocab_mma_takes if dtype == torch.bfloat16 else ocab_f32_mma_takes
    assert takes(c, heads, ws, overlap, hidden) == ("mma" in entry)
    assert engagement.entries() == {"fused_ocab_block": {entry: 1}}
    engagement.reset()


def test_fused_ocab_block_raises_on_packed_weights_off_the_h100_route(monkeypatch):
    """The blob is the bf16 H100 kernels' layout: f32 maps raise on it."""
    from studiosr_tpu_torch.ops.cuda import _build

    monkeypatch.setattr(_build, "load", lambda name, signatures, restypes=None: _FakeLibrary())
    meta = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    blob = pack_ocab_block(meta(32, 96), meta(32, 32), meta(32, 64), meta(64, 32), 2)
    with pytest.raises(ValueError, match="packed weights"):
        fused_ocab_block(meta(1, 16, 16, 32), meta(32), meta(32), blob, meta(96), None, meta(32), meta(2, 64, 144),
                         meta(32), meta(32), None, meta(64), None, meta(32), heads=2, window_size=8, overlap_ratio=0.5)
