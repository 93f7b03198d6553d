"""C6 on the CPU: MaxSR's fused attention routes around B15 above 1024
tokens a window, a recorded structural decline, as the JAX wrapper
declines it (``studiosr_tpu/ops/pallas/window_attn.py:139-140``).

The routing is the device-independent part: ``window_attn.takes`` decides,
and a stand-in for the kernel wrapper that raises (as the CUDA launch would
above 1024 tokens) shows it is never called for a window it does not take.
No 1025² image is allocated here; the card test serves one.
"""

import warnings

import pytest
import torch

from studiosr_tpu_torch import MaxSR
from studiosr_tpu_torch.ops import attention as attention_mod
from studiosr_tpu_torch.ops.attention import attention_plain
from studiosr_tpu_torch.ops.cuda import engagement, window_attn

torch.set_num_threads(2)


@pytest.mark.parametrize("n,m,d,taken", [(1024, 1024, 32, True), (1025, 1025, 32, False), (1024, 1089, 32, False),
                                         (64, 64, 64, True), (64, 64, 65, False)])
def test_b15_takes_at_most_1024_tokens_and_head_dim_64(n, m, d, taken):
    assert window_attn.takes(n, m, d) is taken


def _fused_attention(monkeypatch):
    """The first attention core of a one-trio MaxSR adaptive (dim 32, one
    head), fused on, with the kernel wrapper replaced by a recorder that
    refuses the shapes the CUDA kernel refuses."""
    model = MaxSR.build(scale=4, adaptive=True, dim=32, dim_head=32, depth=[1], device="cpu").enable_fused(True)
    calls = []

    def kernel(q, k, v, bias=None, mask=None):
        calls.append(q.shape[2])
        if not window_attn.takes(q.shape[2], k.shape[2], q.shape[3]):
            raise NotImplementedError("the kernel takes N, M <= 1024")
        return attention_plain(q, k, v, bias, mask)

    monkeypatch.setattr(window_attn, "window_attention", kernel)
    return model.module._attention_modules()[0], calls


@pytest.mark.parametrize("tokens", [1024, 1025, 1089])
def test_maxsr_fused_attention_declines_above_1024_tokens(tokens, monkeypatch):
    attn, calls = _fused_attention(monkeypatch)
    x = torch.randn(2, tokens, 32, generator=torch.Generator().manual_seed(tokens))
    engagement.reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = attn(x)
    attn.fused = False
    want = attn(x)
    declined = tokens > 1024
    assert calls == ([] if declined else [tokens])
    assert torch.equal(got, want)  # the same plain core either way on the CPU
    if declined:
        entry = engagement.declines()["window_attention_pallas"]
        assert entry["count"] == 1 and f"N {tokens}" in entry["reason"]
        assert any("declined by design" in str(w.message) for w in caught)
    else:
        assert engagement.declines() == {}


def test_maxsr_adaptive_forward_records_one_decline_per_attention_call(monkeypatch):
    """The module's own window rule: a 31 x 33 LR map gives windows of 6 x 6
    (36 tokens, taken) through the kernel; a monkeypatched cap of 35 tokens
    makes both attention calls of the trio decline, the output unchanged."""
    attn, calls = _fused_attention(monkeypatch)
    model = MaxSR.build(scale=4, adaptive=True, dim=32, dim_head=32, depth=[1], device="cpu").enable_fused(True)
    x = torch.rand(1, 31, 33, 3, generator=torch.Generator().manual_seed(0))
    engagement.reset()
    with torch.no_grad():
        taken = model.module(x)
    assert calls == [36, 36] and engagement.declines() == {}
    monkeypatch.setattr(window_attn, "MAX_TOKENS", 35)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with torch.no_grad():
            declined = model.module(x)
    assert calls == [36, 36] and engagement.declines()["window_attention_pallas"]["count"] == 2
    assert torch.equal(taken, declined)


def test_attention_core_pallas_backend_declines_too(monkeypatch):
    _, calls = _fused_attention(monkeypatch)
    q = torch.randn(1, 1, 1025, 8)
    monkeypatch.setattr(attention_mod, "_BACKEND", "pallas")
    engagement.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = attention_mod.attention_core(q, q, q)
    assert calls == [] and engagement.declines()["window_attention_pallas"]["count"] == 1
    assert torch.equal(got, attention_plain(q, q, q))
    small = torch.randn(1, 1, 64, 8)
    attention_mod.attention_core(small, small, small)
    assert calls == [64]
