"""Launch accounting for the port's CUDA kernels.

Port of ``studiosr_tpu/ops/pallas/engagement.py`` without its soft
fallback: on a CUDA tensor a kernel wrapper launches its kernel or raises,
so there is no fallback to count. What remains:

* ``launched(name)`` — each wrapper adds one where it launches its kernel
  (CPU tensors take the plain version and count nothing), under the
  kernel's name: ``fused_swin_block``, ``fused_conv3x3``,
  ``fused_upsample_x4``, ``fused_upsample_s`` (B4, x2 / x3),
  ``fused_window_attention_block`` (``_ws16`` at window 16),
  ``fused_mlp_block`` (``_extra`` with the CAB join), ``mlp_bwd``,
  ``attention_bwd`` (``_ws16`` at window 16), ``fused_cab_body``,
  ``fused_ocab_block``, ``oca_core_fwd``, ``oca_core_bwd``,
  ``fused_resblock`` (B14), ``window_attention_pallas`` (B15); where a
  wrapper names the C entry it called (B1-B9, B13-B15: one for f32, one or
  two for bf16), ``entries()`` counts the launches of each;
* ``structural_tail_decline(scale)`` — the by-design decline of a
  configuration that has no kernel at all (scale 8's log2-ladder tail),
  recorded and warned about so it is never silent;
* ``counters()`` / ``entries()`` / ``declines()`` / ``reset()``.
"""

from __future__ import annotations

import collections
import warnings

__all__ = ["launched", "structural_tail_decline", "counters", "entries", "declines", "reset"]

_launches: collections.Counter = collections.Counter()
_entries: collections.Counter = collections.Counter()
_declines: dict = {}


def launched(name: str, entry: str = None) -> None:
    _launches[name] += 1
    if entry is not None:
        _entries[(name, entry)] += 1


def structural_tail_decline(scale: int) -> None:
    """Record that the fused upsample tail has no kernel for ``scale``."""
    reason = f"scale {scale}: no fused tail (plain log2-ladder path)"
    entry = _declines.setdefault("fused_upsample_tail", {"count": 0, "reason": reason})
    entry["count"] += 1
    entry["reason"] = reason
    warnings.warn(f"fused_upsample_tail declined by design: {reason}", stacklevel=2)


def counters() -> dict:
    """{kernel name: launches since the last reset}."""
    return dict(_launches)


def entries() -> dict:
    """{kernel name: {C entry: launches}} since the last reset, for the
    wrappers that name their entry."""
    out: dict = {}
    for (name, entry), n in _entries.items():
        out.setdefault(name, {})[entry] = n
    return out


def declines() -> dict:
    """{name: {"count": n, "reason": last reason}} of structural declines."""
    return {k: dict(v) for k, v in _declines.items()}


def reset() -> None:
    _launches.clear()
    _entries.clear()
    _declines.clear()
