"""Launch accounting for the port's CUDA kernels.

Port of ``studiosr_tpu/ops/pallas/engagement.py`` without its soft
fallback: on a CUDA tensor a kernel wrapper launches its kernel or raises,
so there is no fallback to count. What remains:

* ``launched(name)`` — each wrapper adds one where it launches its kernel
  (CPU tensors take the plain version and count nothing), under the
  kernel's name: ``fused_swin_block``, ``fused_conv3x3``,
  ``fused_upsample_x4``, ``fused_upsample_s`` (B4, x2 / x3),
  ``fused_window_attention_block`` (``_ws16`` at windows 9-16,
  ``_large`` from 17), ``fused_mlp_block`` (``_extra`` with the CAB join),
  ``mlp_bwd``, ``attention_bwd`` (``_ws16``, ``_large`` alike),
  ``fused_cab_body``,
  ``fused_ocab_block``, ``oca_core_fwd``, ``oca_core_bwd``,
  ``fused_resblock`` (B14), ``window_attention_pallas`` (B15); where a
  wrapper names the C entry it called (every kernel: one for f32,
  one or two for bf16), ``entries()`` counts the launches of each;
* ``structural_decline(name, reason)`` — the by-design decline of a
  configuration that a kernel does not take (the JAX wrapper declines it
  too), recorded and warned about so it is never silent; its uses:
  ``structural_tail_decline(scale)`` (scale 8's log2-ladder tail has no
  fused kernel) and B15 above 1024 tokens a window
  (``window_attn.decline``, MaxSR adaptive on about a megapixel of LR);
* ``counters()`` / ``entries()`` / ``declines()`` / ``reset()``.

The counts take a lock: the mesh routes (``parallel/mesh.py``) launch from
one host thread a slot.
"""

from __future__ import annotations

import collections
import threading
import warnings

__all__ = ["launched", "structural_decline", "structural_tail_decline", "counters", "entries", "declines", "reset"]

_launches: collections.Counter = collections.Counter()
_entries: collections.Counter = collections.Counter()
_declines: dict = {}
_lock = threading.Lock()


def launched(name: str, entry: str = None) -> None:
    with _lock:
        _launches[name] += 1
        if entry is not None:
            _entries[(name, entry)] += 1


def structural_decline(name: str, reason: str) -> None:
    """Record (and warn) that the kernel ``name`` declined a configuration
    by design, for ``reason``; the caller takes the plain route."""
    with _lock:
        entry = _declines.setdefault(name, {"count": 0, "reason": reason})
        entry["count"] += 1
        entry["reason"] = reason
    warnings.warn(f"{name} declined by design: {reason}", stacklevel=3)


def structural_tail_decline(scale: int) -> None:
    """Record that the fused upsample tail has no kernel for ``scale``."""
    structural_decline("fused_upsample_tail", f"scale {scale}: no fused tail (plain log2-ladder path)")


def counters() -> dict:
    """{kernel name: launches since the last reset}."""
    with _lock:
        return dict(_launches)


def entries() -> dict:
    """{kernel name: {C entry: launches}} since the last reset, for the
    wrappers that name their entry."""
    out: dict = {}
    with _lock:
        for (name, entry), n in _entries.items():
            out.setdefault(name, {})[entry] = n
    return out


def declines() -> dict:
    """{name: {"count": n, "reason": last reason}} of structural declines."""
    with _lock:
        return {k: dict(v) for k, v in _declines.items()}


def reset() -> None:
    with _lock:
        _launches.clear()
        _entries.clear()
        _declines.clear()
