"""Weight bridge: JAX package parameters -> the port's PyTorch modules.

The port names its modules like the flax paths, and the flax paths equal the
reference torch key prefixes (``studiosr_tpu/zoo/translate.py``). A JAX
params tree therefore maps onto ``module.state_dict()`` by name:

* conv ``kernel`` (kH, kW, I, O) -> ``weight`` (O, I, kH, kW);
* 3-D conv ``kernel`` (kD, kH, kW, I, O) -> ``weight`` (O, I, kD, kH, kW)
  (HAN's CSAM, ``studiosr_tpu/zoo/translate.py:214-215``);
* dense ``kernel`` (I, O) -> ``nn.Linear.weight`` (O, I);
* LayerNorm / BatchNorm ``scale`` -> ``weight``; PReLU ``alpha`` ->
  ``weight``; ``bias`` -> ``bias``;
* ``nn.Embed``'s ``embedding`` -> ``nn.Embedding.weight`` as it is;
* the ``batch_stats`` collection's ``mean`` / ``var`` -> ``running_mean`` /
  ``running_var`` (``studiosr_tpu/zoo/translate.py:152-153``);
* other leaves (``relative_position_bias_table``) keep their names.

A variables tree (``{"params": ..., "batch_stats": ...}``) maps both
collections; a BatchNorm's ``num_batches_tracked`` is not part of the JAX
state and keeps the module's own value.

The torch-convention state_dict that the JAX package's ``export_state_dict``
emits is accepted as well, by key name. Buffers recomputed here
(``relative_position_index``, ``attn_mask``) and the frozen MeanShift convs
are dropped, as the JAX package drops them. Unknown or missing keys and
shape mismatches raise.

The published torch checkpoints (the zoo of ``from_pretrained``) take
another route, ported from ``studiosr_tpu/zoo/translate.py``:
:func:`load_torch_state_dict` reads a release file and unwraps its wrapper
key and ``module.`` prefixes, and :func:`translate_state_dict` fills a
module by key name with shape checks, reporting what it matched, what the
module missed, what it dropped (the recomputed buffers and MeanShift convs)
and what it never used (:class:`TranslationReport`). Missing keys raise
only under ``strict``; extra keys never do, as in the reference's
``strict=False`` loads.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

__all__ = [
    "load_jax_params", "jax_params_to_state_dict", "jax_variables_to_state_dict", "drop_recomputed",
    "load_torch_state_dict", "translate_state_dict", "TranslationReport",
]

_DROPPED_SUFFIXES = (
    "relative_position_index",
    "relative_position_index_SA",
    "relative_position_index_OCA",
    "rel_pos_indices",
    "num_batches_tracked",
    "attn_mask",
)
_DROPPED_PREFIXES = ("sub_mean", "add_mean", "normalizer")
_LEAF_TO_TORCH = {
    "kernel": "weight", "scale": "weight", "embedding": "weight", "alpha": "weight", "bias": "bias",
    "mean": "running_mean", "var": "running_var",
}
_UNTRACKED = "num_batches_tracked"


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def jax_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flax ``variables["params"]`` (nested dicts of arrays) -> torch-named,
    torch-laid-out numpy state_dict."""
    state: Dict[str, np.ndarray] = {}
    for path, value in _flatten(params):
        prefix, _, leaf = path.rpartition(".")
        arr = np.asarray(value)
        if leaf == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 5:
                arr = arr.transpose(4, 3, 0, 1, 2)
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"{path}: unsupported kernel rank {arr.ndim}")
        name = _LEAF_TO_TORCH.get(leaf, leaf)
        state[f"{prefix}.{name}" if prefix else name] = arr
    return state


def jax_variables_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A flax variables tree -> one torch-named state_dict of its ``params``
    and, where it has them, its ``batch_stats`` (running statistics)."""
    state = jax_params_to_state_dict(variables["params"])
    state.update(jax_params_to_state_dict(variables.get("batch_stats", {})))
    return state


def _is_variables(tree: Mapping[str, Any]) -> bool:
    return isinstance(tree.get("params"), Mapping)


def drop_recomputed(state: Mapping[str, Any]) -> Dict[str, Any]:
    """``state`` without the buffers the port recomputes and the frozen
    MeanShift convs."""
    return {k: v for k, v in state.items() if not (k.endswith(_DROPPED_SUFFIXES) or k.startswith(_DROPPED_PREFIXES))}


def load_jax_params(module: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Fill ``module`` in place from a JAX params tree, a variables tree
    (params and batch_stats) or an exported torch-convention state_dict
    (flat mapping of arrays), all or nothing: an unknown key (past the
    recomputed buffers), a missing one or a misshapen one raises before
    anything is written. Returns ``module``."""
    if _is_variables(params):
        state = jax_variables_to_state_dict(params)
    elif any(isinstance(v, Mapping) for v in params.values()):
        state = jax_params_to_state_dict(params)
    else:
        state = dict(params)
    state = drop_recomputed(state)
    unknown = sorted(set(state) - set(module.state_dict()))
    if unknown:
        raise KeyError(f"parameter mismatch: unknown {unknown[:10]}")
    translate_state_dict(state, module, strict=True)  # a missing key raises before anything is written
    return module


def load_torch_state_dict(path: str, key: Optional[str] = "auto", allow_pickle: bool = False) -> Dict[str, torch.Tensor]:
    """A torch checkpoint's state_dict as CPU tensors, its zoo wrapper
    unwrapped: ``key="auto"`` takes ``params_ema``, then ``params``, then
    ``state_dict`` where present (SwinIR's ``params``, HAT's
    ``params_ema``); an explicit ``key`` the file lacks raises ``KeyError``
    naming its top-level keys; ``None`` takes the file as it is. ``module.``
    (DataParallel) prefixes are stripped (IMDN's releases).

    Reads with ``weights_only=True``: a plain state_dict needs no pickled
    code, and a downloaded file should run none. ``allow_pickle=True`` opts
    into full unpickling where the restricted read fails."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        if not allow_pickle:
            raise
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        if key == "auto":
            for candidate in ("params_ema", "params", "state_dict"):
                if isinstance(obj.get(candidate), dict):
                    obj = obj[candidate]
                    break
        elif key is not None:
            if key not in obj:
                raise KeyError(f"checkpoint {path} has no {key!r} entry; top-level keys: {sorted(obj)[:10]}")
            obj = obj[key]
    state = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        state[k] = v.detach().cpu() if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
    return state


@dataclass
class TranslationReport:
    """What :func:`translate_state_dict` did with a checkpoint's keys."""

    matched: List[str] = field(default_factory=list)
    missing: List[str] = field(default_factory=list)  # module entries with no source key
    unused: List[str] = field(default_factory=list)  # source keys never consumed
    dropped: List[str] = field(default_factory=list)  # source keys dropped on purpose (recomputed here)

    def raise_if_missing(self) -> None:
        if self.missing:
            raise KeyError(f"untranslated target parameters: {self.missing[:20]} "
                           f"(+{max(0, len(self.missing) - 20)} more)")


def translate_state_dict(state: Mapping[str, Any], module: nn.Module, strict: bool = True) -> TranslationReport:
    """Fill ``module`` in place from a torch-convention ``state`` (what
    :func:`load_torch_state_dict` returns) by key name. A key whose shape
    differs raises ``ValueError``. The recomputed buffers and the MeanShift
    convs are ``dropped``, other extra keys ``unused``; neither is fatal.
    Module entries with no source are ``missing`` and keep their values;
    under ``strict`` they raise ``KeyError`` before anything is written. A
    BatchNorm's ``num_batches_tracked`` keeps the module's own value."""
    report = TranslationReport()
    target = {k: t for k, t in module.state_dict().items() if not k.endswith(_UNTRACKED)}
    pairs = []
    for key, tensor in target.items():
        if key not in state:
            report.missing.append(key)
            continue
        source = state[key] if torch.is_tensor(state[key]) else torch.as_tensor(np.array(state[key]))
        if tuple(source.shape) != tuple(tensor.shape):
            raise ValueError(f"shape mismatch for {key}: source {tuple(source.shape)} vs {tuple(tensor.shape)}")
        pairs.append((tensor, source))
        report.matched.append(key)
    for key in state:
        if key not in target:
            recomputed = key.endswith(_DROPPED_SUFFIXES) or key.startswith(_DROPPED_PREFIXES)
            (report.dropped if recomputed else report.unused).append(key)
    if strict:
        report.raise_if_missing()
    with torch.no_grad():
        for tensor, source in pairs:
            tensor.copy_(source.to(tensor.dtype))
    return report
