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
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

__all__ = ["load_jax_params", "jax_params_to_state_dict", "jax_variables_to_state_dict", "drop_recomputed"]

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
    (flat mapping of arrays). Returns ``module``."""
    if _is_variables(params):
        state = jax_variables_to_state_dict(params)
    elif any(isinstance(v, Mapping) for v in params.values()):
        state = jax_params_to_state_dict(params)
    else:
        state = dict(params)
    state = drop_recomputed(state)
    target = {k: t for k, t in module.state_dict().items() if not k.endswith(_UNTRACKED)}
    missing = sorted(set(target) - set(state))
    unknown = sorted(set(state) - set(target))
    if missing or unknown:
        raise KeyError(f"parameter mismatch: missing {missing[:10]}, unknown {unknown[:10]}")
    with torch.no_grad():
        for key, tensor in target.items():
            source = torch.as_tensor(np.array(state[key]))
            if tuple(source.shape) != tuple(tensor.shape):
                raise ValueError(f"shape mismatch for {key}: source {tuple(source.shape)} vs {tuple(tensor.shape)}")
            tensor.copy_(source.to(tensor.dtype))
    return module
