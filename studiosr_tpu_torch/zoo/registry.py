"""Model registry and checkpoint reconstruction.

Port of ``studiosr_tpu/zoo/registry.py``. A Trainer writes ``params.json``
(the model config) beside each checkpoint; ``load_model(ckpt_dir, name)``
rebuilds the model from it and restores ``{tag}.model.ckpt``, in either of
two formats, told apart by their leading bytes:

* the JAX package's Trainer: flax msgpack of the variables tree, read by
  ``zoo/checkpoint.py`` (no flax, no msgpack) and mapped onto the port's
  module by ``zoo/translate.py``;
* the port's Trainer: a ``torch.save`` state_dict (a zip archive).

``ema=True`` serves the EMA shadow weights of ``{tag}.ema.ckpt`` in place of
the raw ones. Every leaf's shape is checked against the model before
anything is copied, so a checkpoint whose ``params.json`` was edited fails
loudly, naming the file and the leaf.

A flax file's ``batch_stats`` (BatchNorm running statistics, MaxSR's
MBConvs) come back as ``running_mean`` / ``running_var``; a BatchNorm's
``num_batches_tracked``, which the JAX state has no counterpart of, keeps
the module's value.

The registry holds the names of the JAX package's twelve models; the port
builds SwinIR, HAT, SwinFIR and MaxSR, and the others raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import io
import json
import os
from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

from studiosr_tpu_torch.utils.helpers import check_state_shapes
from studiosr_tpu_torch.zoo.checkpoint import msgpack_restore
from studiosr_tpu_torch.zoo.translate import drop_recomputed, jax_params_to_state_dict, jax_variables_to_state_dict

__all__ = ["MODEL_REGISTRY", "get_model_class", "load_model", "read_checkpoint"]

_NOT_PORTED = {name: "A16" for name in ("srcnn", "espcn", "vdsr", "srresnet", "edsr", "rcan", "han", "imdn")}
_TORCH_ZIP = b"PK\x03\x04"


def _registry() -> Dict[str, Any]:
    from studiosr_tpu_torch import models

    return {
        "swinir": models.SwinIR, "hat": models.HAT, "swinfir": models.SwinFIR, "maxsr": models.MaxSR,
        **{name: None for name in _NOT_PORTED},
    }


class _LazyRegistry(Mapping):
    """Dict-like view over the model registry (built lazily: importing the
    models package here would be circular). Names not ported yet map to
    None; :func:`get_model_class` raises for them."""

    def __getitem__(self, name: str):
        reg = _registry()
        try:
            return reg[name.lower()]
        except KeyError:
            raise KeyError(f"unknown model {name!r}; available: {sorted(reg)}") from None

    def __iter__(self):
        return iter(_registry())

    def __len__(self) -> int:
        return len(_registry())


MODEL_REGISTRY = _LazyRegistry()


def get_model_class(name: str):
    cls = MODEL_REGISTRY[name]
    if cls is None:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet (ROADMAP {_NOT_PORTED[name.lower()]}); "
            "the port builds swinir, hat, swinfir and maxsr"
        )
    return cls


def read_checkpoint(path: str, params_only: bool = False) -> Dict[str, Any]:
    """A checkpoint file -> a torch-named state_dict of numpy arrays or
    tensors. A flax msgpack file holds the variables tree (``params`` and
    maybe ``batch_stats``, both kept), or with ``params_only`` (an EMA file)
    the params tree itself; a ``torch.save`` file holds the state_dict."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == _TORCH_ZIP:
        return dict(torch.load(io.BytesIO(data), map_location="cpu", weights_only=True))
    tree = msgpack_restore(data)
    if not isinstance(tree, dict) or not (params_only or "params" in tree):
        raise ValueError(f"{path}: not a checkpoint of a variables tree")
    return drop_recomputed(jax_params_to_state_dict(tree) if params_only else jax_variables_to_state_dict(tree))


def _restore(module: torch.nn.Module, state: Dict[str, Any], path: str, params_only: bool) -> None:
    target = dict(module.named_parameters()) if params_only else module.state_dict()
    target = {k: t for k, t in target.items() if k in state or not k.endswith("num_batches_tracked")}
    check_state_shapes(state, target, context=path)
    with torch.no_grad():
        for key, tensor in target.items():
            source = state[key]
            source = torch.from_numpy(np.array(source)) if isinstance(source, np.ndarray) else source
            tensor.copy_(source.to(tensor.dtype))


def load_model(ckpt_dir: str, model_name: str, tag: str = "best", ema: bool = False, device=None):
    """Rebuild a model from ``{ckpt_dir}/params.json`` + ``{tag}.model.ckpt``
    (a JAX or a port checkpoint) on ``device`` (default ``cuda``). ``ema``
    takes the weights of ``{tag}.ema.ckpt`` instead."""
    with open(os.path.join(ckpt_dir, "params.json")) as f:
        config = json.load(f)
    model = get_model_class(model_name).build(**config, device=device)
    module = model.module
    path = os.path.join(ckpt_dir, f"{tag}.model.ckpt")
    _restore(module, read_checkpoint(path), path, params_only=False)
    if ema:
        ema_path = os.path.join(ckpt_dir, f"{tag}.ema.ckpt")
        _restore(module, read_checkpoint(ema_path, params_only=True), ema_path, params_only=True)
    return model
