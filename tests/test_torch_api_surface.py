"""API audit: every public name of the JAX package has its counterpart in
the port.

Walks the JAX package's public surface (the top level, ``utils``, ``zoo``,
``zoo.translate``, ``engine``, ``data`` and each model class's public
methods and properties) and checks each name in the port, one case a
symbol: the port has the same name, or ``RENAMES`` names the deliberate
difference and where its capability lives (a dotted path in the port or in
PyTorch that must resolve) or why it has no counterpart."""

import importlib
import types

import pytest

import studiosr_tpu.models as jax_models
import studiosr_tpu_torch.models as models

SCOPES = ("", "utils", "zoo", "zoo.translate", "engine", "data")

# JAX name -> (where its capability lives in the port or in PyTorch, or None; why)
RENAMES = {
    "compute_psnr_jax": ("studiosr_tpu_torch.utils.compute_psnr_torch", "the device metric, written in PyTorch"),
    "compute_ssim_jax": ("studiosr_tpu_torch.utils.compute_ssim_torch", "the device metric, written in PyTorch"),
    "enable_compilation_cache": (None, "XLA's persistent compilation cache: the port traces no graphs, and its "
                                       "kernels build once with nvcc into build/kernels (ops/cuda/_build.py)"),
    "get_device": ("studiosr_tpu_torch.resolve_device", "entry points take device=: the card by default, raising "
                                                        "without one, 'cpu' on request"),
    "export_state_dict": ("torch.nn.Module.state_dict", "the port's modules are torch modules under the release's "
                                                        "key names: model.module.state_dict() is the export"),
    # Model methods
    "apply_train": ("studiosr_tpu_torch.parallel.make_train_step", "module.train() and the module's forward with a "
                                                                   "torch.Generator, as the train step applies it"),
    "needs_manual_spmd": ("studiosr_tpu_torch.parallel.mesh.run_sharded",
                          "CUDA kernels need no manual partitioning: every slot runs the single-card path"),
    "params": ("torch.nn.Module.parameters", "model.module.parameters() and model.module.state_dict()"),
    "serving_prep": ("studiosr_tpu_torch.models.base.FusedServingModel.serving_prep",
                     "kept on the families with a fused CUDA serving path"),
    "set_matmul_precision": ("studiosr_tpu_torch.models.base.Model.astype",
                             "f32 is f32 (resolve_device turns TF32 off on the card); astype / half for bf16"),
    "shard_map_batch": ("studiosr_tpu_torch.parallel.mesh.run_sharded",
                        "CUDA kernels need no manual partitioning: every slot runs the single-card path"),
}


def _public(module) -> list:
    names = getattr(module, "__all__", None) or dir(module)
    return sorted(n for n in names if not n.startswith("_") and not isinstance(getattr(module, n), types.ModuleType))


def _module(package: str, scope: str):
    return importlib.import_module(package + (f".{scope}" if scope else ""))


def _resolve(path: str):
    """The object at a dotted path: the longest importable module prefix, then attributes."""
    parts = path.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(path)


MODULE_CASES = [(scope or "top", name) for scope in SCOPES for name in _public(_module("studiosr_tpu", scope))]
CLASS_CASES = [(cls, name) for cls in jax_models.__all__ for name in dir(getattr(jax_models, cls))
               if not name.startswith("_")]


def _check(has_it: bool, name: str) -> None:
    if has_it:
        return
    assert name in RENAMES, f"{name} has no counterpart in the port and no entry in RENAMES"
    target, why = RENAMES[name]
    assert why
    if target is not None:
        assert callable(_resolve(target)), target


@pytest.mark.parametrize("scope,name", MODULE_CASES, ids=[f"{s}.{n}" for s, n in MODULE_CASES])
def test_module_symbol_has_a_port_counterpart(scope, name):
    port = _module("studiosr_tpu_torch", "" if scope == "top" else scope)
    jax_obj = getattr(_module("studiosr_tpu", "" if scope == "top" else scope), name)
    _check(hasattr(port, name), name)
    if hasattr(port, name):
        assert callable(getattr(port, name)) == callable(jax_obj), f"{scope}.{name}: a callable in one package only"


@pytest.mark.parametrize("cls,name", CLASS_CASES, ids=[f"{c}.{n}" for c, n in CLASS_CASES])
def test_model_method_has_a_port_counterpart(cls, name):
    _check(hasattr(getattr(models, cls), name), name)


def test_renames_are_all_needed():
    """Every RENAMES entry names a JAX symbol the port lacks."""
    lacking = {name for scope, name in MODULE_CASES
               if not hasattr(_module("studiosr_tpu_torch", "" if scope == "top" else scope), name)}
    lacking |= {name for cls, name in CLASS_CASES if not hasattr(getattr(models, cls), name)}
    assert lacking == set(RENAMES)
