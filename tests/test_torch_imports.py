"""Import guard of the port: no JAX, flax or msgpack, no cv2 at import time,
and no build at import time.

Scans source with ``ast`` rather than ``sys.modules``, since the test
process imports JAX for the parity tests.
"""

import ast
import importlib
import os
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "studiosr_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "msgpack", "studiosr_tpu")
SOURCES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("torch_*.py"))
WRAPPERS = [
    "studiosr_tpu_torch.ops.cuda.conv3x3",
    "studiosr_tpu_torch.ops.cuda.swin_block",
    "studiosr_tpu_torch.ops.cuda.upsampler",
    "studiosr_tpu_torch.ops.cuda.window_attention",
    "studiosr_tpu_torch.ops.cuda.mlp_block",
    "studiosr_tpu_torch.ops.cuda.mlp_bwd",
    "studiosr_tpu_torch.ops.cuda.attn_bwd",
    "studiosr_tpu_torch.ops.cuda.ocab",
    "studiosr_tpu_torch.ops.cuda.oca_core",
    "studiosr_tpu_torch.ops.oca_vjp",
    "studiosr_tpu_torch.serving.hat_fast",
    "studiosr_tpu_torch.models.hat",
    "studiosr_tpu_torch.models.swinfir",
    "studiosr_tpu_torch.models.maxsr",
    "studiosr_tpu_torch.ops.cuda.window_attn",
    "studiosr_tpu_torch.ops.attn_vjp",
    "studiosr_tpu_torch.ops.mlp_vjp",
    "studiosr_tpu_torch.engine.trainer",
    "studiosr_tpu_torch.engine.evaluator",
    "studiosr_tpu_torch.zoo.registry",
    "studiosr_tpu_torch.zoo.checkpoint",
    "studiosr_tpu_torch.utils.metrics",
    "studiosr_tpu_torch.utils.png",
    "studiosr_tpu_torch.parallel.tiled",
    "studiosr_tpu_torch.__main__",
]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_the_whole_package():
    names = {p.name for p in SOURCES}
    assert {
        "swinir.py", "swinir_fast.py", "swin_block.py", "conv3x3.py", "upsampler.py", "chip_smoke.py",
        "window_attention.py", "mlp_block.py", "mlp_bwd.py", "attn_bwd.py", "attn_vjp.py", "mlp_vjp.py",
        "trainer.py", "train_step.py", "dataset.py", "handler.py", "transforms.py", "losses.py", "helpers.py",
        "hat.py", "hat_fast.py", "ocab.py", "metrics.py", "png.py", "checkpoint.py", "registry.py", "tiled.py",
        "evaluator.py", "__main__.py", "oca_core.py", "oca_vjp.py", "swinfir.py", "maxsr.py", "window_attn.py",
        "torch_train.py",
    } <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_cv2_only_inside_the_functions_that_need_it(path):
    """cv2 (absent on the card's machine) is imported where a non-PNG file
    is read or written, never when a module is imported."""
    tree = ast.parse(path.read_text(), filename=str(path))
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in top if isinstance(n, ast.ImportFrom) and n.module]
    assert "cv2" not in {m.split(".")[0] for m in names}


@pytest.mark.parametrize("module", WRAPPERS)
def test_kernel_wrappers_import_without_building(module):
    from studiosr_tpu_torch.ops.cuda import _build

    importlib.import_module(module)
    assert _build._libs == {}


def test_build_without_nvcc_raises():
    from studiosr_tpu_torch.ops.cuda import _build

    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    if shutil.which("nvcc") or (Path(cuda_home) / "bin" / "nvcc").exists():
        pytest.skip("nvcc is installed here")
    if all(_build._library_path(n).exists() for n in _build.SOURCES):
        pytest.skip("libraries already built")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
