"""Build the CUDA kernels under ``csrc/`` on first use and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/kernels/<name>-<hash>.so`` at the
root of the checkout (git-ignored). The hash covers the source, the shared
``csrc/*.cuh`` headers and the flags, so an edit rebuilds. Libraries are
loaded with ``ctypes``; pointers and the stream go as ``ctypes.c_void_p``,
and each C entry returns ``cudaGetLastError()`` (0 on success).

Nothing here runs at import time: the CPU tests import every wrapper module
on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Sequence

__all__ = ["SOURCES", "build", "load", "build_log"]

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
SOURCES = (
    "conv3x3", "swin_block", "upsampler", "window_attention", "mlp_block", "mlp_bwd", "attn_bwd", "cab_body",
    "window_attention16", "ocab", "attn_bwd16", "oca_core", "resblock", "window_attn", "swin_block_mma", "attn_bwd_mma",
    "window_attention_mma", "mlp_bwd_mma", "mlp_block_mma", "oca_bwd_mma", "cab_mma", "oca_fwd_mma", "ocab_mma",
    "attn_bwd_f32", "mlp_bwd_f32", "window_attention_f32", "mlp_block_f32", "swin_block_f32", "oca_bwd_f32",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the CUDA kernels")
    return found


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every library of ``names`` that is missing, one ``nvcc`` per
    source, all started together. Returns the wall seconds taken."""
    start = time.perf_counter()
    missing = [(name, _library_path(name)) for name in names if not _library_path(name).exists()]
    if missing:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, out in missing:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(out.with_suffix(".log"), "w") as log:
            jobs.append((name, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out))
    errors = []
    for name, proc, tmp, out in jobs:
        if proc.wait() != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{out.with_suffix('.log').read_text()}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - start


def load(name: str, signatures: Dict[str, Sequence], restypes: Optional[Dict[str, Any]] = None) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed, with each entry of
    ``signatures`` ({function: argtypes}) typed to return ``c_int``, or the
    type ``restypes`` gives it (``None`` for ``void``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = (restypes or {}).get(fn, ctypes.c_int)
            _libs[name] = lib
        return lib


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)."""
    return _library_path(name).with_suffix(".log").read_text()
