"""The port's host library: crop + augment and PNG unfiltering in C++.

Port of ``studiosr_tpu/native/`` with its own sources: ``augment.cpp`` (the
JAX package's one-pass crop, flip, rot90 and normalize, dividing by 255
as numpy does) and
``png_unfilter.cpp`` (the PNG row filters for ``utils/png.py``). Both build
into one shared library with ``g++ -O3 -shared -fPIC`` at first use, from
the checkout's sources only, into the git-ignored ``build/native/`` beside
``build/kernels/``. The library's name carries a hash of the sources, the
flags and the machine type, so an edit rebuilds.

Several processes (xdist workers, the data threads of several trainers) may
ask for it at once: the build holds an ``fcntl.flock`` on
``build/native/build.lock``, compiles to a temporary name and
``os.replace``-s it into place, so no process loads a half-written file.

The callers keep their plain versions (the numpy crop-augment of
``data/transforms.py``, the Python unfilter of ``utils/png.py``) for a
machine where the library cannot be built: ``available()`` is then False
and warns once, naming the compiler's error. ``counters()`` records which
route each call took, so a run can require the native one.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "BUILD_DIR", "build", "library", "available", "paired_crop_augment", "png_unfilter", "count", "counters",
    "reset_counters",
]

_HERE = Path(__file__).resolve().parent
SOURCES = ("augment.cpp", "png_unfilter.cpp")
FLAGS = ("-O3", "-shared", "-fPIC")
BUILD_DIR = _HERE.parents[1] / "build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_counts: collections.Counter = collections.Counter()
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(FLAGS).encode() + platform.machine().encode())
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((_HERE / name).read_bytes())
    return BUILD_DIR / f"libstudiosr_torch_native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing (under the lock); its path.
    Raises ``RuntimeError`` with the compiler's output if it fails."""
    out = _library_path()
    if out.exists():
        return out
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError("g++ not found: the port's host library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not out.exists():  # another process may have built it while this one waited
                tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
                cmd = [compiler, *FLAGS, "-o", str(tmp), *(str(_HERE / s) for s in SOURCES)]
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if that fails."""
    global _lib, _error
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except Exception as e:
                _error = f"{type(e).__name__}: {e}"
                raise
            lib.paired_crop_augment.argtypes = [
                _u8p, ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, _f32p, _f32p,
            ]
            lib.paired_crop_augment.restype = None
            lib.png_unfilter.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p]
            lib.png_unfilter.restype = ctypes.c_int
            _lib, _error = lib, None
        return _lib


def available() -> bool:
    """Whether the library loads. The first failure warns, naming the error;
    later calls return False without building again."""
    if _lib is not None:
        return True
    if _error is not None:
        return False
    try:
        library()
        return True
    except Exception:
        warnings.warn(f"the port's host library is unavailable, the plain versions run instead: {_error}",
                      stacklevel=2)
        return False


def count(kind: str, route: str) -> None:
    """Record that one ``kind`` call ("crop_augment", "unfilter") took
    ``route`` ("native", or its plain version's name)."""
    with _lock:
        _counts[(kind, route)] += 1


def counters() -> dict:
    """{kind: {route: calls}} since the last reset."""
    with _lock:
        out: dict = {}
        for (kind, route), n in _counts.items():
            out.setdefault(kind, {})[route] = n
        return out


def reset_counters() -> None:
    with _lock:
        _counts.clear()


def paired_crop_augment(
    lq: np.ndarray, gt: np.ndarray, size: int, scale: int, xs: int, ys: int, fliplr: bool, flipud: bool, rot90: bool,
) -> Tuple[np.ndarray, np.ndarray]:
    """Crop (lq at (ys, xs), gt at scale times that), flip left-right, flip
    up-down, rot90 (each when asked, in that order) and divide by 255, in one
    pass: float32 (size, size, 3) and (size * scale, size * scale, 3)."""
    lib = library()
    lq = np.ascontiguousarray(lq)
    gt = np.ascontiguousarray(gt)
    # The C++ kernel derives the GT row stride from the LQ width and trusts
    # the crop offsets: check them here, where a wrong input would otherwise
    # read out of bounds.
    if lq.dtype != np.uint8 or gt.dtype != np.uint8:
        raise TypeError(f"paired_crop_augment: uint8 inputs required, got {lq.dtype}/{gt.dtype}")
    if lq.ndim != 3 or lq.shape[2] != 3 or gt.ndim != 3 or gt.shape[2] != 3:
        raise ValueError(f"paired_crop_augment: HWC RGB inputs required, got {lq.shape}/{gt.shape}")
    if gt.shape[0] != lq.shape[0] * scale or gt.shape[1] != lq.shape[1] * scale:
        raise ValueError(f"paired_crop_augment: gt {gt.shape[:2]} is not lq {lq.shape[:2]} x{scale}")
    if not (0 <= xs <= lq.shape[1] - size and 0 <= ys <= lq.shape[0] - size):
        raise ValueError(f"paired_crop_augment: crop ({ys},{xs})+{size} outside lq {lq.shape[:2]}")
    out_lq = np.empty((size, size, 3), np.float32)
    out_gt = np.empty((size * scale, size * scale, 3), np.float32)
    flags = (1 if fliplr else 0) | (2 if flipud else 0) | (4 if rot90 else 0)
    lib.paired_crop_augment(
        lq.ctypes.data_as(_u8p), lq.shape[0], lq.shape[1], gt.ctypes.data_as(_u8p), size, scale, xs, ys, flags,
        out_lq.ctypes.data_as(_f32p), out_gt.ctypes.data_as(_f32p),
    )
    return out_lq, out_gt


def png_unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of ``raw`` (height rows of 1 + stride bytes):
    (height, stride) uint8. Raises ``ValueError`` on an unknown filter type."""
    lib = library()
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"png_unfilter: {raw.size} bytes, expected {height} rows of {stride + 1}")
    out = np.empty((height, stride), np.uint8)
    bad = lib.png_unfilter(raw.ctypes.data_as(_u8p), height, stride, bpp, out.ctypes.data_as(_u8p))
    if bad:
        raise ValueError(f"PNG row {bad - 1}: unknown filter type {int(raw[(bad - 1) * (stride + 1)])}")
    return out
