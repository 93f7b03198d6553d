"""Read flax msgpack checkpoints without ``msgpack`` or ``flax``.

The JAX package's Trainer writes ``{tag}.model.ckpt`` with
``flax.serialization.to_bytes``: a msgpack map of the variables tree whose
array leaves are msgpack ext records. :func:`msgpack_restore` is the
counterpart of ``flax.serialization.msgpack_restore``. It decodes:

* maps, arrays (as lists), str, bin, nil, bool, ints and floats;
* ext type 1, an ndarray: a msgpack (shape, dtype name, raw C-order bytes)
  triple. ``bfloat16`` leaves are widened exactly to float32, since numpy
  has no bfloat16;
* ext type 2, a Python complex (a msgpack (real, imag) pair);
* ext type 3, a numpy scalar (an ndarray record of shape ());
* flax's chunked-array record for leaves over 1 GiB, a map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks": {"0":
  flat array, ...}}``, joined back into one array.

Anything else (another ext type, a reserved byte, data that ends early or
runs past the top-level object) raises ``ValueError`` naming the byte
offset.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

__all__ = ["msgpack_restore", "CHUNKED_KEY"]

CHUNKED_KEY = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes, raw: bool = False) -> None:
        self.data = memoryview(data)
        self.raw = raw  # str as bytes (flax reads the ndarray records so)

    def take(self, pos: int, n: int) -> Tuple[memoryview, int]:
        if pos + n > len(self.data):
            raise ValueError(f"msgpack data ends at byte {len(self.data)}, inside an object that needs {n} bytes "
                             f"at byte {pos}")
        return self.data[pos : pos + n], pos + n

    def unpack(self, fmt: str, pos: int):
        size = struct.calcsize(fmt)
        chunk, end = self.take(pos, size)
        return struct.unpack(fmt, chunk)[0], end

    def string(self, pos: int, n: int):
        chunk, end = self.take(pos, n)
        return (bytes(chunk) if self.raw else str(chunk, "utf-8")), end

    def ext(self, pos: int, code: int, n: int, at: int):
        chunk, end = self.take(pos, n)
        return _ext(code, bytes(chunk), at), end

    def array(self, pos: int, n: int):
        out = []
        for _ in range(n):
            value, pos = self.read(pos)
            out.append(value)
        return out, pos

    def map(self, pos: int, n: int):
        out = {}
        for _ in range(n):
            key, pos = self.read(pos)
            value, pos = self.read(pos)
            out[key] = value
        return out, pos

    def read(self, pos: int) -> Tuple[Any, int]:
        if pos >= len(self.data):
            raise ValueError(f"msgpack data ends at byte {pos}, where an object was expected")
        b = self.data[pos]
        at, pos = pos, pos + 1
        if b <= 0x7F:
            return b, pos
        if b >= 0xE0:
            return b - 0x100, pos
        if 0x80 <= b <= 0x8F:
            return self.map(pos, b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(pos, b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.string(pos, b & 0x1F)
        if b == 0xC0:
            return None, pos
        if b in (0xC2, 0xC3):
            return b == 0xC3, pos
        if b in (0xC4, 0xC5, 0xC6):  # bin 8 / 16 / 32
            n, pos = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b], pos)
            chunk, pos = self.take(pos, n)
            return bytes(chunk), pos
        if b in (0xC7, 0xC8, 0xC9):  # ext 8 / 16 / 32
            n, pos = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b], pos)
            code, pos = self.unpack(">b", pos)
            return self.ext(pos, code, n, at)
        if b in (0xCA, 0xCB):
            return self.unpack(">f" if b == 0xCA else ">d", pos)
        if 0xCC <= b <= 0xD3:  # uint 8..64, int 8..64
            return self.unpack((">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[b - 0xCC], pos)
        if 0xD4 <= b <= 0xD8:  # fixext 1 / 2 / 4 / 8 / 16
            code, pos = self.unpack(">b", pos)
            return self.ext(pos, code, 1 << (b - 0xD4), at)
        if b in (0xD9, 0xDA, 0xDB):  # str 8 / 16 / 32
            n, pos = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b], pos)
            return self.string(pos, n)
        if b in (0xDC, 0xDD):
            n, pos = self.unpack(">H" if b == 0xDC else ">I", pos)
            return self.array(pos, n)
        if b in (0xDE, 0xDF):
            n, pos = self.unpack(">H" if b == 0xDE else ">I", pos)
            return self.map(pos, n)
        raise ValueError(f"msgpack byte 0x{b:02x} at byte {at} is not a valid type")


def _unpack_all(data: bytes, raw: bool = False) -> Any:
    value, end = _Reader(data, raw).read(0)
    if end != len(data):
        raise ValueError(f"msgpack data continues past its object: {len(data) - end} bytes at byte {end}")
    return value


def _ndarray(data: bytes, at: int) -> np.ndarray:
    try:
        shape, name, buffer = _unpack_all(data, raw=True)
    except (ValueError, TypeError) as e:
        raise ValueError(f"bad ndarray record at byte {at}: {e}") from None
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":  # widen exactly: the bf16 bits are the top half of an f32
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext(code: int, data: bytes, at: int) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data, at)
    if code == _EXT_COMPLEX:
        real, imag = _unpack_all(data)
        return complex(real, imag)
    if code == _EXT_NPSCALAR:
        return _ndarray(data, at)[()]
    raise ValueError(f"msgpack ext type {code} at byte {at} is not one flax writes (1 ndarray, 2 complex, "
                     "3 numpy scalar)")


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if CHUNKED_KEY in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """flax msgpack bytes -> the tree of dicts, lists, scalars and numpy
    arrays that ``flax.serialization.msgpack_restore`` gives."""
    return _unchunk(_unpack_all(bytes(data)))
