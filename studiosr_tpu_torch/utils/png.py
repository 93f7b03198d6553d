"""A PNG codec in numpy and ``zlib``, for machines without cv2.

``read_png`` decodes an 8-bit, non-interlaced PNG to RGB uint8 HWC the way
``cv2.imread(path, cv2.IMREAD_COLOR)`` followed by BGR -> RGB does: gray is
replicated into three channels, alpha is dropped (not composited), a palette
is expanded. All five row filters are undone (None, Sub, Up, Average,
Paeth), in C++ through the port's host library (``native/``) where it
loads, else by :func:`unfilter_plain` (numpy, and a Python loop for the
Average and Paeth rows, whose bytes depend on the one just rebuilt). Other
bit depths and interlaced files raise :class:`UnsupportedPNG`, for the
caller to hand them to cv2. ``write_png`` writes 8-bit RGB (gray, RGBA)
with the None filter on every row, or the filters asked for. Chunk CRCs are
checked on read.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from studiosr_tpu_torch import native

__all__ = [
    "UnsupportedPNG", "read_png", "write_png", "decode_png", "encode_png", "filter_rows", "unfilter_plain",
    "PNG_SIGNATURE",
]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class UnsupportedPNG(ValueError):
    """A valid PNG of a kind this codec does not decode (bit depth other
    than 8, interlaced)."""


def _chunks(data: bytes):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} at byte {pos} is truncated or fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before its IEND chunk")


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``raw`` (height x (1 + stride) bytes):
    through the port's host library where it loads (``native/``, which also
    releases the GIL), else through :func:`unfilter_plain`. The bytes are the
    same either way; ``native.counters()["unfilter"]`` counts the routes."""
    if native.available():
        native.count("unfilter", "native")
        return native.png_unfilter(raw, height, stride, bpp)
    native.count("unfilter", "python")
    return unfilter_plain(raw, height, stride, bpp)


def unfilter_plain(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """The plain version of :func:`_unfilter`: numpy for None, Sub and Up,
    a Python loop along the row for Average and Paeth."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum of each byte lane, mod 256
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.int64) % 256).astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            cur = _unfilter_sequential(kind, line.tolist(), prior.tolist(), bpp)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def _unfilter_sequential(kind: int, line, prior, bpp: int) -> np.ndarray:
    cur = [0] * len(line)
    for i, v in enumerate(line):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            cur[i] = (v + ((a + b) >> 1)) & 0xFF
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (v + pred) & 0xFF
    return np.asarray(cur, np.uint8)


def filter_rows(pixels: np.ndarray, row_filter, bpp: int) -> np.ndarray:
    """Filter (height, stride) uint8 rows for a PNG: (height, 1 + stride),
    each row led by its filter type. ``row_filter`` is one type (0-4) for
    every row or a sequence of one per row."""
    height, stride = pixels.shape
    kinds = np.broadcast_to(np.asarray(row_filter, np.int64), (height,))
    if kinds.min(initial=0) < 0 or kinds.max(initial=0) > 4:
        raise ValueError(f"PNG filter types are 0-4, got {sorted(set(kinds.tolist()))}")
    x = pixels.astype(np.int32)
    a = np.zeros_like(x)  # the byte to the left, above, above-left
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pred = np.zeros_like(x)
    for kind in set(kinds.tolist()) - {0}:
        rows = kinds == kind
        ra, rb, rc = a[rows], b[rows], c[rows]
        if kind == 1:
            pred[rows] = ra
        elif kind == 2:
            pred[rows] = rb
        elif kind == 3:
            pred[rows] = (ra + rb) >> 1
        else:
            p = ra + rb - rc
            pa, pb, pc = np.abs(p - ra), np.abs(p - rb), np.abs(p - rc)
            pred[rows] = np.where((pa <= pb) & (pa <= pc), ra, np.where(pb <= pc, rb, rc))
    filtered = ((x - pred) & 0xFF).astype(np.uint8)
    return np.concatenate([kinds.astype(np.uint8)[:, None], filtered], axis=1)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> RGB uint8 (H, W, 3), as cv2's IMREAD_COLOR + BGR->RGB."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"PNG color type {color} is not valid")
    if depth != 8 or interlace:
        raise UnsupportedPNG(f"PNG bit depth {depth}, interlace {interlace}: only 8-bit non-interlaced is decoded here")
    channels = _CHANNELS[color]
    stride = width * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected {height * (stride + 1)}")
    pixels = _unfilter(raw, height, stride, channels).reshape(height, width, channels)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        if int(pixels.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[pixels[..., 0]]
    if color in (0, 4):  # gray (+ alpha): replicate, drop alpha
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])


def encode_png(image: np.ndarray, row_filter=0) -> bytes:
    """uint8 (H, W, 3) RGB -> 8-bit RGB PNG bytes; (H, W) or (H, W, 1) gray
    and (H, W, 4) RGBA are written as such. Every row is filtered with
    ``row_filter`` (0, None, by default; or one type per row)."""
    image = np.ascontiguousarray(image)
    if image.ndim == 2:
        image = image[..., None]
    color = {1: 0, 3: 2, 4: 6}.get(image.shape[-1]) if image.ndim == 3 else None
    if image.dtype != np.uint8 or color is None:
        raise ValueError(f"write_png takes RGB uint8 (H, W, 3), or gray (H, W, 1) or RGBA (H, W, 4), got {image.dtype} "
                         f"{image.shape}")
    height, width, channels = image.shape
    pixels = image.reshape(height, width * channels)
    if np.all(np.asarray(row_filter) == 0):
        rows = np.concatenate([np.zeros((height, 1), np.uint8), pixels], axis=1)
    else:
        rows = filter_rows(pixels, row_filter, channels)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    return (PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, image: np.ndarray, row_filter=0) -> None:
    data = encode_png(image, row_filter)
    with open(path, "wb") as f:
        f.write(data)
