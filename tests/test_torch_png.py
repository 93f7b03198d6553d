"""The port's PNG codec (``utils/png.py``) and ``imread`` / ``imwrite`` vs cv2.

``imread`` must give what ``cv2.imread(IMREAD_COLOR)`` + BGR->RGB gives,
bitwise: on every fixture PNG, and on gray, gray+alpha, RGBA and palette
PNGs made here with each of the five row filters. Kinds the codec does not
decode go through cv2, and raise ``ImportError`` naming the file where cv2
is missing.
"""

import glob
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from studiosr_tpu_torch.utils import imread, imwrite
from studiosr_tpu_torch.utils.png import PNG_SIGNATURE, UnsupportedPNG, decode_png

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "quality")
PNGS = sorted(glob.glob(os.path.join(FIXTURES, "*.png")))


def _cv2_read(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("path", PNGS, ids=os.path.basename)
def test_imread_equals_cv2_on_the_fixtures(path):
    got = imread(path)
    assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, _cv2_read(path))


def _filter_row(kind, line, prior, bpp):
    """Encode one row with PNG filter ``kind`` (the inverse of the decoder)."""
    x, b = line.astype(np.int64), prior.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) // 2
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) % 256).astype(np.uint8)


def _png_bytes(pixels, color, palette=None, trns=None):
    """An 8-bit PNG of ``color`` type whose rows cycle through filters 0-4."""
    h, w = pixels.shape[:2]
    flat = pixels.reshape(h, -1)
    bpp = flat.shape[1] // w
    rows, prior = [], np.zeros(flat.shape[1], np.uint8)
    for y in range(h):
        kind = y % 5
        rows.append(bytes([kind]) + _filter_row(kind, flat[y], prior, bpp).tobytes())
        prior = flat[y]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    out = PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b"")


def _made(kind, rng):
    h, w = 19, 23
    if kind == "gray":
        return _png_bytes(rng.integers(0, 256, (h, w), dtype=np.uint8), 0)
    if kind == "gray+alpha":
        return _png_bytes(rng.integers(0, 256, (h, w, 2), dtype=np.uint8), 4)
    if kind == "rgb":
        return _png_bytes(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), 2)
    if kind == "rgba":
        return _png_bytes(rng.integers(0, 256, (h, w, 4), dtype=np.uint8), 6)
    palette = rng.integers(0, 256, (40, 3), dtype=np.uint8)
    return _png_bytes(rng.integers(0, 40, (h, w), dtype=np.uint8), 3, palette=palette,
                      trns=bytes(range(0, 200, 10)) if kind == "palette+trns" else None)


@pytest.mark.parametrize("kind", ["gray", "gray+alpha", "rgb", "rgba", "palette", "palette+trns"])
def test_imread_equals_cv2_on_made_pngs(tmp_path, kind):
    path = tmp_path / "made.png"
    path.write_bytes(_made(kind, np.random.default_rng(len(kind))))
    want = _cv2_read(path)
    got = imread(str(path))
    assert got.shape == want.shape == (19, 23, 3)
    np.testing.assert_array_equal(got, want)


def test_imwrite_round_trips(tmp_path):
    image = np.random.default_rng(3).integers(0, 256, (31, 17, 3), dtype=np.uint8)
    path = str(tmp_path / "out.png")
    assert imwrite(path, image)
    np.testing.assert_array_equal(imread(path), image)
    np.testing.assert_array_equal(_cv2_read(path), image)
    with pytest.raises(ValueError, match="RGB uint8"):
        imwrite(path, image.astype(np.float32))


def test_other_kinds_go_through_cv2(tmp_path, monkeypatch):
    deep = (np.random.default_rng(4).integers(0, 65536, (9, 11, 3))).astype(np.uint16)
    png16, bmp = str(tmp_path / "deep.png"), str(tmp_path / "img.bmp")
    cv2.imwrite(png16, deep)
    with open(png16, "rb") as f:
        with pytest.raises(UnsupportedPNG):
            decode_png(f.read())
    np.testing.assert_array_equal(imread(png16), _cv2_read(png16))
    image = np.random.default_rng(5).integers(0, 256, (9, 11, 3), dtype=np.uint8)
    assert imwrite(bmp, image)
    np.testing.assert_array_equal(imread(bmp), image)

    monkeypatch.setitem(sys.modules, "cv2", None)  # as on a machine without cv2
    for path in (png16, bmp):
        with pytest.raises(ImportError, match=os.path.basename(path)):
            imread(path)
    np.testing.assert_array_equal(imread(PNGS[0]), _cv2_read(PNGS[0]))  # PNG needs no cv2


def test_corrupt_and_missing_files_raise(tmp_path):
    data = bytearray(_made("rgb", np.random.default_rng(6)))
    data[40] ^= 0xFF  # inside IHDR or IDAT: the CRC check catches it
    path = tmp_path / "bad.png"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        imread(str(path))
    with pytest.raises(FileNotFoundError):
        imread(str(tmp_path / "missing.png"))
