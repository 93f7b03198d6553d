"""The port's host library (``studiosr_tpu_torch/native/``) and its codec.

* the C++ crop + augment, bit for bit against the port's numpy pipeline and
  the JAX package's, over seeds and all eight flip / rot90 cases; the
  dataset's native route draws the numpy route's random numbers;
* three processes building the library at once into one directory: all
  load it and compute the same, and one library is left;
* PNG files written here with each row filter (and a mix), with 1, 3 and 4
  channels, decoded by the native and the Python unfilter: both equal
  ``cv2.imdecode``; the time of a 480² all-Paeth decode by each is logged.
"""

import os
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from studiosr_tpu_torch import native
from studiosr_tpu_torch.data import PairedImageDataset
from studiosr_tpu_torch.data import transforms as T
from studiosr_tpu_torch.utils import png

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
FLAGS = [(lr, ud, rot) for lr in (False, True) for ud in (False, True) for rot in (False, True)]


def _pair(seed, h=23, w=31, scale=3):
    rng = np.random.default_rng(seed)
    lq = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    gt = rng.integers(0, 256, (h * scale, w * scale, 3), dtype=np.uint8)
    return lq, gt


def _numpy_pipeline(t, lq, gt, size, scale, xs, ys, flags):
    """A transforms module's functions with fixed draws: p 1 or 0 per flag."""

    class Fixed:
        def __init__(self, xs, ys):
            self.ints = [xs, ys]

        def randint(self, a, b):
            return self.ints.pop(0)

    lq, gt = t.paired_random_crop(lq, gt, size, scale, rng=Fixed(xs, ys))
    lq, gt = t.paired_random_fliplr(lq, gt, 1.0 if flags[0] else 0.0)
    lq, gt = t.paired_random_flipud(lq, gt, 1.0 if flags[1] else 0.0)
    lq, gt = t.paired_random_rot90(lq, gt, 1.0 if flags[2] else 0.0)
    return t.array_to_nhwc(lq), t.array_to_nhwc(gt)


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "lr{}ud{}rot{}".format(*map(int, f)))
def test_native_crop_augment_is_the_numpy_pipelines_bitwise(flags):
    from studiosr_tpu.data import transforms as jax_transforms

    for seed in range(4):
        lq, gt = _pair(seed)
        size, scale = 9 + seed, 3
        xs, ys = (5 * seed) % (lq.shape[1] - size + 1), (3 * seed + 1) % (lq.shape[0] - size + 1)
        got = native.paired_crop_augment(lq, gt, size, scale, xs, ys, *flags)
        for t in (T, jax_transforms):
            want = _numpy_pipeline(t, lq, gt, size, scale, xs, ys, flags)
            for g, w in zip(got, want):
                assert g.dtype == np.float32 and g.shape == w.shape
                np.testing.assert_array_equal(g, w)


class _MemoryPairs(PairedImageDataset):
    def __init__(self, pairs, size, scale):
        self.pairs = pairs
        self.files = [str(i) for i in range(len(pairs))]
        self._init_pipeline(size, scale, transform=True, to_tensor=True)

    def get_image_pair(self, idx):
        return self.pairs[idx]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dataset_native_route_draws_the_numpy_routes_numbers(seed, monkeypatch):
    ds = _MemoryPairs([_pair(seed + i, h=20, w=17, scale=2) for i in range(3)], size=8, scale=2)
    native.reset_counters()
    fast = [ds.get(i, rng=random.Random(f"{seed}:{i}")) for i in range(3)]
    assert native.counters()["crop_augment"] == {"native": 3}
    monkeypatch.setattr(native, "available", lambda: False)
    plain = [ds.get(i, rng=random.Random(f"{seed}:{i}")) for i in range(3)]
    assert native.counters()["crop_augment"] == {"native": 3, "numpy": 3}
    for f, p in zip(fast, plain):
        for a, b in zip(f, p):
            np.testing.assert_array_equal(a, b)


def test_native_crop_augment_checks_its_inputs():
    lq, gt = _pair(0)
    with pytest.raises(ValueError, match="outside"):
        native.paired_crop_augment(lq, gt, 9, 3, lq.shape[1] - 8, 0, False, False, False)
    with pytest.raises(ValueError, match="x2"):
        native.paired_crop_augment(lq, gt, 9, 2, 0, 0, False, False, False)
    with pytest.raises(TypeError):
        native.paired_crop_augment(lq.astype(np.float32), gt, 9, 3, 0, 0, False, False, False)


_BUILD_AND_RUN = """
import sys, time, zlib
from pathlib import Path
import numpy as np
import studiosr_tpu_torch.native as native

native.BUILD_DIR = Path(sys.argv[1])
while time.time() < float(sys.argv[2]):
    time.sleep(0.005)
native.library()
rng = np.random.default_rng(0)
lq = rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
gt = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
a, b = native.paired_crop_augment(lq, gt, 8, 2, 3, 5, True, False, True)
raw = np.concatenate([np.full((16, 1), 4, np.uint8), rng.integers(0, 256, (16, 30), dtype=np.uint8)], axis=1)
u = native.png_unfilter(raw.reshape(-1), 16, 30, 3)
print(zlib.crc32(a.tobytes() + b.tobytes() + u.tobytes()))
"""


def test_concurrent_first_builds_all_load_one_library(tmp_path):
    """Three processes build the library into an empty directory at the same
    moment: the lock lets one compile, the others wait and load it."""
    build_dir = tmp_path / "native"
    start = time.time() + 8.0  # past the three interpreters' torch imports
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [
        subprocess.Popen([sys.executable, "-c", _BUILD_AND_RUN, str(build_dir), str(start)], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, env=env, cwd=str(tmp_path))
        for _ in range(3)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert len({out.strip() for out, _ in outs}) == 1
    left = sorted(f.name for f in build_dir.iterdir())
    assert [f for f in left if f.endswith(".so")] == [native._library_path().name]
    assert not [f for f in left if f.endswith(".tmp")]


def _png_image(channels, seed=0, h=29, w=23):
    rng = np.random.default_rng(seed)
    smooth = np.cumsum(rng.integers(-3, 4, (h, w, channels)), axis=1) + 128  # Paeth and Average predict from these
    image = np.clip(smooth, 0, 255).astype(np.uint8)
    image[::5] = rng.integers(0, 256, image[::5].shape, dtype=np.uint8)
    return image[..., 0] if channels == 1 else image


def _cv2_rgb(data):
    import cv2

    return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


ROW_FILTERS = [0, 1, 2, 3, 4, "mixed"]


@pytest.mark.parametrize("row_filter", ROW_FILTERS)
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_row_filters_decode_natively_and_in_python_as_cv2(channels, row_filter, monkeypatch):
    image = _png_image(channels)
    kinds = [i % 5 for i in range(image.shape[0])] if row_filter == "mixed" else row_filter
    data = png.encode_png(image, kinds)
    want = _cv2_rgb(data)
    native.reset_counters()
    got = png.decode_png(data)
    monkeypatch.setattr(native, "available", lambda: False)
    plain = png.decode_png(data)
    assert native.counters()["unfilter"] == {"native": 1, "python": 1}
    assert got.dtype == np.uint8 and got.shape == want.shape == image.shape[:2] + (3,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)


def test_png_unknown_row_filter_raises_on_both_routes():
    raw = np.zeros((3, 1 + 6), np.uint8)
    raw[1, 0] = 7
    with pytest.raises(ValueError, match="row 1: unknown filter type 7"):
        native.png_unfilter(raw.reshape(-1), 3, 6, 3)
    with pytest.raises(ValueError, match="row 1: unknown filter type 7"):
        png.unfilter_plain(raw.reshape(-1), 3, 6, 3)


def test_paeth_decode_time_by_route(capsys, monkeypatch):
    """Logged, not asserted: a 480² RGB PNG with Paeth on every row."""
    data = png.encode_png(_png_image(3, h=480, w=480), 4)
    start = time.perf_counter()
    got = png.decode_png(data)
    native_s = time.perf_counter() - start
    monkeypatch.setattr(native, "available", lambda: False)
    start = time.perf_counter()
    plain = png.decode_png(data)
    python_s = time.perf_counter() - start
    np.testing.assert_array_equal(plain, got)
    with capsys.disabled():
        print(f"\n480² all-Paeth PNG decode: native unfilter {native_s * 1e3:.1f} ms, Python unfilter "
              f"{python_s * 1e3:.1f} ms (host CPU)")
