"""``tiled_inference(device_loop=True)``: the tile loop on the model's device
(here the CPU), held to the host loop's bytes and to the JAX package's own
device loop on the trained fixtures (``tests/fixtures/quality``).

Tolerances: against the host loop, bit for bit; against the JAX package,
the uint8 contract (within 1 LSB on under 1 % of pixels).
"""

import os

import numpy as np
import pytest
import torch

from studiosr_tpu.parallel.tiled import tiled_inference as jax_tiled_inference
from studiosr_tpu.zoo.registry import load_model as jax_load_model
from studiosr_tpu_torch import load_model
from studiosr_tpu_torch.parallel import tiled
from studiosr_tpu_torch.utils import imread

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "quality")
# (checkpoint, family, LR suffix): SwinIR x2 (window 8) and ESPCN x2 (a conv family)
MODELS = (("swinir_x2_ckpt", "swinir", "_lrx2"), ("ckpt", "espcn", "_lr"))


def _close_uint8(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


@pytest.fixture(scope="module", params=MODELS, ids=[m[1] for m in MODELS])
def pair(request):
    ckpt, family, suffix = request.param
    path = os.path.join(FIXTURES, ckpt)
    lr = imread(os.path.join(FIXTURES, f"img0{suffix}.png"))
    return jax_load_model(path, family), load_model(path, family, device="cpu"), lr


# odd image sizes (cropped from the fixture), each with a tail batch padded
# with zero tiles: (height, width, tile, overlap, tile batch)
CASES = [(37, 45, 16, 4, 4), (45, 29, 24, 5, 3), (23, 41, 16, 3, 8), (11, 9, 16, 4, 2)]


@pytest.mark.parametrize("h,w,tile,overlap,batch", CASES)
def test_device_loop_gives_the_host_loops_bytes(pair, h, w, tile, overlap, batch):
    _, model, lr = pair
    image = np.ascontiguousarray(lr[:h, :w])
    kw = dict(tile=tile, tile_overlap=overlap, tile_batch=batch)
    got = model.inference_tiled(image, device_loop=True, **kw)
    want = model.inference_tiled(image, device_loop=False, **kw)
    assert got.shape == (h * model.scale, w * model.scale, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile,overlap,batch", [(24, 4, 4), (32, 8, 3)])
def test_device_loop_matches_the_jax_device_loop(pair, tile, overlap, batch):
    jax_model, model, lr = pair
    image = np.ascontiguousarray(lr[:45, :37])
    kw = dict(tile=tile, tile_overlap=overlap, tile_batch=batch, device_loop=True)
    _close_uint8(model.inference_tiled(image, **kw), jax_tiled_inference(jax_model, image, **kw))


class _Identity:
    """Stands in for a model: scale 1 on the CPU, the uint8 batch returned."""

    scale, device = 1, torch.device("cpu")

    def forward_uint8(self, x):
        return x


@pytest.mark.parametrize("size,tiles,device", [((64, 128), 512, True), ((108, 76), 513, False)])
def test_device_loop_none_follows_the_512_tile_rule(monkeypatch, size, tiles, device):
    """``device_loop=None`` takes the device loop at most 512 tiles (the JAX
    package's rule), the host loop above; here 4 x 4 tiles without overlap."""
    calls = []
    loop = tiled._device_tiled

    def spy(model, padded, coords, *args):
        calls.append(len(coords))
        return loop(model, padded, coords, *args)

    monkeypatch.setattr(tiled, "_device_tiled", spy)
    image = np.random.default_rng(tiles).integers(0, 256, (*size, 3), dtype=np.uint8)
    out = tiled.tiled_inference(_Identity(), image, tile=4, tile_overlap=0, tile_batch=8)
    assert calls == ([tiles] if device else [])
    np.testing.assert_array_equal(out, image)
