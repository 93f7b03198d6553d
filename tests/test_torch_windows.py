"""Port window/padding/shuffle helpers vs the JAX package's, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.ops import windows as jw
from studiosr_tpu.ops.pixel_shuffle import pixel_shuffle as jax_pixel_shuffle
from studiosr_tpu_torch.ops import windows as tw
from studiosr_tpu_torch.ops.pixel_shuffle import pixel_shuffle

torch.set_num_threads(2)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("shape,ws", [((2, 16, 24, 5), 8), ((1, 12, 12, 3), 4)])
def test_window_partition_and_reverse(shape, ws):
    x = _rand(shape)
    want = np.asarray(jw.window_partition(jnp.asarray(x), ws))
    got = tw.window_partition(torch.from_numpy(x), ws).numpy()
    np.testing.assert_array_equal(got, want)
    back = tw.window_reverse(torch.from_numpy(want.copy()), ws, shape[1], shape[2]).numpy()
    np.testing.assert_array_equal(back, np.asarray(jw.window_reverse(jnp.asarray(want), ws, shape[1], shape[2])))
    np.testing.assert_array_equal(back, x)


MASK_CASES = [((16, 24), 8, 4), ((264, 264), 8, 4), ((32, 48), 16, 8), ((12, 12), 4, 2)]


@pytest.mark.parametrize("size,ws,shift", MASK_CASES)
def test_calculate_mask(size, ws, shift):
    np.testing.assert_array_equal(tw.calculate_mask(size, ws, shift), jw.calculate_mask(size, ws, shift))


@pytest.mark.parametrize("size,ws,shift", MASK_CASES)
def test_shift_region_ids_reproduce_calculate_mask(size, ws, shift):
    """The region-id rule the CUDA Swin block evaluates per token gives the
    JAX package's dense shift mask exactly."""
    h, w = size
    ids = tw.shift_region_ids(h, w, ws, shift)
    win = ids.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    mask = np.where(win[:, None, :] != win[:, :, None], -100.0, 0.0).astype(np.float32)
    np.testing.assert_array_equal(mask, jw.calculate_mask(size, ws, shift))


@pytest.mark.parametrize("ws", [4, 8, 16])
def test_relative_position_index(ws):
    np.testing.assert_array_equal(tw.relative_position_index(ws), jw.relative_position_index(ws))


@pytest.mark.parametrize("ws,heads", [(8, 2), (4, 3)])
def test_gather_rel_bias(ws, heads):
    table = _rand(((2 * ws - 1) ** 2, heads), seed=1)
    rpi = jw.relative_position_index(ws)
    want = np.asarray(jw.gather_rel_bias(jnp.asarray(table), rpi, heads))
    got = tw.gather_rel_bias(torch.from_numpy(table), tw.relative_position_index(ws), heads).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 13, 21, 3), (2, 16, 16, 3), (1, 5, 9, 2)])
def test_pad_to_multiple_flip(shape):
    x = _rand(shape, seed=2)
    want = np.asarray(jw.pad_to_multiple_flip(jnp.asarray(x), 8))
    got = tw.pad_to_multiple_flip(torch.from_numpy(x), 8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 13, 21, 3), (2, 16, 16, 3), (1, 11, 9, 2)])
def test_pad_to_multiple_reflect(shape):
    x = _rand(shape, seed=3)
    want = np.asarray(jw.pad_to_multiple_reflect(jnp.asarray(x), 8))
    got = tw.pad_to_multiple_reflect(torch.from_numpy(x), 8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale,oc", [(2, 3), (3, 2), (4, 1)])
def test_pixel_shuffle(scale, oc):
    x = _rand((2, 5, 7, oc * scale * scale), seed=4)
    want = np.asarray(jax_pixel_shuffle(jnp.asarray(x), scale))
    np.testing.assert_array_equal(pixel_shuffle(torch.from_numpy(x), scale).numpy(), want)
