"""The port's PSNR / SSIM vs the JAX package's, on the CPU.

Host versions: equal to ``studiosr_tpu.utils.metrics``'s numpy protocol.
Device versions (torch, f32): within 1e-4 dB PSNR and 1e-5 SSIM of
``compute_psnr_jax`` / ``compute_ssim_jax``, the JAX package's own bound
for its device metrics against the host protocol.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.utils import metrics as jax_metrics
from studiosr_tpu_torch.utils import metrics

torch.set_num_threads(2)


def _pair(kind, gt_larger=False, seed=0):
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, 256, (37 + 3 * gt_larger, 45 + 2 * gt_larger, 3), dtype=np.uint8)
    sr = np.clip(gt[:37, :45].astype(int) + rng.integers(-12, 13, (37, 45, 3)), 0, 255).astype(np.uint8)
    if kind == "float":
        return sr.astype(np.float32) / 255.0, gt.astype(np.float32) / 255.0
    return sr, gt


CASES = [(kind, y_only, crop, larger) for kind in ("uint8", "float") for y_only in (True, False)
         for crop, larger in ((0, False), (4, False), (3, True))]


@pytest.mark.parametrize("kind,y_only,crop,larger", CASES)
def test_host_metrics_equal_the_jax_package(kind, y_only, crop, larger):
    sr, gt = _pair(kind, larger)
    assert metrics.compute_psnr(sr, gt, y_only, crop) == jax_metrics.compute_psnr(sr, gt, y_only, crop)
    assert metrics.compute_ssim(sr, gt, y_only, crop) == jax_metrics.compute_ssim(sr, gt, y_only, crop)


@pytest.mark.parametrize("kind,y_only,crop,larger", CASES)
def test_device_metrics_match_the_jax_device_metrics(kind, y_only, crop, larger):
    sr, gt = _pair(kind, larger, seed=1)
    want_psnr = float(jax_metrics.compute_psnr_jax(jnp.asarray(sr), jnp.asarray(gt), y_only, crop))
    want_ssim = float(jax_metrics.compute_ssim_jax(jnp.asarray(sr), jnp.asarray(gt), y_only, crop))
    got_psnr = metrics.compute_psnr_torch(torch.from_numpy(sr), torch.from_numpy(gt), y_only, crop)
    got_ssim = metrics.compute_ssim_torch(torch.from_numpy(sr), torch.from_numpy(gt), y_only, crop)
    assert got_psnr.dtype == got_ssim.dtype == torch.float32 and got_psnr.dim() == 0
    assert abs(float(got_psnr) - want_psnr) < 1e-4
    assert abs(float(got_ssim) - want_ssim) < 1e-5
    # and both against the host protocol, the JAX package's bound
    assert abs(float(got_psnr) - metrics.compute_psnr(sr, gt, y_only, crop)) < 1e-4
    assert abs(float(got_ssim) - metrics.compute_ssim(sr, gt, y_only, crop)) < 1e-4


def test_device_metrics_of_a_gray_pair():
    rng = np.random.default_rng(2)
    gt = rng.integers(0, 256, (30, 34), dtype=np.uint8)
    sr = np.clip(gt.astype(int) + rng.integers(-5, 6, gt.shape), 0, 255).astype(np.uint8)
    want = float(jax_metrics.compute_ssim_jax(jnp.asarray(sr), jnp.asarray(gt), True, 2))
    got = float(metrics.compute_ssim_torch(torch.from_numpy(sr), torch.from_numpy(gt), True, 2))
    assert abs(got - want) < 1e-5
