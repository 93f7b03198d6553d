"""Standard super-resolution quality metrics.

Port of ``studiosr_tpu/utils/metrics.py``: the benchmark protocol of the
reference StudioSR, BT.601 Y-channel conversion on [0, 1] floats, border
cropping, PSNR as 20 log10(255 / sqrt(MSE)), and SSIM with skimage's
``structural_similarity`` constants (K1 0.01, K2 0.03, a Gaussian window of
sigma 1.5 truncated at 3.5 sigma, ``use_sample_covariance=False``,
``data_range=255``).

Two implementations:

* numpy host versions (``compute_psnr`` / ``compute_ssim``), the protocol
  reference in float64 like skimage, copied as they are;
* device versions (``compute_psnr_torch`` / ``compute_ssim_torch``), the
  counterparts of the JAX package's ``compute_psnr_jax`` /
  ``compute_ssim_jax``: float32 on the tensors' device, so an evaluation
  fetches two numbers per image and never the image. They follow the same
  dtype dispatch (only uint8 is divided by 255 before the Y weights), the
  same crop to a common size and the same ``scale255`` rule.

SSIM's variance terms are E[x^2] - E[x]^2 differences of nearly equal
numbers; reduced-precision multiplies (TF32 keeps about three decimal
digits) move SSIM by about 0.02. The device Gaussian filter is therefore a
separable "valid" correlation written as f32 multiply-adds over shifted
views: no TF32 or cuDNN path, whatever the global flags say.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "is_rgb",
    "to_y",
    "crop_img_to_equal",
    "compute_psnr",
    "compute_ssim",
    "compute_psnr_torch",
    "compute_ssim_torch",
]

# BT.601 RGB -> Y (luma) weights used across the SR literature.
_Y_WEIGHTS = np.array([65.481, 128.553, 24.966])
_Y_OFFSET = 16.0

# skimage structural_similarity constants.
_SSIM_K1 = 0.01
_SSIM_K2 = 0.03
_SSIM_SIGMA = 1.5
_SSIM_TRUNCATE = 3.5
_SSIM_DATA_RANGE = 255.0


def is_rgb(im: np.ndarray) -> bool:
    return len(im.shape) == 3 and im.shape[-1] == 3


def to_y(image: np.ndarray) -> np.ndarray:
    """RGB -> BT.601 Y channel; uint8 input is scaled to [0,1] first."""
    if not is_rgb(image):
        return image
    if image.dtype == np.uint8:
        image = image.astype(np.float32) / 255.0
    return np.dot(image, _Y_WEIGHTS) + _Y_OFFSET


def crop_img_to_equal(im1: np.ndarray, im2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Crop the larger image's bottom/right so both share a common size."""
    diff_x = abs(im1.shape[0] - im2.shape[0])
    diff_y = abs(im1.shape[1] - im2.shape[1])
    if im1.shape[0] > im2.shape[0]:
        im1 = im1[:-diff_x, :]
    elif im1.shape[0] < im2.shape[0]:
        im2 = im2[:-diff_x, :]
    if im1.shape[1] > im2.shape[1]:
        im1 = im1[:, :-diff_y]
    elif im1.shape[1] < im2.shape[1]:
        im2 = im2[:, :-diff_y]
    return im1, im2


def compute_psnr(im1: np.ndarray, im2: np.ndarray, y_only: bool = False, crop_border: int = 0) -> np.float64:
    im1, im2 = crop_img_to_equal(im1, im2)
    if crop_border:
        im1 = im1[crop_border:-crop_border, crop_border:-crop_border]
        im2 = im2[crop_border:-crop_border, crop_border:-crop_border]
    if y_only:
        im1, im2 = to_y(im1), to_y(im2)
    elif im1.dtype != np.uint8:
        im1, im2 = im1 * 255.0, im2 * 255.0
    error = np.mean((im1.astype(np.float32) - im2.astype(np.float32)) ** 2)
    if error == 0:
        return np.inf
    return 20 * np.log10(255.0 / np.sqrt(error))


def _gaussian_kernel_1d(sigma: float = _SSIM_SIGMA, truncate: float = _SSIM_TRUNCATE) -> np.ndarray:
    """The 1-D gaussian taps scipy.ndimage uses: radius = int(truncate*sigma + 0.5)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    kernel = np.exp(-0.5 * (x / sigma) ** 2)
    return kernel / kernel.sum()


def _ssim_single_channel(im1: np.ndarray, im2: np.ndarray) -> float:
    """skimage structural_similarity for one 2-D channel: float64, the
    filtered maps cropped by the window radius before averaging."""
    kernel = _gaussian_kernel_1d()
    pad = (kernel.size - 1) // 2

    im1 = im1.astype(np.float64)
    im2 = im2.astype(np.float64)

    def filt(img: np.ndarray) -> np.ndarray:
        # Separable gaussian; boundary values are discarded by the crop below.
        from scipy.ndimage import correlate1d

        out = correlate1d(img, kernel, axis=0, mode="reflect")
        return correlate1d(out, kernel, axis=1, mode="reflect")

    ux = filt(im1)
    uy = filt(im2)
    uxx = filt(im1 * im1)
    uyy = filt(im2 * im2)
    uxy = filt(im1 * im2)
    # use_sample_covariance=False -> cov_norm = 1
    vx = uxx - ux * ux
    vy = uyy - uy * uy
    vxy = uxy - ux * uy

    c1 = (_SSIM_K1 * _SSIM_DATA_RANGE) ** 2
    c2 = (_SSIM_K2 * _SSIM_DATA_RANGE) ** 2
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux**2 + uy**2 + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    return float(s[pad:-pad, pad:-pad].mean())


def compute_ssim(im1: np.ndarray, im2: np.ndarray, y_only: bool = False, crop_border: int = 0) -> np.float64:
    im1, im2 = crop_img_to_equal(im1, im2)
    if crop_border:
        im1 = im1[crop_border:-crop_border, crop_border:-crop_border]
        im2 = im2[crop_border:-crop_border, crop_border:-crop_border]
    if y_only:
        im1, im2 = to_y(im1), to_y(im2)
    if im1.ndim == 3:
        # Multichannel: mean of per-channel SSIM (skimage channel_axis semantics).
        values = [_ssim_single_channel(im1[..., c], im2[..., c]) for c in range(im1.shape[-1])]
        return np.float64(np.mean(values))
    return np.float64(_ssim_single_channel(im1, im2))


# ---------------------------------------------------------------------------
# Device versions (torch, float32, on the tensors' device).
# ---------------------------------------------------------------------------


def _to_y_like_host(image: torch.Tensor) -> torch.Tensor:
    """The host :func:`to_y` dtype dispatch: only uint8 is divided by 255
    before the Y weights; float inputs are taken as [0, 1] already."""
    image = image.float() / 255.0 if image.dtype == torch.uint8 else image.float()
    if image.dim() != 3 or image.shape[-1] != 3:
        return image
    w = [float(v) for v in _Y_WEIGHTS]
    return image[..., 0] * w[0] + image[..., 1] * w[1] + image[..., 2] * w[2] + _Y_OFFSET


def _crop_to_equal(im1: torch.Tensor, im2: torch.Tensor):
    """:func:`crop_img_to_equal` for tensors: an SR output may be smaller
    than its GT when the HR size is not a multiple of the scale."""
    h = min(im1.shape[0], im2.shape[0])
    w = min(im1.shape[1], im2.shape[1])
    return im1[:h, :w], im2[:h, :w]


def _crop_border(im1: torch.Tensor, im2: torch.Tensor, crop_border: int):
    if crop_border:
        im1 = im1[crop_border:-crop_border, crop_border:-crop_border]
        im2 = im2[crop_border:-crop_border, crop_border:-crop_border]
    return im1, im2


def compute_psnr_torch(im1: torch.Tensor, im2: torch.Tensor, y_only: bool = False, crop_border: int = 0) -> torch.Tensor:
    """Device PSNR (a 0-d f32 tensor on the inputs' device) of two HWC (or
    HW) images, the host :func:`compute_psnr` protocol: cropped to a common
    size, uint8 taken as 0-255, non-y float inputs scaled by 255."""
    im1, im2 = _crop_to_equal(im1, im2)
    scale255 = not y_only and im1.dtype != torch.uint8
    im1, im2 = _crop_border(im1, im2, crop_border)
    if y_only:
        im1, im2 = _to_y_like_host(im1), _to_y_like_host(im2)
    else:
        im1, im2 = im1.float(), im2.float()
        if scale255:
            im1, im2 = im1 * 255.0, im2 * 255.0
    error = torch.mean((im1 - im2) ** 2)
    return 20.0 * torch.log10(255.0 / torch.sqrt(error))


def _gaussian_valid(img: torch.Tensor, taps) -> torch.Tensor:
    """Separable "valid" Gaussian correlation of an (H, W) f32 map, along H
    then W, as f32 multiply-adds over shifted views."""
    k = len(taps)
    h, w = img.shape
    rows = sum(t * img[i : i + h - k + 1] for i, t in enumerate(taps))
    return sum(t * rows[:, i : i + w - k + 1] for i, t in enumerate(taps))


def _ssim_map(im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
    taps = [float(np.float32(t)) for t in _gaussian_kernel_1d()]
    ux = _gaussian_valid(im1, taps)
    uy = _gaussian_valid(im2, taps)
    uxx = _gaussian_valid(im1 * im1, taps)
    uyy = _gaussian_valid(im2 * im2, taps)
    uxy = _gaussian_valid(im1 * im2, taps)
    vx = uxx - ux * ux
    vy = uyy - uy * uy
    vxy = uxy - ux * uy
    c1 = (_SSIM_K1 * _SSIM_DATA_RANGE) ** 2
    c2 = (_SSIM_K2 * _SSIM_DATA_RANGE) ** 2
    return ((2.0 * ux * uy + c1) * (2.0 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))


def compute_ssim_torch(im1: torch.Tensor, im2: torch.Tensor, y_only: bool = False, crop_border: int = 0) -> torch.Tensor:
    """Device SSIM (a 0-d f32 tensor), the skimage protocol of
    :func:`compute_ssim` to about 1e-5. Like the host version, non-y float
    inputs are not rescaled (they meet ``data_range=255`` as they are)."""
    im1, im2 = _crop_to_equal(im1, im2)
    im1, im2 = _crop_border(im1, im2, crop_border)
    if y_only:
        im1, im2 = _to_y_like_host(im1), _to_y_like_host(im2)
    else:
        im1, im2 = im1.float(), im2.float()
    if im1.dim() == 3:
        return torch.stack([_ssim_map(im1[..., c], im2[..., c]).mean() for c in range(im1.shape[-1])]).mean()
    return _ssim_map(im1, im2).mean()
