"""Paired (lq, gt) augmentations on numpy HWC arrays.

Port (a copy; pure numpy and ``random``) of
``studiosr_tpu/data/transforms.py``: scale-coupled random crop, p=0.5
horizontal/vertical flips and rot90, in the same order of random draws, so
that a seeded ``random.Random`` gives the same samples in both packages.
``ToArray`` converts to float32 [0, 1] HWC.
"""

from __future__ import annotations

import random
from typing import Callable, List, Optional, Tuple

import numpy as np

__all__ = [
    "paired_random_crop",
    "paired_random_fliplr",
    "paired_random_flipud",
    "paired_random_rot90",
    "array_to_nhwc",
    "Compose",
    "RandomCrop",
    "RandomHorizontalFlip",
    "RandomVerticalFlip",
    "RandomRotation90",
    "ToArray",
    "ToTensor",
]


def _rng(rng: Optional[random.Random]) -> random.Random:
    return rng if rng is not None else random


def paired_random_crop(
    lq: np.ndarray, gt: np.ndarray, size: int = 48, scale: int = 4, rng: Optional[random.Random] = None
) -> Tuple[np.ndarray, np.ndarray]:
    h, w = lq.shape[:2]
    r = _rng(rng)
    xs = r.randint(0, w - size)
    ys = r.randint(0, h - size)
    lq = lq[ys : ys + size, xs : xs + size]
    gt = gt[ys * scale : (ys + size) * scale, xs * scale : (xs + size) * scale]
    return lq, gt


def paired_random_fliplr(
    lq: np.ndarray, gt: np.ndarray, p: float = 0.5, rng: Optional[random.Random] = None
) -> Tuple[np.ndarray, np.ndarray]:
    if _rng(rng).random() < p:
        lq, gt = np.fliplr(lq), np.fliplr(gt)
    return lq, gt


def paired_random_flipud(
    lq: np.ndarray, gt: np.ndarray, p: float = 0.5, rng: Optional[random.Random] = None
) -> Tuple[np.ndarray, np.ndarray]:
    if _rng(rng).random() < p:
        lq, gt = np.flipud(lq), np.flipud(gt)
    return lq, gt


def paired_random_rot90(
    lq: np.ndarray, gt: np.ndarray, p: float = 0.5, rng: Optional[random.Random] = None
) -> Tuple[np.ndarray, np.ndarray]:
    if _rng(rng).random() < p:
        lq, gt = np.rot90(lq), np.rot90(gt)
    return lq, gt


def array_to_nhwc(array: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC in [0, 1] (batching adds the N axis)."""
    return np.ascontiguousarray(array, dtype=np.float32) / 255.0


class Compose:
    def __init__(self, transforms: List[Callable]) -> None:
        self.transforms = transforms

    def __call__(self, lq, gt, rng: Optional[random.Random] = None):
        for transform in self.transforms:
            lq, gt = transform(lq, gt, rng=rng)
        return lq, gt


class RandomCrop:
    def __init__(self, size: int = 48, scale: int = 4) -> None:
        self.size = size
        self.scale = scale

    def __call__(self, lq, gt, rng: Optional[random.Random] = None):
        return paired_random_crop(lq, gt, self.size, self.scale, rng=rng)


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5) -> None:
        self.p = p

    def __call__(self, lq, gt, rng: Optional[random.Random] = None):
        return paired_random_fliplr(lq, gt, self.p, rng=rng)


class RandomVerticalFlip:
    def __init__(self, p: float = 0.5) -> None:
        self.p = p

    def __call__(self, lq, gt, rng: Optional[random.Random] = None):
        return paired_random_flipud(lq, gt, self.p, rng=rng)


class RandomRotation90:
    def __init__(self, p: float = 0.5) -> None:
        self.p = p

    def __call__(self, lq, gt, rng: Optional[random.Random] = None):
        return paired_random_rot90(lq, gt, self.p, rng=rng)


class ToArray:
    def __call__(self, lq, gt, rng: Optional[random.Random] = None):
        return array_to_nhwc(lq), array_to_nhwc(gt)


# Name-compatible alias for the reference API (produces NHWC numpy, which the
# jitted train step consumes directly).
ToTensor = ToArray
