"""Paired LR/HR image dataset.

Port of ``studiosr_tpu/data/dataset.py::PairedImageDataset``: files paired
by identical name under the gt and lq directories, the standard SR training
augmentation (scale-coupled crop + flips + rot90, ``transforms.py``) and the
optional float32 conversion, yielding numpy HWC arrays. ``get(idx, rng)``
draws from an explicit ``random.Random``, as the loader seeds it per sample.

Images are read with cv2, imported on first read. Subclasses that hold
their pairs elsewhere (in memory) override :meth:`get_image_pair`. The
JAX package's DIV2K / Flickr2K / DF2K download and sub-image preparation
and its native C++ crop+augment path are not part of this port yet; the
numpy path draws the same random numbers as that native path.
"""

from __future__ import annotations

import os
import random
from typing import Optional, Tuple

import numpy as np

from studiosr_tpu_torch.data import transforms as T
from studiosr_tpu_torch.utils.helpers import get_image_files, imread

__all__ = ["PairedImageDataset"]


class PairedImageDataset:
    """Index-based paired (lq, gt) image dataset.

    ``transform=True`` applies the standard SR training augmentation;
    ``to_tensor=True`` converts to float32 [0, 1] HWC."""

    def __init__(
        self,
        gt_path: str,
        lq_path: str,
        size: int = 48,
        scale: int = 4,
        transform: bool = False,
        to_tensor: bool = False,
    ) -> None:
        self.gt_path = gt_path
        self.lq_path = lq_path
        self.files = get_image_files(gt_path)
        self._init_pipeline(size, scale, transform, to_tensor)

    def _init_pipeline(self, size: int, scale: int, transform: bool, to_tensor: bool) -> None:
        self.size = size
        self.scale = scale
        self.transform = (
            T.Compose(
                [
                    T.RandomCrop(self.size, self.scale),
                    T.RandomHorizontalFlip(),
                    T.RandomVerticalFlip(),
                    T.RandomRotation90(),
                ]
            )
            if transform
            else None
        )
        self.to_tensor = T.ToArray() if to_tensor else None

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.get(idx)

    def get(self, idx: int, rng: Optional[random.Random] = None) -> Tuple[np.ndarray, np.ndarray]:
        lq, gt = self.get_image_pair(idx)
        if self.transform is not None:
            lq, gt = self.transform(lq, gt, rng=rng)
        if self.to_tensor is not None:
            lq, gt = self.to_tensor(lq, gt)
        return lq, gt

    def get_image_pair(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        file = self.files[idx]
        return imread(os.path.join(self.lq_path, file)), imread(os.path.join(self.gt_path, file))
