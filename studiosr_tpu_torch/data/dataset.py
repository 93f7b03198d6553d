"""Paired LR/HR image datasets: PairedImageDataset, DIV2K, Flickr2K, DF2K.

Port of ``studiosr_tpu/data/dataset.py``: files paired by identical name
under the gt and lq directories, the standard SR training augmentation
(scale-coupled crop + flips + rot90, ``transforms.py``) and the optional
float32 conversion, yielding numpy HWC arrays. ``get(idx, rng)`` draws from
an explicit ``random.Random``, as the loader seeds it per sample.

* ``extract_subimages`` / ``prepare_dataset``: the JAX package's offline
  sub-image grids (HR 480/240, LR X2 240/120, X3 160/80, X4 120/60), the
  edge-snapped last crop, the ``_{index:03d}.png`` names, the trailing-only
  ``x2`` / ``x3`` / ``x4`` strip, nested names flattened, each pack built in
  ``<out>.partial`` and renamed into place when whole; the same errors. The
  pixels go through the port's ``imread`` / ``imwrite`` (PNG by the port's
  codec, no cv2, no tqdm): the sub-images decode to the RGB that the JAX
  package's cv2 crops decode to;
* ``DIV2K`` / ``Flickr2K`` / ``DF2K``: the same constructors, on-disk paths
  (``<dataset_dir>/<name>/sub``) and per-pack resume; ``download`` fetches
  the same Google-Drive archives through ``utils/helpers.py``
  (``urllib``);
* the default training pipeline (``transform`` and ``to_tensor``) of a
  3-channel uint8 pair crops, augments and normalizes in one C++ pass
  (``native/augment.cpp``) with the numpy pipeline's random draws and
  bits; elsewhere, or where the host library cannot be built, the numpy
  pipeline runs. ``native.counters()["crop_augment"]`` counts the routes.

Images are read with ``utils/helpers.py::imread``. Subclasses that hold
their pairs elsewhere (in memory) override :meth:`get_image_pair`.
"""

from __future__ import annotations

import os
import random
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from studiosr_tpu_torch import native
from studiosr_tpu_torch.data import transforms as T
from studiosr_tpu_torch.utils.helpers import gdown_and_extract, get_image_files, imread, imwrite

__all__ = ["PairedImageDataset", "DIV2K", "Flickr2K", "DF2K", "extract_subimages", "prepare_dataset"]


def _native_crop_augment(lq, gt, size, scale, rng):
    """One-pass C++ crop + flip + rot90 + normalize with the numpy
    pipeline's random draws; None where it does not apply (not a 3-channel
    uint8 pair at an exact scale multiple) or the library is unavailable."""
    if not (
        lq.dtype == np.uint8
        and gt.dtype == np.uint8
        and lq.ndim == 3
        and lq.shape[2] == 3
        and gt.shape == (lq.shape[0] * scale, lq.shape[1] * scale, 3)
    ):
        return None
    if not native.available():
        return None
    r = rng if rng is not None else random
    h, w = lq.shape[:2]
    xs = r.randint(0, w - size)
    ys = r.randint(0, h - size)
    fliplr = r.random() < 0.5
    flipud = r.random() < 0.5
    rot90 = r.random() < 0.5
    return native.paired_crop_augment(lq, gt, size, scale, xs, ys, fliplr, flipud, rot90)


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
        if self.transform is not None and self.to_tensor is not None:
            fast = _native_crop_augment(lq, gt, self.size, self.scale, rng)
            if fast is not None:
                native.count("crop_augment", "native")
                return fast
            native.count("crop_augment", "numpy")
        if self.transform is not None:
            lq, gt = self.transform(lq, gt, rng=rng)
        if self.to_tensor is not None:
            lq, gt = self.to_tensor(lq, gt)
        return lq, gt

    def get_image_pair(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        file = self.files[idx]
        return imread(os.path.join(self.lq_path, file)), imread(os.path.join(self.gt_path, file))


def _grid(length: int, crop_size: int, step: int) -> np.ndarray:
    """Crop offsets along one side: every ``step``, then one snapped to the edge."""
    starts = np.arange(0, length - crop_size + 1, step)
    if length - (starts[-1] + crop_size) > 0:
        starts = np.append(starts, length - crop_size)
    return starts


def _sub_name(file: str) -> str:
    """The crops' stem: separators of a nested name flattened, a trailing
    ``x2`` / ``x3`` / ``x4`` (the LR corpora's 0001x4.png) stripped."""
    name = os.path.splitext(file)[0].replace(os.sep, "_").replace("/", "_")
    for tag in ("x2", "x3", "x4"):
        if name.endswith(tag):
            name = name[: -len(tag)]
    return name


def _extract_one(input_dir: str, file: str, out_dir: str, crop_size: int, step: int) -> int:
    path = os.path.join(input_dir, file)
    try:
        image = imread(path)
    except (FileNotFoundError, ValueError) as e:
        raise ValueError(f"unreadable image in dataset: {path}") from e
    h, w = image.shape[:2]
    if h < crop_size or w < crop_size:
        raise ValueError(
            f"extract_subimages: {path} is {h}x{w}, smaller than "
            f"crop_size {crop_size} — remove it or reduce crop_size"
        )
    name = _sub_name(file)
    index = 0
    for y in _grid(h, crop_size, step):
        for x in _grid(w, crop_size, step):
            index += 1
            imwrite(os.path.join(out_dir, name + f"_{index:03d}.png"), image[y : y + crop_size, x : x + crop_size])
    return index


def extract_subimages(input_dir: str, output_dir: str, crop_size: int, step: int) -> None:
    """Sliding-window sub-image extraction with edge-snapped final crops.

    Atomic: crops are written to ``<output_dir>.partial`` and the directory
    is renamed into place only when every image succeeded, so an interrupted
    prepare re-runs instead of leaving a half-built pack that the existence
    checks would skip. Up to eight threads decode and encode images (zlib
    and the host library release the GIL); the files written do not depend
    on them. Prints one line when the pack is done."""
    files = get_image_files(input_dir)
    if not files:
        # The raw corpus is missing (a prebuilt `sub` archive without the
        # originals, say): fail loudly rather than build an empty grid.
        raise FileNotFoundError(f"no images under {input_dir} to extract sub-images from")
    start = time.perf_counter()
    partial_dir = output_dir.rstrip(os.sep) + ".partial"
    if os.path.exists(partial_dir):
        shutil.rmtree(partial_dir)  # stale leftover from an interrupted run
    os.makedirs(partial_dir)
    with ThreadPoolExecutor(max_workers=min(8, len(files))) as pool:
        counts = list(pool.map(lambda f: _extract_one(input_dir, f, partial_dir, crop_size, step), files))
    if os.path.exists(output_dir):
        shutil.rmtree(output_dir)  # direct re-extraction over an old grid
    os.replace(partial_dir, output_dir)
    print(f"{output_dir}: {sum(counts)} sub-images of {crop_size} from {len(files)} images "
          f"({time.perf_counter() - start:.1f} s)")


def prepare_dataset(dataset_dir: str, dataset_name: str, postfix: str = "") -> None:
    """Build the HR + LR X2/X3/X4 sub-image grids, skipping each pack that
    is already complete."""
    dataset_dir = os.path.join(dataset_dir, dataset_name)
    sub_dir = os.path.join(dataset_dir, "sub")
    packs = [
        dict(dir_name=f"{dataset_name}{postfix}_HR", crop_size=480, step=240),
        dict(dir_name=f"{dataset_name}{postfix}_LR_bicubic/X2", crop_size=240, step=120),
        dict(dir_name=f"{dataset_name}{postfix}_LR_bicubic/X3", crop_size=160, step=80),
        dict(dir_name=f"{dataset_name}{postfix}_LR_bicubic/X4", crop_size=120, step=60),
    ]
    for pack in packs:
        output_dir = os.path.join(sub_dir, pack["dir_name"])
        if not os.path.exists(output_dir):
            extract_subimages(
                input_dir=os.path.join(dataset_dir, pack["dir_name"]),
                output_dir=output_dir,
                crop_size=pack["crop_size"],
                step=pack["step"],
            )


class DIV2K(PairedImageDataset):
    dataset_name = "DIV2K"
    gdrive_id = "1rhaiGcXoivv5pJKIf7Wy1QJHZ-tgiyB4"

    def __init__(
        self,
        dataset_dir: str,
        size: int = 48,
        scale: int = 4,
        transform: bool = False,
        to_tensor: bool = False,
        download: bool = False,
    ):
        if download:
            self.download(dataset_dir=dataset_dir)
        dataset_path = os.path.join(dataset_dir, f"{self.dataset_name}/sub")
        # prepare skips each complete pack, so an interrupted run resumes the
        # missing ones (a check of `sub` alone would skip them forever)
        self.prepare(dataset_dir=dataset_dir)
        super().__init__(
            gt_path=os.path.join(dataset_path, f"{self.dataset_name}_train_HR"),
            lq_path=os.path.join(dataset_path, f"{self.dataset_name}_train_LR_bicubic/X{scale}"),
            size=size,
            scale=scale,
            transform=transform,
            to_tensor=to_tensor,
        )

    @classmethod
    def download(cls, dataset_dir: str) -> None:
        gdown_and_extract(id=cls.gdrive_id, save_dir=dataset_dir)

    @classmethod
    def prepare(cls, dataset_dir: str) -> None:
        prepare_dataset(dataset_dir, cls.dataset_name, "_train")


class Flickr2K(PairedImageDataset):
    dataset_name = "Flickr2K"
    gdrive_id = "1--pNeHQlsaIWPzSnnIPzmvPpimdIhN5C"

    def __init__(
        self,
        dataset_dir: str,
        size: int = 48,
        scale: int = 4,
        transform: bool = False,
        to_tensor: bool = False,
        download: bool = False,
    ):
        if download:
            self.download(dataset_dir=dataset_dir)
        dataset_path = os.path.join(dataset_dir, f"{self.dataset_name}/sub")
        self.prepare(dataset_dir=dataset_dir)  # per-pack skip; resumes partial runs
        super().__init__(
            gt_path=os.path.join(dataset_path, f"{self.dataset_name}_HR"),
            lq_path=os.path.join(dataset_path, f"{self.dataset_name}_LR_bicubic/X{scale}"),
            size=size,
            scale=scale,
            transform=transform,
            to_tensor=to_tensor,
        )

    @classmethod
    def download(cls, dataset_dir: str) -> None:
        gdown_and_extract(id=cls.gdrive_id, save_dir=dataset_dir)

    @classmethod
    def prepare(cls, dataset_dir: str) -> None:
        prepare_dataset(dataset_dir, cls.dataset_name)


class DF2K(PairedImageDataset):
    """DIV2K + Flickr2K as one training corpus: the shared sample pipeline
    of :class:`PairedImageDataset`, its pairs indexed by path across the
    two corpora."""

    def __init__(
        self,
        dataset_dir: str,
        size: int = 48,
        scale: int = 4,
        transform: bool = False,
        to_tensor: bool = False,
        download: bool = False,
    ):
        if download:
            DIV2K.download(dataset_dir=dataset_dir)
            Flickr2K.download(dataset_dir=dataset_dir)
        DIV2K.prepare(dataset_dir=dataset_dir)  # per-pack skip; resumes partial runs
        Flickr2K.prepare(dataset_dir=dataset_dir)
        div2k_path = os.path.join(dataset_dir, "DIV2K/sub")
        flickr2k_path = os.path.join(dataset_dir, "Flickr2K/sub")

        self.file_paths: List[Tuple[str, str]] = []
        for gt_dir, lq_dir in [
            (os.path.join(div2k_path, "DIV2K_train_HR"), os.path.join(div2k_path, f"DIV2K_train_LR_bicubic/X{scale}")),
            (os.path.join(flickr2k_path, "Flickr2K_HR"), os.path.join(flickr2k_path, f"Flickr2K_LR_bicubic/X{scale}")),
        ]:
            for f in get_image_files(gt_dir):
                self.file_paths.append((os.path.join(lq_dir, f), os.path.join(gt_dir, f)))
        self._init_pipeline(size, scale, transform, to_tensor)

    def __len__(self) -> int:
        return len(self.file_paths)

    def get_image_pair(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        lq_path, gt_path = self.file_paths[idx]
        return imread(lq_path), imread(gt_path)
