"""Benchmark evaluation: Y-channel, border-cropped PSNR / SSIM over paired sets.

Port of ``studiosr_tpu/engine/evaluator.py``, with the same protocol and
dataset layouts: ``Evaluator`` reads the ``GTmod12`` / ``LRbicx{scale}``
layout (the Set5 / ... / DIV2K_mini Google-Drive table), ``Evaluator2`` the
``HR`` / ``LR_bicubic/X{scale}`` layout, and ``benchmark`` prints the
markdown table of a sweep. A missing dataset is downloaded and extracted
under ``root``.

``run(func)`` scores on the host with the numpy protocol by default.
``on_device=True`` with a model (an object with ``evaluate_uint8``) runs the
forward and both metrics on the model's device and brings back two floats
an image; with a bare callable it scores its output with the device
metrics on the card. ``visualize`` needs ``utils/compare.py``, which is
not ported (ROADMAP A18).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from studiosr_tpu_torch._device import resolve_device
from studiosr_tpu_torch.data import PairedImageDataset
from studiosr_tpu_torch.utils.helpers import gdown_and_extract
from studiosr_tpu_torch.utils.metrics import compute_psnr, compute_psnr_torch, compute_ssim, compute_ssim_torch

__all__ = ["Evaluator", "Evaluator2", "benchmark"]


class _EvaluatorBase:
    dataset: str
    scale: int
    testset: PairedImageDataset

    DATASET_IDS: dict = {}
    DATASET_ROOT = "dataset"

    @classmethod
    def download_dataset(cls, root: Optional[str] = None, dataset: str = "Set5") -> str:
        root = cls.DATASET_ROOT if root is None else root
        benchmark_path = os.path.join(root, dataset)
        if not os.path.exists(benchmark_path):
            os.makedirs(root, exist_ok=True)
            gdown_and_extract(id=cls.DATASET_IDS[dataset], save_dir=root)
        return benchmark_path

    def __call__(
        self,
        func: Callable[[np.ndarray], np.ndarray],
        y_only: bool = True,
        visualize: bool = False,
        logging: bool = True,
    ) -> Tuple[float, float]:
        psnr, ssim = self.run(func, y_only, visualize, logging)
        print(f" {self.dataset:>8} - Average PSNR: {psnr:6.3f}, SSIM: {ssim:6.4f}")
        return psnr, ssim

    def run(
        self,
        func: Callable[[np.ndarray], np.ndarray],
        y_only: bool = True,
        visualize: bool = False,
        logging: bool = False,
        on_device: bool = False,
    ) -> Tuple[float, float]:
        if visualize:
            raise NotImplementedError("Evaluator visualize=True needs utils/compare.py, not ported (ROADMAP A18)")
        crop_border = self.scale
        device_pair = on_device and hasattr(func, "evaluate_uint8")
        metric_device = None
        if on_device and not device_pair:
            metric_device = resolve_device("cuda")
        psnrs, ssims = [], []
        for i in range(len(self.testset)):
            lq, gt = self.testset[i]
            if device_pair:
                psnr, ssim = func.evaluate_uint8(lq, gt, crop_border=crop_border, y_only=y_only)
            else:
                sr = func.inference(lq) if hasattr(func, "inference") else func(lq)
                if on_device:
                    sr_t = torch.from_numpy(np.ascontiguousarray(sr)).to(metric_device)
                    gt_t = torch.from_numpy(np.ascontiguousarray(gt)).to(metric_device)
                    psnr = float(compute_psnr_torch(sr_t, gt_t, crop_border=crop_border, y_only=y_only))
                    ssim = float(compute_ssim_torch(sr_t, gt_t, crop_border=crop_border, y_only=y_only))
                else:
                    psnr = compute_psnr(sr, gt, crop_border=crop_border, y_only=y_only)
                    ssim = compute_ssim(sr, gt, crop_border=crop_border, y_only=y_only)
            psnrs.append(psnr)
            ssims.append(ssim)
            if logging:
                print(
                    f" {self.dataset:>8} - {i + 1:>3}/{len(self.testset):>3} PSNR: {psnr:6.3f}, SSIM: {ssim:6.4f}",
                    end="\r",
                )
        return float(np.mean(psnrs)), float(np.mean(ssims))


class Evaluator(_EvaluatorBase):
    """The GTmod12 / LRbicx{scale} layout."""

    DATASET_IDS = {
        "Set5": "18bimJIcXV0nxYU9y64Liwo63afEZXlAY",
        "Set14": "1Wn8mJRFT7N4z0cGbqwGev4ltbLwi4Sg2",
        "BSD100": "1qoiBkwiUgv62MISQh4A4nibdmDfP5qzJ",
        "Urban100": "1YTYp0gVJj2gpIsL3N8NkEDKEPIZeyhnf",
        "Manga109": "1ZaUD3ZeaaI3zHlEI6HRSx0baBU2CeYe7",
        "DIV2K": "1kUlppta5vEmXa76EHU_mb6_EoibNWlXw",
        "DIV2K_mini": "1pDEDDuYzaRzmJb6ztZTafeui1xE6iCz9",
    }

    def __init__(self, dataset: str = "DIV2K_mini", scale: int = 4, root: str = "dataset") -> None:
        self.dataset = dataset
        self.scale = scale
        self.root = root
        root = self.download_dataset(self.root, self.dataset)
        gt_mod = 12 if scale in [2, 3, 4] else scale
        self.testset = PairedImageDataset(os.path.join(root, f"GTmod{gt_mod}"), os.path.join(root, f"LRbicx{scale}"))

    @staticmethod
    def benchmark(
        func: Callable[[np.ndarray], np.ndarray],
        scale: int = 4,
        y_only: bool = True,
        datasets: List[str] = ["Set5", "Set14", "BSD100", "Urban100", "Manga109"],
        on_device: bool = False,
    ) -> Tuple[List[float], List[float]]:
        return _benchmark_table(Evaluator, func, scale, y_only, datasets, on_device)


class Evaluator2(_EvaluatorBase):
    """The HR / LR_bicubic/X{scale} layout."""

    DATASET_IDS = {
        "Set5": "1ewFsDc-FdxierrNv8bGp4tE1BJzccyyr",
        "Set14": "1r_G-bFrjt-1puTJTMAxeLaI-fyiqlHN_",
        "BSD100": "1JAqwq03cu73HImotXxudstGPSyXB74eA",
        "Urban100": "1srG5FmDmnogUzvOywH7i2QfUnLsNGmxb",
    }

    DATASET_ROOT = "dataset/benchmark"

    def __init__(self, dataset: str = "Set5", scale: int = 4, root: str = "dataset/benchmark") -> None:
        self.dataset = dataset
        self.scale = scale
        self.root = root
        root = self.download_dataset(self.root, self.dataset)
        self.testset = PairedImageDataset(os.path.join(root, "HR"), os.path.join(root, "LR_bicubic", f"X{scale}"))


def _benchmark_table(evaluator_cls, func, scale, y_only, datasets, on_device=False):
    log_data, log_line, log_psnr, log_ssim = "| Metric |", "| ------ |", "|   PSNR |", "|   SSIM |"
    psnr_list, ssim_list = [], []
    for dataset in datasets:
        psnr, ssim = evaluator_cls(dataset, scale).run(func, y_only, logging=True, on_device=on_device)
        log_data += " %10s |" % dataset
        log_line += " ---------- |"
        log_psnr += " %10.3f |" % psnr
        log_ssim += " %10.4f |" % ssim
        psnr_list.append(psnr)
        ssim_list.append(ssim)
    print(log_data)
    print(log_line)
    print(log_psnr)
    print(log_ssim)
    print()
    return psnr_list, ssim_list


def benchmark(
    func: Callable[[np.ndarray], np.ndarray],
    scale: int = 4,
    y_only: bool = True,
    datasets: List[str] = ["Set5", "Set14", "BSD100", "Urban100"],
    on_device: bool = False,
) -> Tuple[List[float], List[float]]:
    """A sweep over the Evaluator2 layout; ``on_device=True`` with a model
    scores each image on its device (two floats fetched an image)."""
    return _benchmark_table(Evaluator2, func, scale, y_only, datasets, on_device)
