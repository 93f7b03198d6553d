"""PyTorch / CUDA port of ``studiosr_tpu`` for NVIDIA Hopper.

Mirrors the JAX package's layout and names (``models/swinir.py``,
``serving/swinir_fast.py``, ...). Activations are NHWC at every public
function. The Pallas TPU kernels of the serving and training paths are
hand-written CUDA C++ kernels under ``csrc/``, built with ``nvcc`` on first
use (``ops/cuda/_build.py``); each has a plain PyTorch version beside it
that runs only on CPU tensors. ``python3 -m studiosr_tpu_torch`` is the CLI
upscaler.

This package imports neither JAX nor anything of ``studiosr_tpu``.
"""

from studiosr_tpu_torch._device import resolve_device
from studiosr_tpu_torch.data import DF2K, DIV2K, DataHandler, DataIterator, Flickr2K, PairedImageDataset
from studiosr_tpu_torch.engine import Evaluator, Evaluator2, Trainer, benchmark
from studiosr_tpu_torch.models import (
    EDSR, ESPCN, HAN, HAT, IMDN, RCAN, SRCNN, VDSR, MaxSR, Model, SRResNet, SwinFIR, SwinIR,
)
from studiosr_tpu_torch.utils import (
    CharbonnierLoss, Logger, charbonnier_loss, compare, compute_psnr, compute_psnr_torch, compute_ssim,
    compute_ssim_torch, count_parameters, crop_img_to_equal, download, download_gdrive, gdown_and_extract,
    get_image_extensions, get_image_files, get_loss, imread, imwrite, is_rgb, l1_loss, l2_loss, to_y,
)
from studiosr_tpu_torch.zoo import fetch, load_model

__all__ = [
    "CharbonnierLoss", "DF2K", "DIV2K", "DataHandler", "DataIterator", "EDSR", "ESPCN", "Evaluator", "Evaluator2",
    "Flickr2K", "HAN", "HAT", "IMDN", "Logger", "MaxSR", "Model", "PairedImageDataset", "RCAN", "SRCNN", "SRResNet",
    "SwinFIR", "SwinIR", "Trainer", "VDSR", "benchmark", "charbonnier_loss", "compare", "compute_psnr",
    "compute_psnr_torch", "compute_ssim", "compute_ssim_torch", "count_parameters", "crop_img_to_equal", "download",
    "download_gdrive", "fetch", "gdown_and_extract", "get_image_extensions", "get_image_files", "get_loss", "imread",
    "imwrite", "is_rgb", "l1_loss", "l2_loss", "load_model", "resolve_device", "to_y",
]
