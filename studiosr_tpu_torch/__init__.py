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
from studiosr_tpu_torch.models import EDSR, ESPCN, HAN, HAT, IMDN, RCAN, SRCNN, VDSR, MaxSR, SRResNet, SwinFIR, SwinIR
from studiosr_tpu_torch.zoo.registry import load_model

__all__ = [
    "DF2K", "DIV2K", "DataHandler", "DataIterator", "EDSR", "ESPCN", "Evaluator", "Evaluator2", "Flickr2K", "HAN",
    "HAT", "IMDN", "MaxSR", "PairedImageDataset", "RCAN", "SRCNN", "SRResNet", "SwinFIR", "SwinIR", "Trainer", "VDSR",
    "benchmark", "load_model", "resolve_device",
]
