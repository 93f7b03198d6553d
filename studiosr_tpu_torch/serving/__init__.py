"""Fused serving paths on the CUDA kernels."""

from studiosr_tpu_torch.serving.hat_fast import hat_fast_forward, prepare_hat_serving
from studiosr_tpu_torch.serving.swinir_fast import prepare_serving, swinir_fast_forward

__all__ = ["hat_fast_forward", "prepare_hat_serving", "prepare_serving", "swinir_fast_forward"]
