"""Fused serving paths on the CUDA kernels."""

from studiosr_tpu_torch.serving.swinir_fast import prepare_serving, swinir_fast_forward

__all__ = ["prepare_serving", "swinir_fast_forward"]
