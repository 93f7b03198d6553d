"""Models of the port (NHWC, PyTorch)."""

from studiosr_tpu_torch.models.hat import HAT
from studiosr_tpu_torch.models.swinir import SwinIR

__all__ = ["HAT", "SwinIR"]
