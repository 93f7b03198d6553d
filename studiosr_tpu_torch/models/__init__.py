"""Models of the port (NHWC, PyTorch): the JAX package's twelve."""

from studiosr_tpu_torch.models.edsr import EDSR
from studiosr_tpu_torch.models.espcn import ESPCN
from studiosr_tpu_torch.models.han import HAN
from studiosr_tpu_torch.models.hat import HAT
from studiosr_tpu_torch.models.imdn import IMDN
from studiosr_tpu_torch.models.maxsr import MaxSR
from studiosr_tpu_torch.models.rcan import RCAN
from studiosr_tpu_torch.models.srcnn import SRCNN
from studiosr_tpu_torch.models.srresnet import SRResNet
from studiosr_tpu_torch.models.swinfir import SwinFIR
from studiosr_tpu_torch.models.swinir import SwinIR
from studiosr_tpu_torch.models.vdsr import VDSR

__all__ = ["EDSR", "ESPCN", "HAN", "HAT", "IMDN", "MaxSR", "RCAN", "SRCNN", "SRResNet", "SwinFIR", "SwinIR", "VDSR"]
