from studiosr_tpu_torch.utils.helpers import Logger, get_image_files, imread, imwrite
from studiosr_tpu_torch.utils.losses import CharbonnierLoss, charbonnier_loss, get_loss, l1_loss, l2_loss

__all__ = [
    "Logger",
    "get_image_files",
    "imread",
    "imwrite",
    "CharbonnierLoss",
    "charbonnier_loss",
    "get_loss",
    "l1_loss",
    "l2_loss",
]
