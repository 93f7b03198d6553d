from studiosr_tpu_torch.utils.helpers import (
    Logger,
    check_state_shapes,
    count_parameters,
    download,
    download_gdrive,
    gdown_and_extract,
    get_image_files,
    imread,
    imwrite,
)
from studiosr_tpu_torch.utils.losses import CharbonnierLoss, charbonnier_loss, get_loss, l1_loss, l2_loss
from studiosr_tpu_torch.utils.metrics import (
    compute_psnr,
    compute_psnr_torch,
    compute_ssim,
    compute_ssim_torch,
    crop_img_to_equal,
    to_y,
)

__all__ = [
    "Logger",
    "check_state_shapes",
    "count_parameters",
    "download",
    "download_gdrive",
    "gdown_and_extract",
    "get_image_files",
    "imread",
    "imwrite",
    "CharbonnierLoss",
    "charbonnier_loss",
    "get_loss",
    "l1_loss",
    "l2_loss",
    "compute_psnr",
    "compute_psnr_torch",
    "compute_ssim",
    "compute_ssim_torch",
    "crop_img_to_equal",
    "to_y",
]
