"""Host-side I/O and logging (the parts the Trainer and datasets use).

Port of ``studiosr_tpu/utils/helpers.py``: ``imread`` / ``imwrite`` (RGB
uint8 HWC through cv2, imported when called), ``Logger``,
``get_image_files``. Downloads are not part of this port yet.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np

__all__ = ["imread", "imwrite", "Logger", "get_image_extensions", "get_image_files"]


def imread(path: str) -> np.ndarray:
    """Read an image as RGB uint8 HWC."""
    import cv2

    image = cv2.imread(path, cv2.IMREAD_COLOR)
    if image is None:
        raise FileNotFoundError(f"could not read image: {path}")
    return cv2.cvtColor(image, cv2.COLOR_BGR2RGB)


def imwrite(path: str, image: np.ndarray) -> bool:
    """Write an RGB uint8 HWC image."""
    import cv2

    image = cv2.cvtColor(np.asarray(image), cv2.COLOR_RGB2BGR)
    return bool(cv2.imwrite(path, image))


class Logger:
    """File and/or console logger."""

    def __init__(self, log_file: Optional[str] = None, log_level: int = logging.INFO, use_console: bool = False):
        self.logger = logging.getLogger(f"studiosr_tpu_torch.{log_file or 'console'}")
        self.logger.setLevel(log_level)
        self.logger.handlers.clear()
        self.logger.propagate = False
        if log_file:
            file_handler = logging.FileHandler(log_file)
            file_handler.setLevel(log_level)
            file_handler.setFormatter(logging.Formatter("%(asctime)s - %(message)s"))
            self.logger.addHandler(file_handler)
        if use_console or not log_file:
            console_handler = logging.StreamHandler()
            console_handler.setLevel(log_level)
            console_handler.setFormatter(logging.Formatter("%(message)s"))
            self.logger.addHandler(console_handler)

    def log(self, level: int, message: str) -> None:
        self.logger.log(level, message)

    def info(self, message: str) -> None:
        self.logger.info(message)

    def warning(self, message: str) -> None:
        self.logger.warning(message)

    def close(self) -> None:
        """Close and drop the handlers (the log file stays on disk)."""
        for handler in list(self.logger.handlers):
            handler.close()
            self.logger.removeHandler(handler)


def get_image_extensions() -> List[str]:
    return [".bmp", ".jpeg", ".jpg", ".jpe", ".jp2", ".png", ".webp", ".tiff", ".tif"]


def get_image_files(root: str) -> List[str]:
    """Image files under ``root``, recursively, as sorted paths relative to
    ``root``; AppleDouble junk (``__MACOSX/``, ``._*``) is skipped."""
    extensions = set(get_image_extensions())
    image_files = []
    for _root, _dirs, files in os.walk(root):
        _dirs[:] = [d for d in _dirs if d != "__MACOSX"]
        for f in files:
            if f.startswith("._"):
                continue
            if os.path.splitext(f)[1].lower() in extensions:
                image_files.append(os.path.relpath(os.path.join(_root, f), root))
    return sorted(image_files)
