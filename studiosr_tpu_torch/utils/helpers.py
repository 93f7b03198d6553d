"""Host-side I/O, logging, downloads and checkpoint checks.

Port of ``studiosr_tpu/utils/helpers.py``:

* ``imread`` / ``imwrite``: RGB uint8 HWC. PNG goes through the port's own
  codec (``utils/png.py``, numpy and ``zlib``), which reads as cv2's
  ``IMREAD_COLOR`` does; every other format (and a PNG of another bit depth,
  or interlaced) goes through cv2, imported when called, and raises
  ``ImportError`` naming the file where cv2 is missing;
* ``download`` / ``download_gdrive`` / ``gdown_and_extract``: the
  Evaluator's dataset download, on ``urllib`` (the JAX package uses
  ``requests``), streamed to a ``.part`` file and renamed when complete;
* ``check_state_shapes``: the counterpart of ``check_tree_shapes`` for
  state_dict loads; ``count_parameters``; ``Logger``; ``get_image_files``.
"""

from __future__ import annotations

import http.cookiejar
import logging
import os
import re
import tempfile
import urllib.parse
import urllib.request
import zipfile
from typing import Any, List, Mapping, Optional

import numpy as np

from studiosr_tpu_torch.utils.png import UnsupportedPNG, read_png, write_png

__all__ = [
    "imread", "imwrite", "Logger", "get_image_extensions", "get_image_files", "download", "download_gdrive",
    "gdown_and_extract", "check_state_shapes", "count_parameters",
]


def _cv2(path: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{path}: reading or writing this file needs cv2, which is not installed") from e
    return cv2


def _is_png(path: str) -> bool:
    return os.path.splitext(path)[1].lower() == ".png"


def imread(path: str) -> np.ndarray:
    """Read an image as RGB uint8 HWC."""
    if _is_png(path):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"could not read image: {path}")
        try:
            return read_png(path)
        except UnsupportedPNG:
            pass  # another bit depth or interlaced: cv2 decodes it
    cv2 = _cv2(path)
    image = cv2.imread(path, cv2.IMREAD_COLOR)
    if image is None:
        raise FileNotFoundError(f"could not read image: {path}")
    return cv2.cvtColor(image, cv2.COLOR_BGR2RGB)


def imwrite(path: str, image: np.ndarray) -> bool:
    """Write an RGB uint8 HWC image."""
    if _is_png(path):
        write_png(path, np.asarray(image))
        return True
    cv2 = _cv2(path)
    image = cv2.cvtColor(np.asarray(image), cv2.COLOR_RGB2BGR)
    return bool(cv2.imwrite(path, image))


def check_state_shapes(saved: Mapping[str, Any], target: Mapping[str, Any], context: str = "checkpoint") -> None:
    """Raise unless ``saved`` has exactly ``target``'s keys, each leaf of the
    same shape. A checkpoint whose ``params.json`` was edited (or whose files
    were mixed between runs) fails here, naming the file and the leaf,
    instead of deep inside a forward."""
    missing = sorted(set(target) - set(saved))
    unknown = sorted(set(saved) - set(target))
    if missing or unknown:
        raise ValueError(
            f"{context}: checkpoint keys differ from the model's (missing {missing[:5]}, unknown {unknown[:5]}) "
            "-- model config drift?"
        )
    for key, t in target.items():
        if tuple(np.shape(saved[key])) != tuple(t.shape):
            raise ValueError(
                f"{context} shape mismatch at {key}: saved {tuple(np.shape(saved[key]))} vs model {tuple(t.shape)} "
                "-- model config drift?"
            )


def count_parameters(model) -> int:
    """Parameters of a model wrapper (``.module``), an ``nn.Module`` or a
    mapping of tensors."""
    module = getattr(model, "module", model)
    if hasattr(module, "parameters"):
        return int(sum(p.numel() for p in module.parameters()))
    return int(sum(np.prod(np.shape(v)) for v in module.values()))


def _build_opener() -> urllib.request.OpenerDirector:
    """A cookie-keeping URL opener (the tests replace this)."""
    return urllib.request.build_opener(urllib.request.HTTPCookieProcessor(http.cookiejar.CookieJar()))


def _with_query(url: str, params: Optional[dict]) -> str:
    return url if not params else f"{url}{'&' if '?' in url else '?'}{urllib.parse.urlencode(params)}"


def _is_html(response) -> bool:
    return "text/html" in (response.headers.get("content-type") or "")


def _save_stream(response, dst: str, chunk_size: int = 1 << 20) -> None:
    tmp = dst + ".part"
    with open(tmp, "wb") as f:
        while True:
            data = response.read(chunk_size)
            if not data:
                break
            f.write(data)
    os.replace(tmp, dst)


def download(src: str, dst: str, chunk_size: int = 1 << 20) -> None:
    """Stream a URL to a local file (``dst.part``, renamed when complete)."""
    with _build_opener().open(src, timeout=60) as response:
        _save_stream(response, dst, chunk_size)


_GDRIVE_URL = "https://drive.google.com/uc?export=download"


def download_gdrive(id: str, output: str) -> str:
    """Download a (possibly large) public Google-Drive file by id, following
    the confirm-token step of large files (a ``download_warning`` cookie, or
    a confirm form in an HTML body). Raises ``IOError`` if Drive still
    answers with an HTML page, rather than saving the page as the file."""
    opener = _build_opener()
    response = opener.open(_with_query(_GDRIVE_URL, {"id": id}), timeout=60)
    jar = next((h.cookiejar for h in getattr(opener, "handlers", []) if hasattr(h, "cookiejar")), [])
    token = next((c.value for c in jar if c.name.startswith("download_warning")), None)
    if token is None and _is_html(response):
        body = response.read().decode("utf-8", "replace")
        confirm = re.search(r'name="confirm" value="([^"]+)"', body)
        uuid = re.search(r'name="uuid" value="([^"]+)"', body)
        action = re.search(r'action="([^"]+)"', body)
        if confirm and action:
            params = {"id": id, "confirm": confirm.group(1), "export": "download"}
            if uuid:
                params["uuid"] = uuid.group(1)
            response = opener.open(_with_query(action.group(1), params), timeout=60)
    elif token is not None:
        response = opener.open(_with_query(_GDRIVE_URL, {"id": id, "confirm": token}), timeout=60)
    with response:
        if _is_html(response):
            raise IOError(
                f"Google Drive returned an HTML page instead of file {id!r} (quota exceeded or confirm-form layout "
                "changed)"
            )
        _save_stream(response, output)
    return output


def gdown_and_extract(id: str, save_dir: str) -> None:
    """Download a Google-Drive zip by id and extract it into ``save_dir``."""
    with tempfile.TemporaryDirectory() as temp_dir:
        zip_path = os.path.join(temp_dir, "tmp.zip")
        download_gdrive(id=id, output=zip_path)
        with zipfile.ZipFile(zip_path, "r") as zip_ref:
            zip_ref.extractall(save_dir)


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
