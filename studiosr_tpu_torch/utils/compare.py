"""Interactive side-by-side image comparison.

Port of ``studiosr_tpu/utils/compare.py``: a numpy-only core, an immutable
:class:`ViewerState` and a pure :func:`render` of (panorama with crop
boxes, zoomed crop strip), and a thin cv2 event-loop shell,
:func:`compare`, which imports cv2 only when called (the card's machine has
none, so there it raises ``ImportError``). A capture is written as PNG by
the port's own codec (``utils/png.py``), so it needs no cv2. Beyond the
reference's mouse-tracked crop and zoomed strip: a difference-heatmap mode
(``d``) and a PSNR-vs-first-image overlay (``p``).

Keys: ESC quit · c capture crop strip to ./captures · a/s shrink/grow crop
box · z/x shrink/grow zoom · d toggle difference heatmap · p toggle PSNR.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Tuple

import numpy as np

from studiosr_tpu_torch.utils.png import write_png

__all__ = ["compare", "ViewerState", "render"]

_BOX_COLOR = (0, 255, 0)
_MIN_CROP, _MIN_ZOOM, _MAX_ZOOM = 8, 32, 512


@dataclasses.dataclass(frozen=True)
class ViewerState:
    """Immutable viewer state; every event produces a new state."""

    width: int
    height: int
    cursor: Tuple[int, int]
    crop: int = 64
    zoom: int = 256
    show_diff: bool = False
    show_psnr: bool = False

    def with_cursor(self, x: int, y: int) -> "ViewerState":
        return dataclasses.replace(self, cursor=(x % self.width, y % self.height))

    def with_crop_delta(self, delta: int) -> "ViewerState":
        crop = int(np.clip(self.crop + delta, _MIN_CROP, min(self.width, self.height)))
        return dataclasses.replace(self, crop=crop)

    def with_zoom_delta(self, delta: int) -> "ViewerState":
        return dataclasses.replace(self, zoom=int(np.clip(self.zoom + delta, _MIN_ZOOM, _MAX_ZOOM)))

    def toggled(self, field: str) -> "ViewerState":
        return dataclasses.replace(self, **{field: not getattr(self, field)})

    @property
    def crop_rect(self) -> Tuple[int, int, int, int]:
        """(y0, x0, y1, x1), clamped so the box stays inside the image.

        The crop itself is clamped to the image first: with crop > image,
        ``np.clip(low=0, high=negative)`` would return a NEGATIVE origin and
        the box/zoom would silently show the wrong region."""
        crop = min(self.crop, self.width, self.height)
        cx, cy = self.cursor
        x0 = int(np.clip(cx - crop // 2, 0, self.width - crop))
        y0 = int(np.clip(cy - crop // 2, 0, self.height - crop))
        return y0, x0, y0 + crop, x0 + crop


def _nearest_zoom(patch: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbour upsample via integer index maps (no cv2 needed)."""
    h, w = patch.shape[:2]
    rows = (np.arange(size) * h) // size
    cols = (np.arange(size) * w) // size
    return patch[rows][:, cols]


def _diff_heat(image: np.ndarray, base: np.ndarray) -> np.ndarray:
    """|image - base| amplified into a BGR heat image (uint8)."""
    d = np.abs(image.astype(np.int16) - base.astype(np.int16)).max(axis=-1)
    heat = np.clip(d * 4, 0, 255).astype(np.uint8)
    out = np.zeros_like(image)
    out[..., 2] = heat  # red channel (BGR)
    out[..., 0] = 255 - heat
    return out


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 20.0 * np.log10(255.0 / np.sqrt(mse))


def render(
    state: ViewerState, images: List[np.ndarray], draw_box=None, put_text=None
) -> Tuple[np.ndarray, np.ndarray]:
    """Pure frame renderer: (panorama with crop boxes, zoomed crop strip).

    ``draw_box``/``put_text`` are optional cv2 hooks; rendering works without
    them (box drawn by slicing), keeping the core import-free and testable.
    """
    y0, x0, y1, x1 = state.crop_rect
    shown = images
    if state.show_diff:
        shown = [images[0]] + [_diff_heat(im, images[0]) for im in images[1:]]

    panels, strip = [], []
    for idx, image in enumerate(shown):
        panel = image.copy()
        if draw_box is not None:
            draw_box(panel, (x0, y0), (x1 - 1, y1 - 1), _BOX_COLOR)
        else:  # pure fallback: 1px frame via slicing
            panel[y0, x0:x1] = _BOX_COLOR
            panel[y1 - 1, x0:x1] = _BOX_COLOR
            panel[y0:y1, x0] = _BOX_COLOR
            panel[y0:y1, x1 - 1] = _BOX_COLOR
        if state.show_psnr and put_text is not None and idx > 0:
            put_text(panel, f"{_psnr(images[idx], images[0]):.2f} dB", (8, 24))
        panels.append(panel)
        strip.append(_nearest_zoom(image[y0:y1, x0:x1], state.zoom))
    return np.concatenate(panels, axis=1), np.concatenate(strip, axis=1)


def _save_capture(strip: np.ndarray, directory: str = "./captures") -> str:
    """Write the BGR ``strip`` as an RGB PNG (the file cv2.imwrite writes)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{time.time_ns()}.png")
    write_png(path, np.ascontiguousarray(strip[..., ::-1]))
    return path


def compare(images: List[np.ndarray], crop_size: int = 64, zoom_size: int = 256) -> None:
    """Open the interactive viewer on a list of same-sized BGR images."""
    import cv2

    h, w = images[0].shape[:2]
    state = ViewerState(width=w, height=h, cursor=(w // 2, h // 2), crop=crop_size, zoom=zoom_size)
    state_box = {"state": state}  # cv2 callbacks cannot rebind closures

    def on_mouse(event, x, y, flags, param):
        if event == cv2.EVENT_MOUSEMOVE:
            state_box["state"] = state_box["state"].with_cursor(x, y)

    def draw_box(img, p0, p1, color):
        cv2.rectangle(img, p0, p1, color, 1)

    def put_text(img, text, org):
        cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 255, 0), 2)

    cv2.namedWindow("image-compare")
    cv2.namedWindow("image-crops")
    cv2.setMouseCallback("image-compare", on_mouse, None)

    actions = {
        ord("a"): lambda s: s.with_crop_delta(-4),
        ord("s"): lambda s: s.with_crop_delta(+4),
        ord("z"): lambda s: s.with_zoom_delta(-4),
        ord("x"): lambda s: s.with_zoom_delta(+4),
        ord("d"): lambda s: s.toggled("show_diff"),
        ord("p"): lambda s: s.toggled("show_psnr"),
    }

    while True:
        panorama, strip = render(state_box["state"], images, draw_box=draw_box, put_text=put_text)
        cv2.imshow("image-compare", panorama)
        cv2.imshow("image-crops", strip)
        key = cv2.waitKey(30)
        if key == 27:  # ESC
            break
        if key > 0:
            action = actions.get(ord(chr(key).lower()) if 0 < key < 256 else -1)
            if action is not None:
                state_box["state"] = action(state_box["state"])
            elif chr(key).lower() == "c":
                print("Capture Image ->", _save_capture(strip))
