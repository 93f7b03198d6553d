"""Tiled-patch inference: fixed tile shape, batched, overlap-discard reassembly.

Port of ``studiosr_tpu/parallel/tiled.py``'s host loop:

  pad -> overlapping tiles of one shape -> batched uint8 forwards ->
  overlap-discard reassembly

* every forward sees the same (tile_batch, tile, tile, C) shape, whatever
  the image size: the tail batch is padded with zero tiles;
* uint8 crosses the host boundary both ways (``Model.forward_uint8``), and
  two batches are enqueued ahead of the copy back, so the host reassembles
  one batch while the device computes the next.

Window models are exactly tile-consistent when ``tile`` is a window
multiple; outputs differ from whole-image inference only through context
beyond the overlap, which ``tile_overlap`` controls.

``mesh`` (``parallel/mesh.py``) must hold only the model's device (a
process drives its own card) and gives the mesh-less call's output. Not
ported: ``device_loop=True`` (the JAX package's one-program
mode for the TPU); ``device_loop`` None or False takes the host loop.
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np
import torch

from studiosr_tpu_torch.parallel.mesh import check_devices

__all__ = ["tiled_inference", "tile_grid"]


def tile_grid(size: int, tile: int, stride: int) -> np.ndarray:
    """Start offsets covering [0, size) with final tile snapped to the edge."""
    if size <= tile:
        return np.array([0])
    starts = list(range(0, size - tile + 1, stride))
    if starts[-1] != size - tile:
        starts.append(size - tile)
    return np.array(starts)


def tiled_inference(
    model,
    image: np.ndarray,
    tile: int = 128,
    tile_overlap: int = 16,
    tile_batch: int = 8,
    mesh=None,
    device_loop: bool | None = None,
) -> np.ndarray:
    """uint8 HWC -> upscaled uint8 HWC via overlapping tiles.

    ``tile`` and ``tile_overlap`` are in LR pixels; tiles overlap by
    ``2 * tile_overlap`` and only each tile's interior is written to the
    output, except at the image borders, where the halo is kept."""
    if mesh is not None:
        check_devices(mesh, model.device)
    if device_loop:
        raise NotImplementedError("tiled_inference(device_loop=True): the one-program tile loop is not ported; "
                                  "device_loop None or False takes the host loop")
    scale = model.scale
    h, w, c = image.shape

    tile = min(tile, max(h, w))
    # an image smaller than the tile shrank it: clamp the overlap so the stride stays positive
    tile_overlap = min(tile_overlap, (tile - 1) // 2)
    stride = tile - 2 * tile_overlap
    assert stride > 0, "tile_overlap too large for tile size"

    # Pad so every tile fits: reflect, like the window models' own padding,
    # or edge replication where the pad exceeds the dimension.
    pad_h = max(0, tile - h)
    pad_w = max(0, tile - w)
    if pad_h or pad_w:
        mode = "reflect" if (pad_h < h and pad_w < w) else "edge"
        padded = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)), mode=mode)
    else:
        padded = image
    ph, pw = padded.shape[:2]

    coords = [(y, x) for y in tile_grid(ph, tile, stride) for x in tile_grid(pw, tile, stride)]
    n = len(coords)
    batch = min(tile_batch, int(2 ** math.ceil(math.log2(max(1, n)))))
    tiles = np.stack([padded[y : y + tile, x : x + tile] for y, x in coords])

    out_tile = tile * scale
    output = np.zeros((ph * scale, pw * scale, c), dtype=np.uint8)

    def _write(sr: np.ndarray, start: int) -> None:
        for j, (y, x0) in enumerate(coords[start : start + batch]):
            oy, ox = y * scale, x0 * scale
            top = 0 if y == 0 else tile_overlap * scale
            left = 0 if x0 == 0 else tile_overlap * scale
            bottom = out_tile if y + tile >= ph else out_tile - tile_overlap * scale
            right = out_tile if x0 + tile >= pw else out_tile - tile_overlap * scale
            output[oy + top : oy + bottom, ox + left : ox + right] = sr[j, top:bottom, left:right]

    inflight: deque = deque()
    depth = 2
    for start in range(0, n, batch):
        chunk = tiles[start : start + batch]
        if len(chunk) < batch:  # zero-pad the tail batch to the fixed shape
            chunk = np.concatenate([chunk, np.zeros((batch - len(chunk), tile, tile, c), np.uint8)])
        inflight.append((model.forward_uint8(torch.from_numpy(chunk)), start))
        if len(inflight) > depth:
            sr, at = inflight.popleft()
            _write(sr.cpu().numpy(), at)
    while inflight:
        sr, at = inflight.popleft()
        _write(sr.cpu().numpy(), at)
    return output[: h * scale, : w * scale]
