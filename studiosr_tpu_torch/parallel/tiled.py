"""Tiled-patch inference: fixed tile shape, batched, overlap-discard reassembly.

Port of ``studiosr_tpu/parallel/tiled.py``, its host loop and its device
loop:

  pad -> overlapping tiles of one shape -> batched uint8 forwards ->
  overlap-discard reassembly

* every forward sees the same (tile_batch, tile, tile, C) shape, whatever
  the image size: the tail batch is padded with zero tiles;
* uint8 crosses the host boundary both ways (``Model.forward_uint8``), and
  two batches are enqueued ahead of the copy back, so the host reassembles
  one batch while the device computes the next;
* the device loop (``device_loop=True``, and by default at most
  :data:`DEVICE_LOOP_TILES` tiles, the JAX package's rule) keeps the tiles,
  the forwards and the reassembly on the model's device: the padded uint8
  image crosses to it once and the uint8 output comes back once. The
  batches, their padding and the write order are the host loop's, so the
  bytes are too.

Window models are exactly tile-consistent when ``tile`` is a window
multiple; outputs differ from whole-image inference only through context
beyond the overlap, which ``tile_overlap`` controls.

With a ``mesh`` (``parallel/mesh.py``) the tile batch is rounded up to a
multiple of ``mesh.size`` and each batch is split over the mesh's slots,
as the JAX package shards it over its devices: the host loop sends each
batch through ``Model.manual_forward_uint8``, the device loop cuts each
slot's tiles on the slot's card and reassembles on the model's device.
The output is the mesh-less call's, byte for byte. A mesh over several
processes raises, as in the JAX package: shard images across processes.
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np
import torch

from studiosr_tpu_torch.parallel.mesh import replicas, run_sharded

__all__ = ["tiled_inference", "tile_grid", "DEVICE_LOOP_TILES"]

DEVICE_LOOP_TILES = 512  # device_loop=None takes the device loop up to this many tiles


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
    output, except at the image borders, where the halo is kept.
    ``device_loop`` True runs the loop on the model's device, False on the
    host, None on the device at most :data:`DEVICE_LOOP_TILES` tiles."""
    if mesh is not None and mesh.world_size > 1:
        raise ValueError("tiled_inference(mesh=...) over several processes: every process holds the whole image, so "
                         "each tile would be computed once a process; pass a mesh over this process's devices (or "
                         "mesh=None) and shard IMAGES across processes instead")
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
    if mesh is not None:
        batch = -(-max(batch, mesh.size) // mesh.size) * mesh.size  # a multiple of the mesh's size
    if device_loop is None:
        device_loop = n <= DEVICE_LOOP_TILES
    if device_loop:
        return _device_tiled(model, padded, coords, tile, tile_overlap, batch, h, w, mesh)
    forward = model.forward_uint8 if mesh is None else (lambda chunk: model.manual_forward_uint8(chunk, mesh))

    tiles = np.stack([padded[y : y + tile, x : x + tile] for y, x in coords])
    output = np.zeros((ph * scale, pw * scale, c), dtype=np.uint8)
    inflight: deque = deque()
    depth = 2
    for start in range(0, n, batch):
        chunk = tiles[start : start + batch]
        if len(chunk) < batch:  # zero-pad the tail batch to the fixed shape
            chunk = np.concatenate([chunk, np.zeros((batch - len(chunk), tile, tile, c), np.uint8)])
        inflight.append((forward(torch.from_numpy(chunk)), start))
        if len(inflight) > depth:
            sr, at = inflight.popleft()
            _write(output, sr.cpu().numpy(), coords[at : at + batch], tile, tile_overlap, scale, (ph, pw))
    while inflight:
        sr, at = inflight.popleft()
        _write(output, sr.cpu().numpy(), coords[at : at + batch], tile, tile_overlap, scale, (ph, pw))
    return output[: h * scale, : w * scale]


def _write(output, sr, coords, tile: int, tile_overlap: int, scale: int, padded_shape) -> None:
    """Overlap-discard: each tile's interior of ``sr`` (one batch, tiles at
    ``coords``) into ``output``; at the image borders the halo is kept."""
    ph, pw = padded_shape
    out_tile = tile * scale
    for j, (y, x0) in enumerate(coords):
        oy, ox = y * scale, x0 * scale
        top = 0 if y == 0 else tile_overlap * scale
        left = 0 if x0 == 0 else tile_overlap * scale
        bottom = out_tile if y + tile >= ph else out_tile - tile_overlap * scale
        right = out_tile if x0 + tile >= pw else out_tile - tile_overlap * scale
        output[oy + top : oy + bottom, ox + left : ox + right] = sr[j, top:bottom, left:right]


def _device_tiled(model, padded: np.ndarray, coords, tile: int, tile_overlap: int, batch: int, h: int, w: int,
                  mesh=None):
    """The tile loop on ``model.device``: the padded uint8 image crosses to
    it once, the tiles are sliced there in the host loop's order and batched
    in its fixed shape (the tail batch padded with zero tiles), each batch's
    uint8 forward is reassembled there in the host loop's write order (so
    snapped-edge overlaps resolve the same way), and the uint8 output
    crosses back once. With a ``mesh`` the image crosses once to each slot,
    which cuts its share of every batch there and runs it; the shares are
    gathered and reassembled on ``model.device``."""
    scale, dev = model.scale, model.device
    ph, pw, c = padded.shape
    host = torch.from_numpy(np.ascontiguousarray(padded))
    images = {id(r): host.to(r.device) for r in (replicas(model, mesh) if mesh is not None else [model])}

    def forward(replica, part):
        img = images[id(replica)]
        fill = torch.zeros((tile, tile, c), dtype=torch.uint8, device=img.device) if None in part else None
        tiles = [fill if yx is None else img[yx[0] : yx[0] + tile, yx[1] : yx[1] + tile] for yx in part]
        return replica.forward_uint8(torch.stack(tiles))

    output = torch.zeros((ph * scale, pw * scale, c), dtype=torch.uint8, device=dev)
    for start in range(0, len(coords), batch):
        part = coords[start : start + batch]
        padded_part = list(part) + [None] * (batch - len(part))
        sr = forward(model, padded_part) if mesh is None else run_sharded(model, mesh, forward, padded_part)
        _write(output, sr, part, tile, tile_overlap, scale, (ph, pw))
    return output[: h * scale, : w * scale].cpu().numpy()
