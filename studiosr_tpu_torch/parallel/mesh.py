"""The "mesh": this process's devices and the world of processes.

Port of ``studiosr_tpu/parallel/mesh.py``. The JAX package lays a
``jax.sharding.Mesh`` over every local device; its serving routes split the
batch over it with ``shard_map`` and its Trainer lets XLA insert the
gradient all-reduce. Here:

* training is one process a card (``make_train_step(mesh=...)``, the
  Trainer's ``get_mesh([device])``): the processes meet in
  ``torch.distributed`` collectives, each loading its own shard
  (``data/handler.py``); :func:`replicate` broadcasts rank 0's parameters;
* serving over a mesh (``Model.manual_forward_uint8``,
  ``Model.sharded_forward``, ``evaluate_uint8_batch(mesh=)``,
  ``tiled_inference(mesh=)``) runs in one process over its slots: each
  entry of ``mesh.devices`` is a slot with its own replica of the model
  (:func:`replicas`; a device may be named more than once), and
  :func:`run_sharded` runs every slot's equal contiguous share of a batch
  on its own host thread and, on a card, its own CUDA stream, then gathers
  the results on the model's device in batch order. The CUDA kernels need
  no manual partitioning: every slot runs the single-card path.
"""

from __future__ import annotations

import copy
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as torch_dist

from studiosr_tpu_torch._device import resolve_device
from studiosr_tpu_torch.parallel import dist

__all__ = ["Mesh", "get_mesh", "replicate", "replicas", "run_sharded", "all_reduce_mean"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: Tuple[torch.device, ...]  # this process's devices
    rank: int = 0
    world_size: int = 1

    @property
    def size(self) -> int:
        return len(self.devices) * self.world_size


def get_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """This process's devices and the world of processes. By default every
    visible card, as the JAX package's ``get_mesh()`` takes every local
    device; in a process group the device the process joined it with."""
    if devices is None:
        own = dist.device()
        if own is not None:
            devices = [own]
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] or ["cuda"]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs, dist.process_index(), dist.process_count())


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` set to rank 0's, in place."""
    if mesh.world_size > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                torch_dist.broadcast(t.data, src=0)
    return module


def _canonical(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _slots(model, mesh: Mesh) -> list:
    """[(replica, CUDA stream or None)] a slot of ``mesh``, cached on the
    model per (devices, dtype, fused, parameter storage and version)."""
    devices = [_canonical(resolve_device(d)) for d in mesh.devices]  # raises on a device that is not cpu or cuda
    own = _canonical(model.device)
    key = (tuple(devices), own, model._compute_dtype, getattr(model, "_fused", False),
           tuple((p.data_ptr(), p._version) for p in model.module.parameters()))
    cache = model.__dict__.get("_replica_cache")
    if cache is not None and cache[0] == key:
        return cache[1]
    first = next((i for i, d in enumerate(devices) if d == own), None)
    slots = []
    for i, d in enumerate(devices):
        replica = model if i == first else _copy(model, d)
        slots.append((replica, torch.cuda.Stream(device=d) if d.type == "cuda" else None))
    model._replica_cache = (key, slots)
    return slots


def _copy(model, device: torch.device):
    """``model`` with its module copied to ``device`` bit for bit and no
    cached serving weights (the copy prepares its own)."""
    clone = object.__new__(type(model))
    clone.__dict__.update({k: v for k, v in model.__dict__.items()
                           if k not in ("module", "_serving_prep_cache", "_replica_cache")})
    with torch.inference_mode(False), torch.no_grad():  # plain tensors, even when called under inference mode
        clone.module = copy.deepcopy(model.module).to(device)
    clone.device = device
    return clone


def replicas(model, mesh: Mesh) -> list:
    """The model on each slot of ``mesh``, in slot order: the first slot on
    the model's own device is the model itself, every other one a copy
    ``.to(slot)`` with the same weights bit for bit and its own serving
    prep. Cached on the model; ``to``, ``astype``, ``half`` and
    ``enable_fused`` drop the copies. A device that is not ``cpu`` or
    ``cuda`` raises, and so does CUDA where there is none."""
    return [replica for replica, _ in _slots(model, mesh)]


def run_sharded(model, mesh: Mesh, fn, *batches) -> torch.Tensor:
    """``fn(replica, *shares)`` on every slot of ``mesh``, the port's
    ``shard_map``: each of ``batches`` (tensors or lists, batch axis first)
    is cut into one equal contiguous share a slot, in slot order; each slot
    runs on a host thread of its own, under ``torch.inference_mode`` and,
    on a card, on a CUDA stream of its own with its card current; the
    results (tensors, batch axis first) are gathered on ``model.device`` in
    batch order. Returns without synchronising. A batch that does not
    divide over the slots raises ``ValueError``."""
    slots = _slots(model, mesh)
    n, size = len(slots), len(batches[0])
    if size % n:
        raise ValueError(f"a batch of {size} does not divide over the {n} slots of the mesh")
    if n == 1 and slots[0][0] is model:
        with torch.inference_mode():
            return fn(model, *batches)
    share = size // n
    for _, stream in slots:
        if stream is not None:  # the slot's work follows what the caller enqueued on its card
            stream.wait_stream(torch.cuda.current_stream(stream.device))

    def work(i: int) -> torch.Tensor:
        replica, stream = slots[i]
        args = [b[i * share: (i + 1) * share] for b in batches]
        with torch.inference_mode():
            if stream is None:
                return fn(replica, *args)
            with torch.cuda.device(stream.device), torch.cuda.stream(stream):
                return fn(replica, *args)

    with ThreadPoolExecutor(n) as pool:
        outs = list(pool.map(work, range(n)))
    gathered = []
    with torch.inference_mode():
        for (_, stream), out in zip(slots, outs):
            if stream is not None:  # the caller's stream on the slot's card waits for the slot
                here = torch.cuda.current_stream(stream.device)
                here.wait_stream(stream)
                out.record_stream(here)
            gathered.append(out.to(model.device))
        return torch.cat(gathered)


def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The mean of each tensor over the processes, as one flat f32 bucket
    (one collective); the tensors as they are without a process group."""
    if not torch_dist.is_initialized():
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    torch_dist.all_reduce(flat)
    flat.div_(mesh.world_size)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start: start + t.numel()].view(t.shape).to(t.dtype))
        start += t.numel()
    return out
