"""The data-parallel "mesh": this process's devices and the world of processes.

Port of ``studiosr_tpu/parallel/mesh.py``. The JAX package lays a
``jax.sharding.Mesh`` over every device and lets XLA insert the gradient
all-reduce; here a process drives its own devices (one card in a process
group) and the processes meet in ``torch.distributed`` collectives. The
batch axis is split by rank, each process loading its own shard
(``data/handler.py``); the ``mesh=`` routes of evaluation and tiled
inference only check (:func:`check_devices`) that the mesh is the
model's own card. Parameters are replicated: :func:`replicate` broadcasts
rank 0's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as torch_dist

from studiosr_tpu_torch.parallel import dist

__all__ = ["Mesh", "get_mesh", "replicate", "check_devices", "all_reduce_mean"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: Tuple[torch.device, ...]  # this process's devices
    rank: int = 0
    world_size: int = 1

    @property
    def size(self) -> int:
        return len(self.devices) * self.world_size


def get_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """This process's devices (default: the one it joined the process group
    with, else ``cuda``) and the world of processes."""
    if devices is None:
        devices = [dist.device() or torch.device("cuda")]
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


def check_devices(mesh: Mesh, device: torch.device) -> None:
    """Raise unless every device of ``mesh`` is ``device``, where a model
    lives (one card a process): the ``mesh=`` routes run there."""
    same = lambda d: d.type == device.type and (d.index or 0) == (device.index or 0)  # noqa: E731
    if not all(same(d) for d in mesh.devices):
        raise ValueError(f"mesh devices {list(mesh.devices)}: the model lives on {device}; each process drives its "
                         "own card")


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
