"""Multi-process topology: one process a card, joined by ``torch.distributed``.

Port of ``studiosr_tpu/parallel/dist.py``. The JAX package starts JAX's
distributed runtime; here ``initialize`` starts a ``torch.distributed``
process group over TCP: NCCL when the caller trains on ``cuda``, gloo when
it trains on the CPU (the backend follows the device the caller names,
never what the machine happens to have). The configuration comes from the
arguments or from the same environment variables, ``COORDINATOR_ADDRESS``
(host:port of rank 0), ``NUM_PROCESSES`` and ``PROCESS_ID``. Without a
coordinator it does nothing: one process, rank 0 of 1. With one it starts
the group even at one process, so that a single card runs the collectives
of the multi-process path (an all-reduce over one rank is the identity).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as torch_dist

__all__ = [
    "initialize", "is_initialized", "is_main_process", "process_index", "process_count", "local_device_count",
    "device", "shutdown",
]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> None:
    """Join the process group if one is configured; a no-op otherwise.

    ``device`` is where this process trains: ``cuda`` takes NCCL and card
    ``process_id mod torch.cuda.device_count()``, ``cpu`` takes gloo.
    Incomplete explicit configuration (a process count or id without a
    coordinator) raises ``ValueError``: every worker would otherwise train
    alone on the full dataset with the same seed."""
    if torch_dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address is None and (num_processes is not None or process_id is not None):
        raise ValueError(
            "initialize(num_processes=..., process_id=...) requires a "
            "coordinator_address (arg or COORDINATOR_ADDRESS env var)"
        )
    if coordinator_address is None:
        return
    # `is not None`, not `or`: process_id=0 (the coordinator) is falsy and
    # must not be displaced by a stale PROCESS_ID env var
    world = num_processes if num_processes is not None else int(os.environ.get("NUM_PROCESSES", "1"))
    rank = process_id if process_id is not None else int(os.environ.get("PROCESS_ID", "0"))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda'): no CUDA device")
        dev = torch.device("cuda", rank % torch.cuda.device_count() if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    torch_dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=world, rank=rank)


def is_initialized() -> bool:
    return torch_dist.is_initialized()


def process_index() -> int:
    return torch_dist.get_rank() if torch_dist.is_initialized() else 0


def process_count() -> int:
    return torch_dist.get_world_size() if torch_dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def local_device_count() -> int:
    """The cards this process drives: one in a process group (a card a
    process), else every card it sees (one CPU device without any)."""
    if torch_dist.is_initialized():
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def device() -> Optional[torch.device]:
    """The device ``initialize`` joined the group with (its card for NCCL,
    the CPU for gloo), or None without a group."""
    if not torch_dist.is_initialized():
        return None
    if torch_dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if torch_dist.is_initialized():
        torch_dist.destroy_process_group()
