"""Process group and device placement for multi-process runs (port of
expecto_tpu/parallel/mesh.py onto ``torch.distributed``).

The port runs one device per process: a launcher (``torchrun``) starts one
process per rank, each rank joins the group here and computes on its own
card, or on a card it shares with other ranks. The JAX package's meshes and
shardings (``get_mesh``, ``get_mesh_2d``, ``local_mesh``, ``batch_sharding``,
``replicated_sharding``) have no counterpart: the runner batches on its one
device, and rows shard across processes (parallel/dist.py).

Launch contract (torchrun's environment): ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``::

    torchrun --standalone --nproc_per_node 2 -m expecto_tpu_torch.cli.score ...
"""

from __future__ import annotations

import atexit
import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from .runner import resolve_device

#: how long a rank waits for the others at rendezvous and at a collective or
#: barrier before it raises
GROUP_TIMEOUT = datetime.timedelta(minutes=10)


def device_count() -> int:
    """CUDA devices visible to this process (0 without a GPU)."""
    return torch.cuda.device_count()


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> tuple[np.ndarray, int]:
    """Zero-pad ``axis`` up to a multiple; returns (padded, original_size)."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad), n


def choose_backend(device_type: str, local_ranks: int, cards: int) -> str:
    """The process group's backend: gloo on the CPU; NCCL when each of the
    ``local_ranks`` ranks of this machine has a card of its own; gloo when
    ranks share a card (NCCL refuses two ranks on one device)."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"no process-group backend for device type {device_type!r}")
    if cards < 1:
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is available; pass device='cpu' to run on the CPU")
    return "nccl" if local_ranks <= cards else "gloo"


def rank_device(device: torch.device, local_rank: int, cards: int) -> torch.device:
    """The device a rank computes on: the CPU stays the CPU, a CUDA device
    with an index is kept, and a bare ``cuda`` becomes ``cuda:(local_rank %
    cards)``, so ranks beyond the card count share cards."""
    if device.type != "cuda" or device.index is not None:
        return device
    if cards < 1:
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", local_rank % cards)


def local_device(device="cuda") -> torch.device:
    """This rank's device (:func:`rank_device` with torchrun's ``LOCAL_RANK``),
    made the current CUDA device. Raises without a GPU, as resolve_device."""
    device = rank_device(resolve_device(device), int(os.environ.get("LOCAL_RANK", "0")), torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def _destroy_group() -> None:
    """Destroy this process's default group, if it is still up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def maybe_initialize_distributed(device="cuda") -> None:
    """Join the process group when launched as one rank of several (a no-op
    when ``WORLD_SIZE`` is unset or 1, or the group is already up).

    Decides from torchrun's environment alone and runs before any CUDA work
    on ``device``: the backend follows :func:`choose_backend` for the device
    type, the local ranks and the cards, and is printed. An init failure
    raises; nothing is retried on another backend.

    The group is destroyed when the interpreter exits (an ``atexit``
    handler, which runs before the interpreter tears its modules down): a
    gloo group left to that teardown can abort a rank at exit ("terminate
    called without an active exception", SIGABRT) while its peer still
    runs, which fails the whole torchrun group after its work is done."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 or dist.is_initialized():
        return
    rank = int(os.environ["RANK"])
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    device = torch.device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = choose_backend(device.type, local_ranks, cards)
    dev = local_device(device)
    dist.init_process_group(backend=backend, init_method="env://", world_size=world, rank=rank,
                            timeout=GROUP_TIMEOUT)
    atexit.register(_destroy_group)
    print(f"torch.distributed: rank {rank} of {world}, backend {backend} ({local_ranks} local ranks, {cards} "
          f"cards), device {dev}", file=sys.stderr, flush=True)
