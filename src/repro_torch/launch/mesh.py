"""The serving mesh: a (data, model) grid over ``torch.distributed`` ranks.

Counterpart of ``repro.launch.mesh.make_serving_mesh``. The reference lays
a ``jax.sharding.Mesh`` over the local devices; the port lays the same
grid over the ranks of one process group (SPMD by processes: every rank
runs the same program). Rank ``r`` sits at ``(r // model, r % model)``,
as the reference's ``devices.reshape(data, model)`` places device ``r``.

The process group comes from the ``torchrun`` environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``), or from an explicit ``init_method`` (the tests' ``file://``
rendezvous), unless one is up already. The backend is chosen once and
printed in the mesh line: NCCL when every local rank has a card of its
own; gloo when local ranks share a card (NCCL refuses two ranks on one
device, so gloo is how one card hosts a 2-rank mesh) or run on the CPU.
It never changes after an error.

Every collective the serving path makes goes through ``ServingMesh``:
sums and maxima (``all_reduce``) and gathers built from integer sums into
a zeroed buffer over the tensors' bits (``sum_bytes``), which both NCCL
and gloo take for CUDA tensors and which is exact for every dtype, -0.0
and NaN included. ``collectives`` counts them.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("data", "model")


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value is None else int(value)


class ServingMesh:
    """A (data, model) mesh over the ranks of the default process group."""

    axis_names = AXES

    def __init__(self, data: int, model: int, device: torch.device,
                 backend: str):
        self.shape = {"data": data, "model": model}
        self.size = data * model
        self.rank = dist.get_rank()
        self.coords = {"data": self.rank // model, "model": self.rank % model}
        self.device = device
        self.backend = backend
        self.collectives = 0
        # the ranks that share this rank's model index; every rank creates
        # every such group, in one order, as new_group needs
        data_groups = [dist.new_group([i * model + j for i in range(data)])
                       for j in range(model)]
        self.data_group = data_groups[self.coords["model"]]

    def __repr__(self) -> str:
        return (f"ServingMesh({self.shape}, rank {self.rank}, "
                f"{self.backend} on {self.device})")

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM,
                   group=None) -> torch.Tensor:
        """``t`` reduced in place over ``group`` (the whole mesh by
        default); returns ``t``."""
        self.collectives += 1
        dist.all_reduce(t, op=op, group=group)
        return t

    def sum_bytes(self, full: torch.Tensor, group=None) -> torch.Tensor:
        """Sum ``full`` over ``group`` as integers, in place: where each
        byte has one contributing rank (every other rank holds zeros
        there), the sum is that rank's bits, so the result is exact. The
        bytes are summed as int32 words when they fill whole words (a
        quarter of the elements to add), else as bytes."""
        words = full.view(-1).view(torch.uint8)
        if words.numel() % 4 == 0:
            words = words.view(torch.int32)
        self.all_reduce(words, group=group)
        return full


def _device_for(device, local_rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but "
                "torch.cuda.is_available() is False; pass device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL when each of the ``local_world`` ranks on this host has a card
    of its own, else gloo (ranks sharing a card, or the CPU)."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def make_serving_mesh(model_parallel: int = 1, *, device="cuda",
                      init_method: Optional[str] = None,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      timeout_s: float = 600.0) -> ServingMesh:
    """(data, model) mesh for the sharded serving engine.

    ``data`` gets every rank not claimed by ``model_parallel``; bucket
    sizes should be multiples of it (otherwise the batch stays replicated;
    see ``sharding.batch_spec``). Raises, as the reference does, when
    ``model_parallel`` does not divide the world. Without a process group
    up it starts one: from ``init_method`` with ``rank`` and
    ``world_size``, else from the ``torchrun`` environment; every
    collective times out after ``timeout_s``."""
    if dist.is_initialized():
        world = dist.get_world_size()
    else:
        world = world_size if world_size is not None else \
            _env_int("WORLD_SIZE", 1)
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide {world} devices")
    local_rank = _env_int("LOCAL_RANK", rank if rank is not None
                          else _env_int("RANK", 0))
    dev = _device_for(device, local_rank)
    if dist.is_initialized():
        backend = dist.get_backend()
    else:
        backend = choose_backend(dev, _env_int("LOCAL_WORLD_SIZE", world))
        if backend == "nccl":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            rank=rank if rank is not None else _env_int("RANK", 0),
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    return ServingMesh(world // model_parallel, model_parallel, dev, backend)
