"""Meshes over ``torch.distributed`` ranks: a grid of named axes.

Counterpart of ``repro.launch.mesh``. The reference lays a
``jax.sharding.Mesh`` over the local devices (``jax.make_mesh``); the port
lays the same grid over the ranks of one process group (SPMD by
processes: every rank runs the same program). The rank at row-major
coordinates ``c`` of a mesh of ``shape`` is ``ravel(c, shape)``, as the
reference's ``devices.reshape(shape)`` places device ``r``: on a (data,
model) mesh rank ``r`` sits at ``(r // model, r % model)``.

``make_mesh(shape, axes)`` is ``jax.make_mesh``'s counterpart; it covers
``("data", "model")`` and ``("pod", "data", "model")``, and refuses, as
``jax.make_mesh`` does, a shape whose size is not the number of ranks.
``make_debug_mesh`` and ``make_production_mesh`` are the reference's
shapes over it, and ``make_serving_mesh`` the sharded serving engine's
(data, model) mesh, whose ``ServingMesh`` is the two-axis case.

The process group comes from the ``torchrun`` environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``), or from an explicit ``init_method`` (the tests'
``file://`` rendezvous), unless one is up already. The backend is chosen
once and printed in the mesh line: NCCL when every local rank has a card
of its own; gloo when local ranks share a card (NCCL refuses two ranks on
one device, so gloo is how one card hosts a 2-rank mesh) or run on the
CPU. It never changes after an error.

Every collective goes through the mesh: sums and maxima (``all_reduce``)
over the whole mesh, one axis (``group(axis)``) or the data axes together
(``data_group``: the (pod, data) ranks that share this rank's model
index, over which batches split and gradients are summed), gathers built
from integer sums into a zeroed buffer over the tensors' bits
(``sum_bytes``), which both NCCL and gloo take for CUDA tensors and which
is exact for every dtype, -0.0 and NaN included, and ``barrier``.
``collectives`` counts them.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "model")
DATA_AXES = ("pod", "data")


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value is None else int(value)


def _unravel(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    """Row-major coordinates of ``rank`` in a grid of ``shape``."""
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


class Mesh:
    """A grid of named axes over the ranks of the default process group."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device: torch.device, backend: str):
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} do not pair up")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.size = math.prod(self.shape.values())
        self.rank = dist.get_rank()
        self.coords = dict(zip(self.axis_names,
                               _unravel(self.rank, tuple(shape))))
        self.device = device
        self.backend = backend
        self.collectives = 0
        # every rank creates every group, in one order, as new_group needs
        self._groups = {a: self._group_along((a,)) for a in self.axis_names}
        data = tuple(a for a in DATA_AXES if a in self.axis_names)
        self.data_group = (self._groups[data[0]] if len(data) == 1
                           else self._group_along(data))

    def _group_along(self, names: Tuple[str, ...]):
        """This rank's group of the ranks that differ from it only along
        ``names`` (a group is made for every setting of the other axes)."""
        shape = tuple(self.shape[a] for a in self.axis_names)
        others = [i for i, a in enumerate(self.axis_names)
                  if a not in names]
        mine = tuple(self.coords[self.axis_names[i]] for i in others)
        groups = {}
        for r in range(self.size):
            key = tuple(_unravel(r, shape)[i] for i in others)
            groups.setdefault(key, []).append(r)
        out = None
        for key in itertools.product(*(range(shape[i]) for i in others)):
            g = dist.new_group(groups[key])
            if key == mine:
                out = g
        return out

    def group(self, axis: str):
        """The process group of the ranks along ``axis`` with this one."""
        return self._groups[axis]

    def __repr__(self) -> str:
        return (f"{type(self).__name__}({self.shape}, rank {self.rank}, "
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

    def barrier(self) -> None:
        self.collectives += 1
        dist.barrier()


class ServingMesh(Mesh):
    """The (data, model) mesh of the sharded serving engine."""

    def __init__(self, data: int, model: int, device: torch.device,
                 backend: str):
        super().__init__((data, model), AXES, device, backend)


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


def world_of(world_size: Optional[int] = None) -> int:
    """Ranks of the default process group, or of the one to be started
    (``world_size``, else the ``torchrun`` environment's, else 1)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return world_size if world_size is not None else \
        _env_int("WORLD_SIZE", 1)


def _start(device, init_method: Optional[str], rank: Optional[int],
           world: int, timeout_s: float) -> Tuple[torch.device, str]:
    """(this rank's device, backend), starting the default process group
    unless one is up: from ``init_method`` with ``rank``, else from the
    ``torchrun`` environment; every collective times out after
    ``timeout_s``."""
    local_rank = _env_int("LOCAL_RANK", rank if rank is not None
                          else _env_int("RANK", 0))
    dev = _device_for(device, local_rank)
    if dist.is_initialized():
        return dev, dist.get_backend()
    backend = choose_backend(dev, _env_int("LOCAL_WORLD_SIZE", world))
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=rank if rank is not None else _env_int("RANK", 0),
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return dev, backend


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device="cuda",
              init_method: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None,
              timeout_s: float = 600.0) -> Mesh:
    """A mesh of ``shape`` with ``axes`` over every rank (``jax.make_mesh``);
    raises, before any process group starts, when the mesh's size is not
    the number of ranks. Starts the process group as ``_start`` says."""
    world = world_of(world_size)
    need = math.prod(int(n) for n in shape)
    if need != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} over {tuple(axes)} "
                         f"needs {need} ranks; the world has {world}")
    dev, backend = _start(device, init_method, rank, world, timeout_s)
    return Mesh(shape, axes, dev, backend)


def make_production_mesh(*, multi_pod: bool = False, **kw) -> Mesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else AXES
    return make_mesh(shape, axes, **kw)


def make_debug_mesh(model: int = 2, **kw) -> Mesh:
    """A small (data, model) mesh for sharding tests: ``data`` gets
    ``world // model`` ranks (at least 1), so it needs a world of
    ``model`` ranks at least, as the reference needs the devices."""
    data = max(world_of(kw.get("world_size")) // model, 1)
    return make_mesh((data, model), AXES, **kw)


def make_serving_mesh(model_parallel: int = 1, *, device="cuda",
                      init_method: Optional[str] = None,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      timeout_s: float = 600.0) -> ServingMesh:
    """(data, model) mesh for the sharded serving engine.

    ``data`` gets every rank not claimed by ``model_parallel``; bucket
    sizes should be multiples of it (otherwise the batch stays replicated;
    see ``sharding.batch_spec``). Raises, as the reference does, when
    ``model_parallel`` does not divide the world. Starts the process
    group as ``_start`` says."""
    world = world_of(world_size)
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide {world} devices")
    dev, backend = _start(device, init_method, rank, world, timeout_s)
    return ServingMesh(world // model_parallel, model_parallel, dev, backend)
