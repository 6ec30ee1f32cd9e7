"""Operation counts of one eager call: FLOPs, int8 ops, bytes, collectives.

Counterpart of ``repro.launch.hlo_analysis``. The reference parses the
compiled, SPMD-partitioned HLO of a jitted step and multiplies each loop
body by its trip count. The port compiles nothing, so it counts what one
call dispatches: ``analyze(fn, *args)`` runs ``fn`` once under a
``TorchDispatchMode`` and sums every aten op it reaches. A loop of L
layers counts L times and a backward counts both passes, with no
trip-count detection. All numbers are for the one process that runs the
call: with a ``CountingMesh``, one rank.

* ``flops``: float operations from ``torch.utils.flop_counter``'s
  registered formulas (mm, addmm, bmm, baddbmm, convolution and its
  backward, SDPA); an integer product (``_int_mm``, or a registered op on
  int8 operands) goes to ``int8_ops``. Elementwise arithmetic is not
  counted, as the reference counts dot and convolution alone.
* ``bytes``: the reference's rule (``hlo_analysis.py:241-243``) where
  eager PyTorch has the op: a dot or convolution its operands plus its
  result; a gather-like op (``index_select``, ``gather``, ``index``,
  ``embedding``) its result; a copy, ``cat``, ``sort``, ``flip`` or pad
  what it reads plus what it writes; an in-place fill or copy what it
  writes plus what it reads besides its target. Elementwise ops and
  reductions count their inputs plus their outputs. The reference leaves
  those to XLA's fusion and charges only the ops that touch HBM; eager
  PyTorch runs each as its own kernel, so the port counts them unfused,
  as they run. Views (``_unsafe_view`` too) and empty allocations move
  nothing, and an input counts its strided span once (a broadcast
  operand is read once).
* kernels: each of the port's kernel wrappers (``abft_matmul``,
  ``rollback_correct``, ``drift_gemm_fused``, ``flash_attention``/
  ``mha_flash``, ``fault_inject``, ``stat_abft_matmul``) is counted at
  its kernel's own work, the ``work(...)`` of its module (attention's
  causal pairs and windows clipped; the fused drift GEMM's checkpoint
  reads, which only its masks decide, not counted), through
  ``kernels._count``; the ops inside a wrapper are not counted again.
  ``kernels`` in the report holds the calls of each.
* collectives: a ``CountingMesh`` stands for one rank (rank 0 by
  default) of a mesh of any shape in one process and records what each
  collective would send from this rank (its docstring gives the
  algorithm's factors).

Counts come from shapes alone, so a call on meta tensors counts what the
same call counts on the card: under a count the kernel wrappers take meta
tensors, and the port's ``device.type == "cpu"`` branches send meta down
the card's route. The flip masks a fault model draws are a simulation of
the hardware, not work the system does: ``uncounted_source`` wraps a flip
source so its draws are not counted (and returns zero masks on meta),
while the injection itself is.

``top_ops`` lists the heaviest ops, kernels and collectives by their time
on the H100's roofline (``perfmodel.hw.H100_SXM``), the counterpart of
the reference's ``top_ops`` and ``top_collectives``.
"""
from __future__ import annotations

import contextlib
import math
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _count
from repro_torch.launch.mesh import DATA_AXES, Mesh, _unravel
from repro_torch.perfmodel.hw import H100_SXM

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

aten = torch.ops.aten
_EMPTY = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
          aten.new_empty_strided, aten._local_scalar_dense,
          aten._unsafe_view}
_GATHER = {aten.index_select, aten.gather, aten.index, aten.embedding,
           aten.take}
_OVERWRITE = {aten.copy_, aten.fill_, aten.zero_, aten.normal_,
              aten.uniform_, aten.random_}
_INT8 = (torch.int8, torch.uint8)


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _span_bytes(t: torch.Tensor) -> int:
    """Bytes of the storage ``t`` covers, each element once (a broadcast
    view covers its source), at most its own size."""
    if t.numel() == 0:
        return 0
    span = 1 + sum((n - 1) * abs(st) for n, st in zip(t.shape, t.stride()))
    return min(span, t.numel()) * t.element_size()


def _out_bytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(out))


def op_cost(func, args, kwargs, out) -> Tuple[float, float, float]:
    """(flops, int8 ops, bytes) of one aten op call; see the docstring."""
    packet = func.overloadpacket
    if func.is_view or packet in _EMPTY:
        return 0.0, 0.0, 0.0
    ins = _tensors((args, kwargs))
    flops = int8 = 0.0
    if packet is aten._int_mm:
        (m, k), n = args[0].shape, args[1].shape[1]
        int8 = 2.0 * m * k * n
    elif packet in flop_registry:
        n = float(flop_registry[packet](*args, **kwargs, out_val=out))
        if any(t.dtype in _INT8 for t in ins):
            int8 = n
        else:
            flops = n
    if packet in _GATHER:
        return flops, int8, float(_out_bytes(out))
    if packet in _OVERWRITE:
        return flops, int8, float(_out_bytes(out)
                                  + sum(_span_bytes(t) for t in ins[1:]))
    return flops, int8, float(sum(_span_bytes(t) for t in ins)
                              + _out_bytes(out))


def _roofline_s(flops, int8, bytes_, coll) -> float:
    hw = H100_SXM
    return max(flops / hw.peak_flops_bf16 + int8 / hw.peak_ops_int8,
               bytes_ / hw.hbm_bytes_per_s, coll / hw.link_bytes_per_s)


class _Counter:
    """The sums of one ``analyze`` call."""

    def __init__(self):
        self.flops = self.int8_ops = self.bytes = 0.0
        self.collectives = {k: 0.0 for k in COLLECTIVE_KINDS}
        self.collective_ops = 0
        self.kernels: Dict[str, int] = defaultdict(int)
        # (kind, name, shapes) -> [calls, flops, int8 ops, bytes, coll]
        self.by_op: Dict[tuple, List[float]] = defaultdict(
            lambda: [0, 0.0, 0.0, 0.0, 0.0])
        self._paused = 0

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def _add(self, key, flops=0.0, int8=0.0, bytes_=0.0, coll=0.0):
        self.flops += flops
        self.int8_ops += int8
        self.bytes += bytes_
        row = self.by_op[key]
        row[0] += 1
        for i, v in enumerate((flops, int8, bytes_, coll), 1):
            row[i] += v

    def add_op(self, func, args, kwargs, out):
        if self._paused:
            return
        flops, int8, bytes_ = op_cost(func, args, kwargs, out)
        if flops or int8 or bytes_:
            shapes = tuple(tuple(t.shape) for t in _tensors(args)[:2])
            self._add(("op", str(func.overloadpacket), shapes), flops,
                      int8, bytes_)

    def add_kernel(self, name: str, work: Dict[str, float]):
        if self._paused:
            return
        self.kernels[name] += 1
        self._add(("kernel", name, ()), work["flops"], work["int8_ops"],
                  work["bytes"])

    def add_collective(self, kind: str, sent: float, shape):
        self.collective_ops += 1
        if kind in self.collectives:
            self.collectives[kind] += sent
        self._add(("collective", kind, (tuple(shape),)), coll=sent)

    def report(self, n_top: int = 15) -> Dict[str, Any]:
        rows = []
        for (kind, name, shapes), (calls, f, i8, b, c) in self.by_op.items():
            rows.append(dict(kind=kind, name=name,
                             shapes=[list(s) for s in shapes],
                             calls=int(calls), flops=f, int8_ops=i8,
                             bytes=b, collective_bytes=c,
                             roofline_s=_roofline_s(f, i8, b, c)))
        rows.sort(key=lambda r: -r["roofline_s"])
        return {"flops": self.flops, "int8_ops": self.int8_ops,
                "bytes": self.bytes,
                "collective_bytes": sum(self.collectives.values()),
                "collectives": dict(self.collectives),
                "collective_ops_executed": self.collective_ops,
                "kernels": dict(self.kernels), "top_ops": rows[:n_top]}


class _Mode(TorchDispatchMode):
    def __init__(self, counter: _Counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.counter.add_op(func, args, kwargs, out)
        return out


def analyze(fn: Callable, *args, **kw) -> Dict[str, Any]:
    """Run ``fn(*args, **kw)`` once and count it (see the module
    docstring); ``count_s`` is the wall time of the counted run."""
    if _count.COUNTER is not None:
        raise RuntimeError("op_analysis.analyze does not nest")
    counter = _Counter()
    _count.COUNTER = counter
    t0 = time.perf_counter()
    try:
        with _Mode(counter):
            fn(*args, **kw)
    finally:
        _count.COUNTER = None
    return dict(counter.report(), count_s=time.perf_counter() - t0)


# ------------------------------------------------------------ fault model
def uncounted_source(source, device):
    """A flip source whose draws are not counted: the mask models the
    hardware's faults. On meta tensors it returns zero masks of the shape
    asked for (nothing is drawn)."""
    device = torch.device(device)

    def draw(site, shape, ber, *a, **kw):
        counter = _count.COUNTER
        with counter.paused() if counter else contextlib.nullcontext():
            if device.type == "meta":
                return torch.zeros(tuple(shape), dtype=torch.int32,
                                   device=device)
            return source(site, shape, ber, *a, **kw)
    return draw


# ------------------------------------------------------------ collectives
class _Group(NamedTuple):
    axes: Tuple[str, ...]
    size: int


class CountingMesh:
    """One rank of a mesh of any shape, in one process: the methods of
    ``launch.mesh.Mesh`` (``group``, ``data_group``, ``all_reduce``,
    ``sum_bytes``, ``barrier``) with no process group behind them.

    A collective returns what the real one returns in shape and dtype:
    its input, in place, holding this rank's values (a count needs no
    more). It records on the active ``analyze`` the bytes this rank sends
    over a group of n ranks, by the ring algorithm: an all-reduce of B
    bytes sends 2 (n - 1) / n * B (a reduce-scatter then an all-gather,
    each (n - 1) / n * B); a group of one sends nothing. ``sum_bytes`` is
    ``Mesh.sum_bytes``: an all-reduce of the buffer's words. A barrier
    sends nothing and counts as one collective op. ``collectives`` counts
    the calls, as ``Mesh.collectives`` does."""

    sum_bytes = Mesh.sum_bytes

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device="meta", rank: int = 0):
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} do not pair up")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.size = math.prod(self.shape.values())
        self.rank = int(rank)
        self.coords = dict(zip(self.axis_names,
                               _unravel(self.rank, tuple(shape))))
        self.device = torch.device(device)
        self.backend = "counting"
        self.collectives = 0
        self._groups = {a: _Group((a,), self.shape[a])
                        for a in self.axis_names}
        data = tuple(a for a in DATA_AXES if a in self.axis_names)
        self.data_group = _Group(data, math.prod(self.shape[a]
                                                 for a in data))
        self._whole = _Group(self.axis_names, self.size)

    def group(self, axis: str) -> _Group:
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"CountingMesh({self.shape}, rank {self.rank})"

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM,
                   group=None) -> torch.Tensor:
        self.collectives += 1
        n = (group or self._whole).size
        sent = 2.0 * (n - 1) / n * t.numel() * t.element_size()
        if _count.COUNTER is not None:
            _count.COUNTER.add_collective("all-reduce", sent, t.shape)
        return t

    def barrier(self) -> None:
        self.collectives += 1
        if _count.COUNTER is not None:
            _count.COUNTER.add_collective("barrier", 0.0, ())
