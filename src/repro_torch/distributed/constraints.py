"""The mesh policy and the anchor points where ranks meet.

Counterpart of ``repro.distributed.constraints``. ``MeshPolicy`` and its
``spec`` for every activation kind are the reference's, rule for rule,
behind the same process-global ``set_policy``/``get_policy``. The
reference pins activation shardings with ``constrain(x, kind)`` at block
boundaries and lets GSPMD insert the collectives. A rank of the port holds
plain local tensors, so the policy's work moves to those anchors and to
the places where the data ranks must agree, each a helper here:

* ``gather(tree)``: the ``sharding.Shard`` leaves of a block's weights,
  made whole at the block boundary (``dit.forward``, ``unet.forward`` and
  ``transformer``'s layer loops); with an explicit mesh, a train state's
  params and moments (``train.steps``, ``checkpoint.manager``), which
  run under no policy. Weights rest sharded (FSDP on ``data``,
  tensor parallel on ``model``) and are gathered whole, so every GEMM
  computes what the single-device engine computes, bit for bit.
* ``data_amax``, ``data_sum``: what the single-device engine computes over
  the whole batch, reduced over the data group: a per-tensor activation
  scale's max |x| (``ExecContext.matmul``, ``quant.fake_quant``) and the
  step's detection and correction counts before the BER-monitor update.
* ``gather_rows``, ``own_rows``, ``global_rows``: a batch's rows across
  the data group (``gather_rows``, then ``own_rows`` keeps this rank's),
  for computations a rank's rows alone cannot reproduce: an ABFT tile
  that would straddle two ranks' rows, and small float GEMMs whose
  library kernel depends on the row count.

Without a policy, or with a policy whose batch is not sharded, every
helper returns its input untouched, so single-device serving runs exactly
the code it ran before.

A train step runs under no policy: it takes its mesh explicitly. While
its rows are split over the data axes, ``train.steps`` enters
``split_rows(mesh)``, and the MoE layer, which routes over the whole
batch, reads ``split_rows_mesh()`` and gathers its tokens with
``gather_rows_grad``: the rows of the data group, exactly, in the order
of the ranks' blocks over (pod, data), with a backward that sums the
incoming gradient over the group.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding
from repro_torch.tree import tree_leaves, tree_map

_POLICY: Optional["MeshPolicy"] = None

axis_size = sharding.axis_size


@dataclasses.dataclass
class MeshPolicy:
    mesh: Any
    # shard the embedding dim of activations on 'model'? (the reference's
    # per-cell perf switch; off by default)
    shard_act_dmodel: bool = False
    # treat every mesh axis as data parallel (small models)
    dp_over_all: bool = False
    # the port's runtime switch: this batch's rows are spread over the
    # data group (the sharded engine sets it per batch)
    shard_batch: bool = False

    @property
    def data_axes(self) -> Tuple[str, ...]:
        if self.dp_over_all:
            return tuple(self.mesh.axis_names)
        return tuple(a for a in ("pod", "data") if a in self.mesh.axis_names)

    @property
    def dp(self):
        d = self.data_axes
        return d if len(d) > 1 else (d[0] if d else None)

    @property
    def dsize(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.data_axes)

    def msize(self) -> int:
        return axis_size(self.mesh, "model")

    def spec(self, kind: str, shape: Tuple[int, ...]):
        batch_ok = shape[0] % max(self.dsize, 1) == 0 and self.dsize > 1
        dp = self.dp if batch_ok else None
        last_model = "model" if self.shard_act_dmodel else None
        if kind == "act":        # (B, S, D) and friends
            return (dp, *([None] * (len(shape) - 2)), last_model)
        if kind == "logits":     # (B, S, V): vocab stays model-sharded
            return (dp, *([None] * (len(shape) - 2)), "model")
        if kind == "batch_only":
            return (dp, *([None] * (len(shape) - 1)))
        if kind == "tokens2d":   # (T, d) flattened token streams (MoE)
            return (dp, None)
        msize = self.msize()
        if kind == "slots2d":    # (E*C, d) expert-major slot space
            if shape[0] % max(msize, 1) == 0 and msize > 1:
                return ("model", None)
            return None
        if kind == "w2d_model":  # (K, N) int8 weights, N on model
            if len(shape) == 2 and shape[1] % max(msize, 1) == 0 \
                    and msize > 1:
                return (None, "model")
            return (None,) * len(shape)
        if kind == "experts":    # (E, C, d) dispatched slots
            cap_dp = (self.dp if len(shape) >= 2
                      and shape[1] % max(self.dsize, 1) == 0
                      and self.dsize > 1 else None)
            if shape[0] % max(msize, 1) == 0 and msize > 1:
                return ("model", cap_dp, None)
            return None
        return None


def set_policy(policy: Optional[MeshPolicy]) -> None:
    global _POLICY
    _POLICY = policy


def get_policy() -> Optional[MeshPolicy]:
    return _POLICY


# ------------------------------------------------------------- weights
# bytes; every weight's region in the packed buffer starts at a multiple
# of the caching allocator's 512, so a library GEMM picks the kernel it
# picks for the weight on one device (cuBLAS reads pointer alignment)
_ALIGN = 512


def _owns(mesh, s: sharding.Shard) -> bool:
    """True on the one rank that writes this block: the first along
    every mesh axis the spec does not split."""
    split = {a for e in s.spec if e is not None
             for a in (e if isinstance(e, tuple) else (e,))}
    return all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in split)


def _gather_shards(mesh, shards: List[sharding.Shard]) -> List[torch.Tensor]:
    """The whole weights, in one collective: each block written by its
    owner into its weight's region of one zeroed byte buffer, the buffer
    summed byte-wise over the mesh, each region viewed as its weight."""
    sizes = [math.prod(s.shape) * s.local.element_size() for s in shards]
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // _ALIGN) * _ALIGN
    buf = torch.zeros(total, dtype=torch.uint8,
                      device=shards[0].local.device)
    fulls = []
    for s, off, n in zip(shards, offsets, sizes):
        full = buf[off:off + n].view(s.local.dtype).view(s.shape)
        if _owns(mesh, s):
            full[sharding.block_slices(mesh, s.shape, s.spec)] = s.local
        fulls.append(full)
    mesh.sum_bytes(buf)
    return fulls


def gather(tree: Any, mesh=None) -> Any:
    """``tree`` with every ``Shard`` leaf gathered whole over ``mesh`` (by
    default the policy's: the block boundary's anchor), all in one
    collective; without a mesh or a policy, or without a shard in it,
    ``tree`` itself."""
    if mesh is None:
        if _POLICY is None:
            return tree
        mesh = _POLICY.mesh
    shards = [x for x in tree_leaves(tree) if isinstance(x, sharding.Shard)]
    if not shards:
        return tree
    fulls = iter(_gather_shards(mesh, shards))
    return tree_map(lambda x: next(fulls)
                    if isinstance(x, sharding.Shard) else x, tree)


# ---------------------------------------------------------- batch rows
def batch_sharded() -> bool:
    """True while a batch's rows are spread over the data group."""
    return _POLICY is not None and _POLICY.shard_batch


def _data(mesh) -> Tuple[int, int]:
    return mesh.coords["data"], mesh.shape["data"]


def global_rows(m: int) -> Tuple[int, int]:
    """(rows of the whole batch, this rank's first row) for ``m`` local
    rows of a batch-major tensor; ``(m, 0)`` when nothing is sharded."""
    if not batch_sharded():
        return m, 0
    i, d = _data(_POLICY.mesh)
    return m * d, m * i


def is_data_leader() -> bool:
    """True on the first rank of the data group, and when nothing is
    sharded: the rank that keeps counts the whole group computed alike."""
    return not batch_sharded() or _data(_POLICY.mesh)[0] == 0


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The data group's rows of ``x`` (dim 0), in rank order."""
    if not batch_sharded():
        return x
    mesh = _POLICY.mesh
    m = x.shape[0]
    total, lo = global_rows(m)
    full = torch.zeros((total,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device)
    full[lo:lo + m] = x
    return mesh.sum_bytes(full, group=mesh.data_group)


def own_rows(y: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole-batch ``y`` (dim 0)."""
    if not batch_sharded():
        return y
    i, d = _data(_POLICY.mesh)
    m = y.shape[0] // d
    return y[i * m:(i + 1) * m]


def store_rows(rows: int, tile: int) -> int:
    """Rows of a checkpoint buffer for a GEMM of ``rows`` local rows: the
    whole batch's when its tiles would straddle ranks (``ExecContext``
    then runs it on the gathered rows)."""
    if batch_sharded() and rows % tile:
        return global_rows(rows)[0]
    return rows


# --------------------------------------------------------- reductions
def data_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data group (a new tensor)."""
    if not batch_sharded():
        return t
    mesh = _POLICY.mesh
    return mesh.all_reduce(t.clone(), group=mesh.data_group)


def data_amax(amax: torch.Tensor) -> torch.Tensor:
    """The max over the data group of a 0-d max |x|, in its dtype; NaN
    anywhere gives NaN, as ``amax`` over the whole batch does."""
    if not batch_sharded():
        return amax
    mesh = _POLICY.mesh
    a = amax.float()
    nan = torch.isnan(a)
    pair = torch.stack([torch.where(nan, torch.zeros_like(a), a),
                        nan.float()])
    mesh.all_reduce(pair, op=dist.ReduceOp.MAX, group=mesh.data_group)
    out = torch.where(pair[1] > 0, torch.full_like(pair[0], float("nan")),
                      pair[0])
    return out.to(amax.dtype)


# ------------------------------------------------ rows of a split train step
_SPLIT_MESH = None


@contextlib.contextmanager
def split_rows(mesh):
    """Within: a train step's rows are split over ``mesh``'s data axes
    (``sharding.batch_rows``), so a layer that needs the whole batch
    gathers it (``models.moe.moe_layer``). Serving never enters it."""
    global _SPLIT_MESH
    prev, _SPLIT_MESH = _SPLIT_MESH, mesh
    try:
        yield
    finally:
        _SPLIT_MESH = prev


def split_rows_mesh():
    """The mesh of the enclosing ``split_rows``, else None."""
    return _SPLIT_MESH


def data_block(mesh) -> Tuple[int, int]:
    """(index, count) of this rank's block over the mesh's (pod, data)
    axes, pod major: the block ``sharding.batch_rows`` gives it."""
    return sharding.block_index(mesh, sharding.data_axes(mesh))


class _GatherRowsGrad(torch.autograd.Function):
    """Forward: the data group's rows of ``x`` (dim 0), each rank's block
    at its ``data_block``, written into a zeroed buffer and summed as
    integers (exact). Backward: the incoming gradient summed over the
    group in f32, this rank's rows of it in the gradient's dtype."""

    @staticmethod
    def forward(ctx, x, mesh):
        i, n = data_block(mesh)
        m = x.shape[0]
        ctx.mesh, ctx.rows = mesh, slice(i * m, (i + 1) * m)
        full = torch.zeros((n * m,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device)
        full[ctx.rows] = x
        return mesh.sum_bytes(full, group=mesh.data_group)

    @staticmethod
    def backward(ctx, g):
        acc = g.to(torch.float32, copy=True).contiguous()
        ctx.mesh.all_reduce(acc, group=ctx.mesh.data_group)
        return acc[ctx.rows].to(g.dtype), None


def gather_rows_grad(x: torch.Tensor, mesh) -> torch.Tensor:
    """The data group's rows of ``x`` (dim 0), in the order of the ranks'
    blocks over (pod, data); differentiable: each rank's gradient is its
    rows of the group's summed gradient (``_GatherRowsGrad``)."""
    return _GatherRowsGrad.apply(x, mesh)
