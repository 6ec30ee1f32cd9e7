"""Per-architecture sharding rules for the (pod, data, model) mesh.

Counterpart of ``repro.distributed.sharding``. The rules are pure data:
the same regexes in the same order, the same divisibility fix-up, and the
same specs for batches, KV caches, SSM states and logits (MaxText-style
FSDP on ``data`` and tensor/expert parallelism on ``model``; see the
reference's module docstring for the conventions).

A spec is a tuple with one entry per dim: ``None``, an axis name, or a
tuple of names, laid out as ``jax.sharding.PartitionSpec`` (a tuple
subclass, so the two compare with ``==``). A *mesh* here is anything with
``axis_names`` and a ``shape`` mapping name -> size: the port's
``launch.mesh.Mesh`` (``coords`` too, for a rank's blocks), or a JAX
``AbstractMesh`` in the tests.

Param paths are the ``"/"``-joined keys of the port's trees. They match
the reference's but for two things, both mapped here: the port keeps
per-layer lists (``blocks/3/attn/wq``; the reference stacks a leading L
axis, which the rules pad with ``None``), and the prepared LM weights
(``transformer.Weights``) hold each projection as a ``Proj`` whose
fields ``w``, ``w_sum`` and ``w_abs_sum`` take the rule of the
projection they belong to (``layers/0/attn/wq``), the two (K,) sums
the rule's last entry, as any 1-D leaf does.

The serving engine holds its weights at rest as ``Shard`` leaves
(``shard_tree``): each rank keeps its block of every weight, and the
models gather a block's weights where they use them
(``distributed.constraints.gather``). A train state on a mesh holds its
params and optimizer moments the same way (``state_specs``,
``shard_state``; ``constraints.gather`` makes them whole), the
counterpart of the reference's ``shardings_for(state, mesh)``; a rank
takes its rows of the global batch by ``batch_spec`` (``batch_rows``).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

Spec = Tuple[Any, ...]


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


# --------------------------------------------------------------- params
# (path regex, spec builder(data axes)), applied to the LAST dims; a
# stacked leading L axis is padded with None. Order matters: the
# expert-parallel MoE rules precede the generic w_gate/w_up/w_down ones.
_RULES = [
    (r"moe/w_gate$",           lambda d: ("model", d, None)),  # (E, dm, f)
    (r"moe/w_up$",             lambda d: ("model", d, None)),
    (r"moe/w_down$",           lambda d: ("model", None, d)),
    (r"embed$",                lambda d: ("model", d)),        # (V, dm)
    (r"lm_head$",              lambda d: (d, "model")),        # (dm, V)
    (r"(wq|wk|wv)$",           lambda d: (d, "model")),
    (r"wo$",                   lambda d: ("model", d)),
    (r"(w_gate|w_up|mlp_w1|t_w1|t_w2|adaln_w|in_proj|patch_w|text_proj)$",
                               lambda d: (d, "model")),
    (r"(w_down|mlp_w2|out_proj)$", lambda d: ("model", d)),
    (r"final_adaln_w$",        lambda d: (d, "model")),
    (r"final_w$",              lambda d: (d, None)),
    (r"router$",               lambda d: (None, None)),        # replicated
    (r"conv_w$",               lambda d: (None, "model")),     # (cw, cch)
    (r"(conv_b|norm_scale)$",  lambda d: ("model",)),
    (r"pos_embed|enc_pos",     lambda d: (None, None)),
    (r"class_embed$",          lambda d: (None, d)),
    (r"(conv1|conv2|skip|down|up|conv_in|conv_out)$",
                               lambda d: (None, None, None, "model")),
    (r"temb_w$",               lambda d: (d, "model")),
]


def _axes_size(mesh, entry) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(axis_size(mesh, a) for a in names)


def _fix_divisibility(spec: Spec, shape, mesh) -> Spec:
    """Drop mesh axes from dims they do not divide (mamba2's vocab 50280
    or hymba's in_proj 6482 are not multiples of 16)."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is not None and dim % _axes_size(mesh, entry) != 0:
            entry = None
        out.append(entry)
    return tuple(out[: len(shape)])


def spec_for_param(path: str, shape, mesh) -> Spec:
    ndim = len(shape)
    d = data_axes(mesh)
    d = d if len(d) > 1 else (d[0] if d else None)
    for pat, builder in _RULES:
        if re.search(pat, path):
            spec = builder(d)
            pad = ndim - len(spec)
            if pad < 0:   # fewer dims than the rule (e.g. a bias)
                spec = tuple(spec[-ndim:]) if ndim else ()
            else:
                spec = (None,) * pad + tuple(spec)
            return _fix_divisibility(spec, shape, mesh)
    return (None,) * ndim   # replicate (norms, scalars, biases)


_PROJ_FIELDS = ("w", "w_sum", "w_abs_sum")


def _walk(tree: Any, fn, path: str = ""):
    """``fn(path, leaf)`` over a param tree (dicts, lists, tuples, named
    tuples and dataclasses such as ``transformer.Weights``), rebuilding
    it; a ``Proj``'s fields take the projection's path."""
    def join(k):
        return f"{path}/{k}" if path else str(k)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk(v, fn, join(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        if tuple(tree._fields) == _PROJ_FIELDS:
            return type(tree)(*(_walk(v, fn, path) for v in tree))
        return type(tree)(*(_walk(v, fn, join(f))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, join(i)) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _walk(getattr(tree, f.name), fn, join(f.name))
            for f in dataclasses.fields(tree)})
    return fn(path, tree)


def param_specs(tree: Any, mesh) -> Any:
    """The spec tree of a param tree (every leaf with a ``shape``)."""
    return _walk(tree, lambda p, leaf: spec_for_param(
        p, tuple(leaf.shape) if hasattr(leaf, "shape") else (), mesh))


def replicated(mesh) -> Spec:
    """Fully replicated: every rank holds the whole array (the serving
    engine's BER-monitor state and scalar counters)."""
    return ()


def spec_str(spec: Spec) -> str:
    """Canonical short string for a spec, e.g. ``"data,None,None"`` (the
    hashable mesh-placement component of the serving ``SamplerKey``)."""
    def one(entry):
        if isinstance(entry, tuple):
            return "+".join(str(a) for a in entry)
        return str(entry)
    return ",".join(one(e) for e in spec)


# --------------------------------------------------------------- batches
def batch_spec(shape: Tuple[int, ...], mesh,
               seq_dim: Optional[int] = None) -> Spec:
    """Shard dim 0 (batch) over (pod, data) when divisible; else shard
    ``seq_dim`` and replicate the batch (the batch=1 long-decode cell)."""
    d = data_axes(mesh)
    dsize = math.prod(axis_size(mesh, a) for a in d)
    spec = [None] * len(shape)
    if shape[0] % dsize == 0 and dsize > 1:
        spec[0] = d if len(d) > 1 else d[0]
    elif seq_dim is not None and shape[seq_dim] % dsize == 0:
        spec[seq_dim] = d if len(d) > 1 else d[0]
    return tuple(spec)


def cache_spec(cfg, shape: Tuple[int, ...], mesh) -> Spec:
    """(L, B, S, Hkv, hd) KV-cache sharding."""
    d = data_axes(mesh)
    dsize = math.prod(axis_size(mesh, a) for a in d)
    msize = axis_size(mesh, "model")
    _, b, _, hkv, _ = shape
    spec: list = [None] * 5
    if b % dsize == 0 and dsize > 1:
        spec[1] = d if len(d) > 1 else d[0]
        if hkv % msize == 0:
            spec[3] = "model"
        else:
            spec[2] = "model"           # glm4/gemma2/kimi GQA: shard seq
    else:
        # batch=1 long context: shard the sequence over the data axes
        spec[2] = d if len(d) > 1 else d[0]
        if hkv % msize == 0:
            spec[3] = "model"
    return tuple(spec)


def ssm_state_spec(cfg, shape: Tuple[int, ...], mesh) -> Spec:
    """(L, B, G, Hg, N, P) SSD state: heads on model, batch on data."""
    d = data_axes(mesh)
    dsize = math.prod(axis_size(mesh, a) for a in d)
    spec: list = [None] * len(shape)
    if len(shape) >= 2 and shape[1] % dsize == 0 and dsize > 1:
        spec[1] = d if len(d) > 1 else d[0]
    if len(shape) >= 4 and shape[3] % axis_size(mesh, "model") == 0:
        spec[3] = "model"
    return tuple(spec)


def logits_spec(mesh) -> Spec:
    d = data_axes(mesh)
    return (d if len(d) > 1 else (d[0] if d else None), None, "model")


# ------------------------------------------------------- weights at rest
@dataclasses.dataclass(frozen=True)
class Shard:
    """One rank's block of a weight: ``local`` is the block, ``shape`` the
    whole weight's, ``spec`` how the mesh splits it. A leaf of the trees
    ``shard_tree`` builds; ``constraints.gather`` makes it whole again."""
    local: torch.Tensor
    shape: Tuple[int, ...]
    spec: Spec


def block_index(mesh, entry) -> Tuple[int, int]:
    """(index, count) of this rank's block along a dim split by
    ``entry`` (None, an axis name or a tuple of names, major first)."""
    if entry is None:
        return 0, 1
    idx, count = 0, 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        n = axis_size(mesh, a)
        idx, count = idx * n + mesh.coords[a], count * n
    return idx, count


def block_slices(mesh, shape, spec) -> Tuple[slice, ...]:
    out = []
    for dim, entry in zip(shape, spec):
        i, n = block_index(mesh, entry)
        out.append(slice(i * dim // n, (i + 1) * dim // n))
    return tuple(out)


def shard_tensor(x: torch.Tensor, spec: Spec, mesh) -> Shard:
    return Shard(x[block_slices(mesh, x.shape, spec)].clone(),
                 tuple(x.shape), tuple(spec))


def shard_tree(tree: Any, mesh) -> Any:
    """``tree`` with each tensor of rank >= 1 replaced by this rank's
    ``Shard`` of it, by ``spec_for_param``; scalars stay whole."""
    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.ndim == 0:
            return leaf
        return shard_tensor(leaf, spec_for_param(path, tuple(leaf.shape),
                                                 mesh), mesh)
    return _walk(tree, one)


# ---------------------------------------------------------- train state
def state_specs(state: Any, mesh) -> Any:
    """The spec tree of a train state (``train.steps.TrainState``), as the
    reference's ``param_specs`` gives it over its ``TrainState``: a named
    tuple's fields add nothing to a path (JAX's path string drops
    attribute keys), so the params, AdamW's ``mu``/``nu`` and Adafactor's
    ``vr``/``vc`` take their param's rule by path, fixed up for their own
    shapes; host ints (the steps, the seed) are replicated."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(state_specs(v, mesh) for v in state))
    return param_specs(state, mesh)


def shard_state(state: Any, mesh) -> Any:
    """``state`` with each tensor of rank >= 1 replaced by this rank's
    ``Shard`` of it, by ``state_specs``; scalars and host ints stay
    whole."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(shard_state(v, mesh) for v in state))
    return shard_tree(state, mesh)


def local(tree: Any) -> Any:
    """``tree`` with each ``Shard`` replaced by this rank's block."""
    return tree_map(lambda x: x.local if isinstance(x, Shard) else x, tree)


def block_of(tree: Any, like: Any, mesh) -> Any:
    """This rank's block of each whole tensor of ``tree`` where ``like``
    holds a ``Shard`` (by that shard's spec; a view, not a copy)."""
    leaves = iter(tree_leaves(like))
    return tree_map(lambda x: _block(x, next(leaves), mesh), tree)


def rewrap(blocks: Any, like: Any) -> Any:
    """``blocks`` (this rank's blocks, where ``like`` holds a ``Shard``) as
    ``Shard`` leaves with ``like``'s shapes and specs."""
    leaves = iter(tree_leaves(like))

    def one(x):
        s = next(leaves)
        return Shard(x, s.shape, s.spec) if isinstance(s, Shard) else x
    return tree_map(one, blocks)


def reshard_like(tree: Any, like: Any, mesh) -> Any:
    """``tree``'s whole tensors as this rank's ``Shard`` of them where
    ``like`` holds a ``Shard``, by its spec."""
    leaves = iter(tree_leaves(like))

    def one(x):
        s = next(leaves)
        return shard_tensor(x, s.spec, mesh) if isinstance(s, Shard) else x
    return tree_map(one, tree)


def _block(x, s, mesh):
    if not isinstance(s, Shard):
        return x
    return x[block_slices(mesh, x.shape, s.spec)]


def batch_rows(n: int, mesh) -> slice:
    """This rank's rows of a batch of ``n`` (dim 0), by ``batch_spec``:
    its block over the (pod, data) axes when they divide ``n``, else every
    row (the batch is replicated)."""
    entry = batch_spec((n,), mesh)[0]
    i, count = block_index(mesh, entry)
    return slice(i * n // count, (i + 1) * n // count)
