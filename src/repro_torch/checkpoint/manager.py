"""Fault-tolerant training checkpoints: atomic and verified.

Counterpart of ``repro.checkpoint.manager``, with its protocol:

  * **Atomic**: leaves are written to ``step_XXXXXXXX.tmp/``, then the
    directory is ``os.rename``'d, so a crash mid-write never corrupts the
    latest checkpoint. A ``MANIFEST.json`` records the tree's structure,
    each leaf's shape and dtype and the first 16 hex digits of its
    SHA256.
  * **Verified restore**: hashes are checked on load; a corrupt
    checkpoint is skipped and the previous valid one used
    (``restore_latest`` walks backwards).
  * **Garbage collection**: ``save`` keeps the newest ``keep_last``.
  * **Pipeline state**: the data pipeline is a function of (seed, step)
    (``data.synthetic``), so the step captures it.
  * **Elastic / reshard-on-restore**: leaves are stored unsharded. A
    state held on a mesh (``sharding.Shard`` leaves) is saved with its
    mesh: every leaf is gathered whole (``constraints.gather``, exact),
    rank 0 writes, and every rank waits at a barrier.
    ``restore_resharded(template, mesh)`` has every rank read and verify
    the newest valid step and take its block under ``mesh``'s rules
    (``sharding.shard_state``), so a state saved on a (2, 1) mesh
    restores onto (1, 2), or onto one process (``mesh=None``).

Leaves are written from CPU numpy copies (a bf16 tensor as its 16-bit
words, since numpy has no bf16; the manifest keeps the torch dtype).
Host ints, such as the train state's step, are leaves too. A restore
lands each leaf on its template leaf's device (a ``Shard``'s block's
device), in the saved dtype.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import re
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.constraints import gather
from repro_torch.distributed.sharding import Shard, shard_state
from repro_torch.tree import (tree_leaves, tree_map, tree_structure,
                              tree_unflatten)

_INT_LEAF = "int"


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(host array, dtype name) of a tensor or a host int."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy(), name
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(int(leaf), np.int64), _INT_LEAF
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf)}")


def _device_of(leaf):
    if isinstance(leaf, Shard):
        return leaf.local.device
    return leaf.device if isinstance(leaf, torch.Tensor) else "cpu"


def _from_numpy(a: np.ndarray, dtype: str, device):
    if dtype == _INT_LEAF:
        return int(a)
    t = torch.from_numpy(a)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def _sha(a: np.ndarray) -> str:
    """The first 16 hex digits of the SHA256 of ``a``'s bytes (hashed in
    place: no copy, and without the interpreter lock)."""
    data = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    return hashlib.sha256(data).hexdigest()[:16]


#: threads that write or read and hash a checkpoint's leaves
IO_THREADS = min(8, os.cpu_count() or 1)


def _write_leaf(tmp: str, i: int, a: np.ndarray, dtype: str) -> Dict:
    np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), a)
    return {"shape": list(a.shape), "dtype": dtype, "sha256": _sha(a)}


def _read_leaf(path: str, i: int) -> Tuple[np.ndarray, str]:
    a = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
    return a, _sha(a)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep_last: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    # ----------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             mesh=None) -> str:
        """Write ``tree`` as step ``step``. A tree with ``Shard`` leaves
        needs the ``mesh`` that holds it: each leaf is gathered whole
        (leaves of up to GATHER_BYTES in one collective), rank 0 writes,
        and every rank returns after a barrier."""
        final = self._path(step)
        writer = mesh is None or mesh.rank == 0
        manifest = {"step": step, "treedef": tree_structure(tree),
                    "extra": extra or {}, "leaves": []}
        tmp = final + ".tmp"
        if writer:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        # leaves are written and hashed on worker threads (both release
        # the interpreter lock) while the next ones are gathered
        with ThreadPoolExecutor(IO_THREADS) as pool:
            written = [pool.submit(_write_leaf, tmp, i, *_to_numpy(leaf))
                       for i, leaf in _whole_leaves(tree, mesh) if writer]
            manifest["leaves"] = [f.result() for f in written]
        if writer:
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)           # atomic publish
            self._gc()
        if mesh is not None:
            mesh.barrier()
        return final

    # -------------------------------------------------------- restore
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _load(self, step: int, template: Any, device=None
              ) -> Tuple[Any, Dict]:
        path = self._path(step)
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        slots = tree_leaves(template)
        if len(slots) != len(manifest["leaves"]):
            raise IOError(f"{path} holds {len(manifest['leaves'])} leaves, "
                          f"the template {len(slots)}")
        with ThreadPoolExecutor(IO_THREADS) as pool:
            read = list(pool.map(lambda i: _read_leaf(path, i),
                                 range(len(slots))))
        leaves = []
        for i, ((a, sha), meta, slot) in enumerate(
                zip(read, manifest["leaves"], slots)):
            if sha != meta["sha256"]:
                raise IOError(f"hash mismatch in {path} leaf {i}")
            leaves.append(_from_numpy(
                a, meta["dtype"], device or _device_of(slot)))
        return tree_unflatten(template, leaves), manifest["extra"]

    def restore_latest(self, template: Any, device=None
                       ) -> Optional[Tuple[int, Any, Dict]]:
        """Walk back from the newest step until a checkpoint verifies;
        every leaf lands on ``device``, else on its template leaf's."""
        for step in reversed(self.steps()):
            try:
                tree, extra = self._load(step, template, device)
                return step, tree, extra
            except (OSError, ValueError) as e:   # JSONDecodeError too
                print(f"[ckpt] step {step} invalid ({e}); trying previous")
        return None

    def restore_resharded(self, template: Any, mesh=None
                          ) -> Optional[Tuple[int, Any, Dict]]:
        """``restore_latest`` onto ``mesh`` (possibly another split than the
        one that saved): every rank reads and verifies the whole leaves on
        the host, then keeps its block of each (``sharding.shard_state``)
        on its template leaf's device; with no mesh, the whole tree."""
        got = self.restore_latest(template, device="cpu")
        if got is None:
            return None
        step, tree, extra = got
        if mesh is not None:
            tree = shard_state(tree, mesh)
        slots = iter(tree_leaves(template))

        def place(x):
            dev = _device_of(next(slots))
            if isinstance(x, Shard):
                return Shard(x.local.to(dev), x.shape, x.spec)
            return x.to(dev) if isinstance(x, torch.Tensor) else x
        return step, tree_map(place, tree), extra

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self._path(s), ignore_errors=True)


#: bytes of sharded leaves gathered in one collective by ``save``
GATHER_BYTES = 1 << 30


def _whole_leaves(tree: Any, mesh) -> Iterator[Tuple[int, Any]]:
    """(index, whole leaf) of ``tree``'s leaves in order, each ``Shard``
    gathered over ``mesh``: the leaves go in runs whose shards hold up to
    GATHER_BYTES, each run's shards gathered in one collective (every
    rank cuts the same runs)."""
    leaves = tree_leaves(tree)
    start = 0
    while start < len(leaves):
        end, size = start, 0
        while end < len(leaves) and size < GATHER_BYTES:
            if isinstance(leaves[end], Shard):
                s = leaves[end]
                size += math.prod(s.shape) * s.local.element_size()
            end += 1
        run = leaves[start:end]
        if mesh is None and any(isinstance(x, Shard) for x in run):
            raise ValueError("a tree with sharded leaves is saved with the "
                             "mesh that holds them")
        yield from enumerate(gather(run, mesh) if mesh is not None
                             else run, start)
        start = end
