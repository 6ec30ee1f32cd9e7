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

Leaves are written from CPU numpy copies (a bf16 tensor as its 16-bit
words, since numpy has no bf16; the manifest keeps the torch dtype).
Host ints, such as the train state's step, are leaves too. A restore
lands each leaf on its template leaf's device, in the saved dtype.
Restoring onto another mesh (the reference's ``restore_resharded``)
waits for the port's multi-device path (ROADMAP Queue A item 13).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_structure, tree_unflatten

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


def _from_numpy(a: np.ndarray, dtype: str, template):
    if dtype == _INT_LEAF:
        return int(a)
    t = torch.from_numpy(a)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    dev = template.device if isinstance(template, torch.Tensor) else "cpu"
    return t.to(dev)


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep_last: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    # ----------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
        final = self._path(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "treedef": tree_structure(tree),
                    "extra": extra or {}, "leaves": []}
        for i, leaf in enumerate(tree_leaves(tree)):
            a, dtype = _to_numpy(leaf)
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), a)
            manifest["leaves"].append({"shape": list(a.shape),
                                       "dtype": dtype, "sha256": _sha(a)})
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic publish
        self._gc()
        return final

    # -------------------------------------------------------- restore
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _load(self, step: int, template: Any) -> Tuple[Any, Dict]:
        path = self._path(step)
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        slots = tree_leaves(template)
        if len(slots) != len(manifest["leaves"]):
            raise IOError(f"{path} holds {len(manifest['leaves'])} leaves, "
                          f"the template {len(slots)}")
        leaves = []
        for i, (meta, slot) in enumerate(zip(manifest["leaves"], slots)):
            a = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
            if _sha(a) != meta["sha256"]:
                raise IOError(f"hash mismatch in {path} leaf {i}")
            leaves.append(_from_numpy(a, meta["dtype"], slot))
        return tree_unflatten(template, leaves), manifest["extra"]

    def restore_latest(self, template: Any
                       ) -> Optional[Tuple[int, Any, Dict]]:
        """Walk back from the newest step until a checkpoint verifies."""
        for step in reversed(self.steps()):
            try:
                tree, extra = self._load(step, template)
                return step, tree, extra
            except (OSError, ValueError) as e:   # JSONDecodeError too
                print(f"[ckpt] step {step} invalid ({e}); trying previous")
        return None

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self._path(s), ignore_errors=True)
