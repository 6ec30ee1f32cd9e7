"""Rollback-ABFT: correct large errors with values from a previous timestep.

Counterpart of ``repro.core.rollback`` (Sec 5.3-5.4 of the paper).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

CkptStore = Dict[str, torch.Tensor]

# The paper's default checkpoint-refresh cadence (Sec 6.4), the same
# constant as the reference's.
DEFAULT_INTERVAL = 10


@dataclasses.dataclass(frozen=True)
class RollbackConfig:
    interval: int = DEFAULT_INTERVAL   # refresh checkpoints every n steps


def should_checkpoint(step: int, interval: int) -> bool:
    """Steps 0, n, 2n, ... refresh the checkpoint store."""
    return step % interval == 0


def effective_checkpoint(current: torch.Tensor,
                         checkpoint: Optional[torch.Tensor],
                         have_ckpt: bool) -> torch.Tensor:
    """What masked positions are replaced with: the checkpoint, or zeros
    when there is none yet or ``have_ckpt`` is false."""
    if checkpoint is None or not have_ckpt:
        return torch.zeros_like(current)
    return checkpoint


def store_bytes(store: CkptStore) -> int:
    """A checkpoint store's footprint: the bytes each refresh writes (the
    reference's 'DRAM offload' volume)."""
    return int(sum(v.numel() * v.element_size() for v in store.values()))
