"""The hook through which ``launch.op_analysis`` counts a kernel wrapper.

While ``op_analysis.analyze`` runs a call, ``COUNTER`` holds its counter.
Each wrapper records its kernel's own work (its module's ``work(...)``:
FLOPs, int8 operations and bytes) through ``kernel(name, work, *args)``,
and the ops of the wrapper's body, its plain version on the CPU or its
output allocations on the card, are not counted a second time. While a
counter is active, and only then, a wrapper takes ``meta`` tensors: it
returns outputs of the right shape and dtype and launches nothing
(``meta_call``). Outside a count a meta tensor still raises.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

#: the active counter (``op_analysis._Counter``), or None
COUNTER: Optional[object] = None
_IDLE = contextlib.nullcontext()


def kernel(name: str, work: Callable[..., Dict[str, int]], *args):
    """A context for a wrapper's body: with a counter active, it records
    ``work(*args)`` for kernel ``name`` and counts no op inside the
    block; without one, it does nothing (``work`` is not called, so the
    serving paths pay no count)."""
    counter = COUNTER
    if counter is None:
        return _IDLE
    counter.add_kernel(name, work(*args))
    return counter.paused()


def meta_call(device: torch.device) -> bool:
    """True when a wrapper is handed meta tensors under a counter: it
    then returns empty meta outputs. Raises for meta outside a count."""
    if device.type != "meta":
        return False
    if COUNTER is None:
        raise ValueError("kernel wrappers take meta tensors only inside "
                         "launch.op_analysis.analyze")
    return True
