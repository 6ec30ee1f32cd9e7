"""Sampler cache: one built sampler per serving configuration.

Counterpart of ``repro.serving.cache``. PyTorch runs eagerly, so there is
nothing to trace or compile; the cache keeps the built sampler callable per
``SamplerKey`` and counts *builds* (factory calls), which stand in for the
reference's JAX traces: each key builds exactly once per engine.
``on_compile(key, seconds)`` fires on every miss with the host time of
the build (the flight recorder's ``compile`` span).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

from repro_torch.core.rollback import DEFAULT_INTERVAL


@dataclasses.dataclass(frozen=True)
class SamplerKey:
    """Hashable identity of one sampler configuration."""
    arch: str
    smoke: bool
    steps: int
    mode: str
    op: str            # operating-point name; "" when no DVFS schedule
    bucket: int        # batch size
    taylorseer: bool = False
    # Precision-plan name (core.quant.PRECISION_PLANS). The clean
    # reference's key resets it to "int8": references are scored at full
    # width.
    precision: str = "int8"
    # Always a concrete int here: "auto" requests resolve through the
    # offload planner (engine.auto_rollback_interval) before keying.
    rollback_interval: int = DEFAULT_INTERVAL


class CompiledSamplerCache:
    """Maps SamplerKey -> built sampler, with build accounting."""

    def __init__(self) -> None:
        self._fns: Dict[SamplerKey, Callable] = {}
        self.builds = 0     # cache misses (factory invocations)
        self.hits = 0       # cache hits
        # miss tap: (key, host seconds the factory took)
        self.on_compile: Optional[Callable[[SamplerKey, float], None]] = None

    def get(self, key: SamplerKey,
            factory: Callable[[SamplerKey], Callable]) -> Callable:
        fn = self._fns.get(key)
        if fn is not None:
            self.hits += 1
            return fn
        t0 = time.perf_counter()
        fn = self._fns[key] = factory(key)
        self.builds += 1
        if self.on_compile is not None:
            self.on_compile(key, time.perf_counter() - t0)
        return fn

    def __contains__(self, key: SamplerKey) -> bool:
        return key in self._fns

    def __len__(self) -> int:
        return len(self._fns)
