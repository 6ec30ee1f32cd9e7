"""Elastic scaling + straggler mitigation policies.

A copy of ``repro.distributed.elastic``, which is pure Python: the port
keeps its own copy rather than importing the reference's package. The
train launcher lays ``plan_mesh``'s plan for its ranks over them
(``launch.mesh.make_mesh``), and a resume goes through
``CheckpointManager.restore_resharded`` onto that mesh.

This module holds the *decision logic* (pure, unit-testable); the actuation
is launch-level (re-create the mesh, restore-resharded from the checkpoint
manager). On thousands of nodes the failure model is: a host vanishes
(preemption/hardware), a host slows down (thermals, flaky HBM, network), or
a pod-link degrades.

  * ``plan_mesh``: given the surviving device count, pick the largest valid
    (pod, data, model) factorization that keeps the model axis intact
    (TP degree is fixed by memory), shrinking data parallelism first --
    restore-resharded then maps the old state onto the new mesh.
  * ``StragglerDetector``: per-host step-time EMA; a host is a straggler
    when its EMA exceeds median * threshold. Mitigation at this layer is
    deterministic data re-dispatch: the synthetic/deterministic pipeline
    lets any host regenerate any shard, so reassigning shards needs no data
    movement -- plus (documented) gradient-bucket overlap so a slow host
    only delays its last bucket, not the whole all-reduce.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


def plan_mesh(n_devices: int, model_parallel: int,
              chips_per_pod: int = 256
              ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest (pod, data, model) grid for the surviving device count.

    The pod axis reflects PHYSICAL pods (256 chips each); partial pods fall
    back to one flat data axis (a degraded-but-running configuration)."""
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices cannot keep TP={model_parallel}")
    rest = n_devices // model_parallel
    pods = n_devices // chips_per_pod if n_devices % chips_per_pod == 0 else 1
    if pods > 1 and rest % pods == 0:
        return (pods, rest // pods, model_parallel), ("pod", "data", "model")
    return (rest, model_parallel), ("data", "model")


@dataclasses.dataclass
class StragglerDetector:
    threshold: float = 1.5
    decay: float = 0.8
    ema: Dict[int, float] = dataclasses.field(default_factory=dict)

    def update(self, host_times: Dict[int, float]) -> List[int]:
        """Feed per-host step times; returns current straggler host ids."""
        for h, t in host_times.items():
            self.ema[h] = (self.decay * self.ema.get(h, t)
                           + (1 - self.decay) * t)
        if len(self.ema) < 2:
            return []
        med = float(np.median(list(self.ema.values())))
        return [h for h, t in self.ema.items() if t > self.threshold * med]

    def reassign_shards(self, shards: Dict[int, int],
                        stragglers: List[int]) -> Dict[int, int]:
        """Move shards off stragglers onto the fastest hosts (deterministic
        pipeline => reassignment is just an index remap, no data motion)."""
        if not stragglers:
            return dict(shards)
        healthy = sorted([h for h in shards if h not in stragglers],
                         key=lambda h: self.ema.get(h, 0.0))
        out = dict(shards)
        for i, s in enumerate(stragglers):
            if healthy:
                out[s], out[healthy[i % len(healthy)]] = \
                    out[healthy[i % len(healthy)]], out[s]
        return out
