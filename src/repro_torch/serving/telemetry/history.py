"""Served-batch history store + learned latency estimator.

Counterpart of ``repro.serving.telemetry.history``, unchanged but for
its imports.

The DeadlineScheduler's admission projections are only as good as its
latency estimates. The perfmodel clock is *worst-case-calibrated and
open-loop*: it prices a configuration once and never looks at what the
engine actually measured. This module closes that gap (the Energy
Scaling Laws argument -- deployment decisions should be driven by
measured, not modeled, cost):

* ``BatchObservation`` -- one served batch's measured latency, stamped
  with the full pricing key ``(arch, op, steps, bucket)`` plus the
  engine clock and batch index;
* ``LatencyEstimator`` -- per-key online model: an EWMA point estimate
  plus a bounded window of raw observations for percentile queries
  (p50/p99 feed the benchmark trajectory and the backlog projection's
  tail view). The key carries mode/taylorseer/rollback_interval
  discriminators beyond the scheduler's pricing signature so
  differently-billed batches never pool.

Contract with the scheduler (``serving/scheduler.py``):

* ``estimate_s`` returns ``None`` until ``min_observations`` batches of
  that key have been served -- the scheduler then falls back to the
  perfmodel clock, making the empty-history path **bit-identical** to
  the pre-telemetry scheduler (asserted in tests/test_torch_scheduler.py);
* once history exists, the estimate is
  ``max(EWMA, percentile(conservative_percentile))`` -- the EWMA tracks
  drift quickly, the percentile guard keeps one lucky fast batch from
  under-promising completion times (admission must stay conservative).

The estimator is plain host-side Python fed once per batch; nothing
here runs on the card.
"""
from __future__ import annotations

import bisect
import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from repro_torch.core.rollback import DEFAULT_INTERVAL
from repro_torch.serving.telemetry.metrics import nearest_rank

# (arch, resolved operating-point name, steps, bucket, mode, taylorseer,
# rollback_interval, precision): everything that changes a batch's billed
# latency. The first four mirror the scheduler's perfmodel pricing
# signature; the rest keep differently-billed batches (a clean-mode batch
# pays no ABFT/checkpoint overhead, TaylorSeer skips model evals, the
# rollback interval scales checkpoint DRAM traffic, a narrowed precision
# plan streams the body faster) from contaminating each other's learned
# estimates.
LatencyKey = Tuple[str, str, int, int, str, bool, int, str]


@dataclasses.dataclass(frozen=True)
class BatchObservation:
    """One served micro-batch's measured (virtual-clock) latency."""
    arch: str
    op: str                # resolved operating-point name ("" for clean)
    steps: int
    bucket: int
    latency_s: float
    clock_s: float         # engine virtual clock after the batch
    batch_index: int
    mode: str = "drift"
    taylorseer: bool = False
    rollback_interval: int = DEFAULT_INTERVAL
    precision: str = "int8"

    @property
    def key(self) -> LatencyKey:
        return (self.arch, self.op, self.steps, self.bucket, self.mode,
                self.taylorseer, self.rollback_interval, self.precision)


class _KeyModel:
    # window keeps insertion order (for eviction); sorted_window is the
    # same values kept sorted incrementally, so percentile queries on the
    # admission hot path are O(1) lookups, not O(n log n) sorts.
    __slots__ = ("ewma", "n", "window", "sorted_window")

    def __init__(self) -> None:
        self.ewma: Optional[float] = None
        self.n = 0
        self.window: List[float] = []
        self.sorted_window: List[float] = []


class LatencyEstimator:
    """Online per-configuration latency model over served-batch history."""

    def __init__(self, decay: float = 0.7, window: int = 128,
                 min_observations: int = 1,
                 conservative_percentile: float = 90.0) -> None:
        assert 0.0 < decay <= 1.0, decay
        self.decay = decay
        self.window = window
        self.min_observations = min_observations
        self.conservative_percentile = conservative_percentile
        self._models: Dict[LatencyKey, _KeyModel] = {}
        self._lock = threading.Lock()
        self.total_observations = 0

    # ------------------------------------------------------------ feeding
    def observe(self, obs: BatchObservation) -> None:
        """Fold one served batch into the model for its key."""
        with self._lock:
            m = self._models.setdefault(obs.key, _KeyModel())
            if m.ewma is None:
                m.ewma = obs.latency_s
            else:
                m.ewma = self.decay * m.ewma + (1 - self.decay) \
                    * obs.latency_s
            m.n += 1
            m.window.append(obs.latency_s)
            bisect.insort(m.sorted_window, obs.latency_s)
            while len(m.window) > self.window:
                evicted = m.window.pop(0)
                del m.sorted_window[bisect.bisect_left(m.sorted_window,
                                                       evicted)]
            self.total_observations += 1

    # ----------------------------------------------------------- querying
    @staticmethod
    def key_for(arch: str, op: str, steps: int, bucket: int,
                mode: str = "drift", taylorseer: bool = False,
                rollback_interval: int = DEFAULT_INTERVAL,
                precision: str = "int8") -> LatencyKey:
        """The full latency key; the trailing discriminators default to
        ``GenerationRequest``'s defaults so plain (arch, op, steps,
        bucket) queries mean the standard drift configuration."""
        return (arch, op, steps, bucket, mode, taylorseer,
                rollback_interval, precision)

    def n_observations(self, arch: str, op: str, steps: int, bucket: int,
                       **disc) -> int:
        m = self._models.get(self.key_for(arch, op, steps, bucket, **disc))
        return m.n if m else 0

    def estimate_s(self, arch: str, op: str, steps: int, bucket: int,
                   **disc) -> Optional[float]:
        """Learned batch latency, or None when history is too thin (the
        scheduler's perfmodel fallback trigger). O(1) on the admission
        hot path: the window is kept sorted as it is fed."""
        with self._lock:
            m = self._models.get(self.key_for(arch, op, steps, bucket,
                                              **disc))
            if m is None or m.n < self.min_observations or m.ewma is None:
                return None
            return max(m.ewma,
                       nearest_rank(m.sorted_window,
                                    self.conservative_percentile))

    def percentile_s(self, arch: str, op: str, steps: int, bucket: int,
                     q: float, **disc) -> Optional[float]:
        """Exact percentile over the bounded observation window."""
        with self._lock:
            m = self._models.get(self.key_for(arch, op, steps, bucket,
                                              **disc))
            if m is None or not m.sorted_window:
                return None
            return nearest_rank(m.sorted_window, q)

    def keys(self) -> List[LatencyKey]:
        with self._lock:
            return sorted(self._models)

    def __len__(self) -> int:
        return len(self._models)
