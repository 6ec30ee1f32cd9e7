"""SLO engine: burn-rate objectives evaluated on the engine's virtual clock.

Counterpart of ``repro.serving.telemetry.slo``, unchanged but for its
imports.

The serving stack's deadline misses, detection rates, billed energy, and
queue waits were observable one metric at a time but never judged against
*objectives*. This module closes that gap with SRE-style multiwindow
burn-rate alerting, with one deliberate twist: every window is measured
on the engine's **virtual clock** (``engine.clock_s``, modeled-accelerator
seconds), not wall time -- the host runs smoke models on CPU, so wall
windows would make SLO state a function of the machine the test ran on.
On the virtual clock the whole evaluation is deterministic: the same
request stream produces the same burn rates, breaches included
(tests/test_torch_telemetry.py holds it equal to the reference's).

Objectives (``OBJECTIVES``), each with a target from :class:`SLOConfig`:

``deadline_miss_rate``
    fraction of requests completed past their deadline in the window;
    requests without a deadline don't count against the budget.
``ber_detection_rate``
    window mean of the BER monitor's post-batch estimate over monitored
    batches, normalized by the engine's target BER.
``energy_per_request_j``
    window mean of per-request billed energy (the ledger total).
``queue_wait_p99_s``
    nearest-rank p99 of per-request virtual-clock queue waits.

Burn rate = observed / target, per window. Two windows run per objective
-- ``fast`` (recent spike detector) and ``slow`` (sustained burn) -- and
an objective is **breached** only when BOTH exceed
``SLOConfig.breach_threshold``, the standard multiwindow guard against
paging on a single bad batch. Breach state is edge-counted into
``drift_slo_breaches_total`` and the energy objective's breach feeds the
GuardbandController (``set_energy_slo_breach``): while the energy SLO
burns, ``op="auto"`` is pinned to the guardband floor -- the cheapest
operating point reliability currently allows.

Surfaces: ``GET /slo`` (wire format in docs/slo.md) and the
``drift_slo_burn_rate{objective,window}`` gauges.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.serving.telemetry.metrics import nearest_rank

OBJECTIVES = ("deadline_miss_rate", "ber_detection_rate",
              "energy_per_request_j", "queue_wait_p99_s")
WINDOWS = ("fast", "slow")

# Bound on retained events; windows are virtual-time bounded anyway, this
# is the memory backstop for degenerate clocks (e.g. zero-latency stubs).
_MAX_EVENTS = 4096


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Objective targets + burn-rate window geometry (virtual seconds)."""
    # Fraction of deadline-carrying requests allowed to miss.
    deadline_miss_rate: float = 0.01
    # BER target as a multiple of the engine's monitor target (1.0 = the
    # monitor target itself is the objective).
    ber_target_ratio: float = 1.0
    # Mean billed joules per request the fleet budgets for. The default
    # comfortably covers a full 50-step DiT-XL-512 baseline sample
    # (~6 J, Table 1); deployments size it to their power envelope.
    energy_per_request_j: float = 8.0
    # p99 virtual-clock queue wait budget.
    queue_wait_p99_s: float = 1.0
    # Burn-rate windows on the virtual clock. Fast catches spikes, slow
    # confirms they are sustained; both must burn to breach.
    fast_window_s: float = 5.0
    slow_window_s: float = 60.0
    # Burn rate both windows must exceed for a breach.
    breach_threshold: float = 1.0


@dataclasses.dataclass(frozen=True)
class _RequestEvent:
    clock_s: float
    has_deadline: bool
    missed: bool
    energy_j: float
    queue_wait_s: float


class SLOTracker:
    """Rolling virtual-clock SLO evaluation for one engine.

    The engine's telemetry calls :meth:`observe_batch` once per served
    batch (deterministic order -- the engine is single-threaded); every
    read (:meth:`burn_rates`, :meth:`snapshot`, :attr:`breached`) is pure
    over the retained events, so HTTP reads racing a drain see a
    consistent last-batch state.
    """

    def __init__(self, target_ber: float,
                 config: Optional[SLOConfig] = None) -> None:
        assert target_ber > 0, target_ber
        self.cfg = config or SLOConfig()
        self.target_ber = float(target_ber)
        self.now_s = 0.0
        self.batches = 0
        self._requests: Deque[_RequestEvent] = collections.deque(
            maxlen=_MAX_EVENTS)
        self._ber: Deque[Tuple[float, float]] = collections.deque(
            maxlen=_MAX_EVENTS)           # (clock_s, ema_ber), monitored
        self.breached: Dict[str, bool] = {obj: False for obj in OBJECTIVES}

    # ------------------------------------------------------------- targets
    def target(self, objective: str) -> float:
        cfg = self.cfg
        if objective == "deadline_miss_rate":
            return cfg.deadline_miss_rate
        if objective == "ber_detection_rate":
            return cfg.ber_target_ratio * self.target_ber
        if objective == "energy_per_request_j":
            return cfg.energy_per_request_j
        if objective == "queue_wait_p99_s":
            return cfg.queue_wait_p99_s
        raise KeyError(f"unknown SLO objective {objective!r}; "
                       f"one of {OBJECTIVES}")

    # ------------------------------------------------------------- observe
    def observe_batch(self, clock_s: float, ema_ber: float,
                      monitored: bool, results) -> None:
        """Fold one served batch in and re-evaluate breach state."""
        self.now_s = float(clock_s)
        self.batches += 1
        if monitored:
            self._ber.append((self.now_s, float(ema_ber)))
        for res in results:
            self._requests.append(_RequestEvent(
                clock_s=self.now_s,
                has_deadline=res.deadline_s is not None,
                missed=bool(res.deadline_missed),
                energy_j=float(res.energy_j),
                queue_wait_s=float(res.queue_wait_s)))
        self._evict()
        thr = self.cfg.breach_threshold
        burns = self.burn_rates()
        self.breached = {
            obj: (burns[(obj, "fast")] > thr and burns[(obj, "slow")] > thr)
            for obj in OBJECTIVES}

    def _evict(self) -> None:
        horizon = self.now_s - max(self.cfg.fast_window_s,
                                   self.cfg.slow_window_s)
        while self._requests and self._requests[0].clock_s < horizon:
            self._requests.popleft()
        while self._ber and self._ber[0][0] < horizon:
            self._ber.popleft()

    # -------------------------------------------------------------- values
    def _window_requests(self, window_s: float) -> List[_RequestEvent]:
        cut = self.now_s - window_s
        return [e for e in self._requests if e.clock_s >= cut]

    def value(self, objective: str, window_s: float) -> float:
        """Observed value of one objective over one trailing window."""
        if objective == "ber_detection_rate":
            cut = self.now_s - window_s
            bers = [b for t, b in self._ber if t >= cut]
            return sum(bers) / len(bers) if bers else 0.0
        events = self._window_requests(window_s)
        if objective == "deadline_miss_rate":
            carrying = [e for e in events if e.has_deadline]
            if not carrying:
                return 0.0
            return sum(e.missed for e in carrying) / len(carrying)
        if objective == "energy_per_request_j":
            if not events:
                return 0.0
            return sum(e.energy_j for e in events) / len(events)
        if objective == "queue_wait_p99_s":
            if not events:
                return 0.0
            return nearest_rank(sorted(e.queue_wait_s for e in events), 99)
        raise KeyError(f"unknown SLO objective {objective!r}")

    def burn_rates(self) -> Dict[Tuple[str, str], float]:
        """``{(objective, window): observed / target}`` for every pair."""
        out: Dict[Tuple[str, str], float] = {}
        for obj in OBJECTIVES:
            target = self.target(obj)
            for win, span in (("fast", self.cfg.fast_window_s),
                              ("slow", self.cfg.slow_window_s)):
                v = self.value(obj, span)
                out[(obj, win)] = v / target if target > 0 else 0.0
        return out

    # ------------------------------------------------------------ breaches
    @property
    def energy_breached(self) -> bool:
        return self.breached["energy_per_request_j"]

    @property
    def any_breached(self) -> bool:
        return any(self.breached.values())

    def breached_objectives(self) -> Tuple[str, ...]:
        return tuple(obj for obj in OBJECTIVES if self.breached[obj])

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict[str, object]:
        """The ``GET /slo`` body: per-objective targets, windowed values,
        burn rates, and breach state, plus the window geometry -- all
        deterministic functions of the virtual clock."""
        burns = self.burn_rates()
        objectives = {}
        for obj in OBJECTIVES:
            objectives[obj] = {
                "target": self.target(obj),
                "value_fast": self.value(obj, self.cfg.fast_window_s),
                "value_slow": self.value(obj, self.cfg.slow_window_s),
                "burn_fast": burns[(obj, "fast")],
                "burn_slow": burns[(obj, "slow")],
                "breached": self.breached[obj],
            }
        return {
            "clock_s": self.now_s,
            "batches": self.batches,
            "windows": {"fast_s": self.cfg.fast_window_s,
                        "slow_s": self.cfg.slow_window_s},
            "breach_threshold": self.cfg.breach_threshold,
            "objectives": objectives,
        }
