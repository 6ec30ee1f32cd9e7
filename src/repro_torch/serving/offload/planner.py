"""Offload-interval optimizer (counterpart of
``repro.serving.offload.planner``, every expression copied so each number
equals the reference's with ``==``): pick ``RollbackConfig.interval`` per
operating point instead of hard-coding the paper's default.

The refresh interval trades three modeled costs against each other
(Sec 5.4 / Fig 10b; the DiffPro argument that protection budgets should
be chosen per operating point from measured sensitivity):

* **refresh energy** -- every refresh writes the whole checkpoint store
  to DRAM: ``ceil(steps / interval) * activation_bytes * e_dram`` (plus
  the row-activation surcharge of the layout in use). Shrinks as the
  interval grows.
* **refresh stall** -- an offload that outlasts the window it overlaps
  leaves residual stall ``max(0, t_refresh - t_window)`` per refresh
  (``t_window = interval`` denoising steps of compute at the operating
  point's frequency). The serialized baseline pays ``t_refresh`` in
  full. Stall is priced into Joules at the die's static (leakage)
  power so the objective is a single scalar.
* **staleness penalty** -- a rollback correction reads the last
  committed snapshot, on average ``(interval - 1) / 2`` steps old; the
  cross-step similarity that makes rollback work (Fig 2b) decays with
  that distance, so each expected detection is charged a
  staleness-proportional fraction of a recompute-equivalent step. Grows
  with the interval, scaled by the *measured* detection rate: the
  monitor target (the port has no telemetry yet, so the engine takes the
  reference's telemetry-disabled branch).

``plan()`` minimizes the sum; since the total is a positively-weighted
sum of (energy, stall), its argmin is always on the (energy, stall)
Pareto frontier. The engine memoizes resolutions per
(arch, op, steps, bucket, quantized detection rate), so
``rollback_interval="auto"`` requests resolve through one point
(``DriftServeEngine.auto_rollback_interval``), the same single-resolution
shape as ``engine.auto_op_index()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core import dvfs as dvfs_lib
from repro_torch.perfmodel import dram as dram_lib
from repro_torch.perfmodel import energy as energy_lib

# DRAM row-cycle time used for refresh/restore timing (matches
# perfmodel.dram.recovery_report's tRC), and the bank-level parallelism a
# streaming refresh write pipelines row activations across (HBM2
# pseudo-channels x banks; sequential writes hit banks round-robin, so
# only 1/DRAM_BANKS of the row cycles land on the critical path --
# without this the model contradicts Sec 6.4's "fully overlapped" shape).
T_RC_NS = 45.0
DRAM_BANKS = 16

# Most intervals ever considered; steps beyond this share the last point.
MAX_CANDIDATES = 64


@dataclasses.dataclass(frozen=True)
class IntervalPlan:
    """Modeled per-run cost of one candidate refresh interval."""
    interval: int
    n_refreshes: int
    refresh_s: float                 # one refresh's host-offload time
    stall_serialized_s: float        # per-run stall, refresh blocks scan
    stall_s: float                   # per-run residual stall, overlapped
    refresh_energy_j: float
    rollback_penalty_j: float
    total_j: float                   # energy + penalty + stall @ P_static

    @property
    def energy_j(self) -> float:
        """The energy axis of the (energy, stall) Pareto trade."""
        return self.refresh_energy_j + self.rollback_penalty_j


def pareto_frontier(plans: Sequence[IntervalPlan]) -> List[IntervalPlan]:
    """Non-dominated subset over (energy_j, stall_s), ties kept."""
    out = []
    for p in plans:
        dominated = any(
            (q.energy_j <= p.energy_j and q.stall_s <= p.stall_s)
            and (q.energy_j < p.energy_j or q.stall_s < p.stall_s)
            for q in plans)
        if not dominated:
            out.append(p)
    return out


class OffloadPlanner:
    """Per-(arch config, op, steps, bucket) refresh-interval optimizer."""

    def __init__(self, em: Optional[energy_lib.EnergyModel] = None,
                 nominal_steps: int = 2, repacked: bool = True,
                 overlapped: bool = True,
                 tile_m: int = 32, tile_n: int = 32) -> None:
        self.em = em if em is not None else energy_lib.calibrate()
        self.nominal_steps = nominal_steps
        self.repacked = repacked
        self.overlapped = overlapped
        self.tile_m, self.tile_n = tile_m, tile_n
        self._sweep_cache: Dict[tuple, List[IntervalPlan]] = {}

    # ------------------------------------------------------------- pieces
    def refresh_bytes(self, cfg, bucket: int) -> float:
        """One refresh's offload volume: the checkpointable GEMM-output
        store (same quantity the perfmodel charges as ckpt traffic)."""
        return energy_lib.activation_bytes(cfg, bucket)

    def refresh_time_s(self, cfg, bucket: int) -> float:
        """Streaming write of one snapshot: bytes / HBM BW + row cycles.

        A refresh streams the whole store sequentially, so its row count
        is layout-independent (``ceil(bytes / row_bytes)``); the layout
        only bites on partial-tile *recovery* reads (see
        :meth:`recovery_read_j`).
        """
        nbytes = self.refresh_bytes(cfg, bucket)
        hw = self.em.hw
        rows = math.ceil(nbytes / hw.dram_row_bytes)
        return (nbytes / (hw.hbm_gbps * 1e9)
                + rows * T_RC_NS * 1e-9 / DRAM_BANKS)

    def recovery_read_j(self, cfg) -> float:
        """DRAM energy of one tile recovery read from the offloaded
        store: tile bytes + the row-activation overhead of the layout in
        use (``perfmodel.dram`` row counts -- repacked tiles touch
        ``ceil(tile_bytes / row_bytes)`` rows, row-major ones a row per
        matrix row; same 64-byte-per-row surcharge convention as
        ``energy.run_cost``)."""
        hw = self.em.hw
        n_cols = getattr(cfg, "d_model", 1024)
        if self.repacked:
            rows = dram_lib.rows_per_tile_repacked(
                self.tile_m, self.tile_n, 4, hw.dram_row_bytes)
        else:
            rows = dram_lib.rows_per_tile_rowmajor(
                self.tile_m, self.tile_n, n_cols, 4, hw.dram_row_bytes)
        nbytes = self.tile_m * self.tile_n * 4 + rows * 64
        return nbytes * self.em.e_dram_pj_per_byte * 1e-12

    def step_latency_s(self, cfg, op: dvfs_lib.OperatingPoint,
                       bucket: int) -> float:
        """One aggressive-phase denoising step at this operating point
        (the compute a refresh overlaps with)."""
        rc = energy_lib.RunConfig(num_steps=1, nominal_steps=0,
                                  aggressive=op)
        return energy_lib.run_cost(cfg, rc, batch=bucket,
                                   em=self.em)["latency_s"]

    def step_energy_j(self, cfg, op: dvfs_lib.OperatingPoint,
                      bucket: int) -> float:
        rc = energy_lib.RunConfig(num_steps=1, nominal_steps=0,
                                  aggressive=op)
        return energy_lib.run_cost(cfg, rc, batch=bucket,
                                   em=self.em)["e_die"]

    # --------------------------------------------------------------- plan
    def _per_run_terms(self, cfg, op: dvfs_lib.OperatingPoint,
                       bucket: int) -> tuple:
        """The interval-INDEPENDENT cost pieces, computed once per sweep:
        (refresh time, refresh bytes, step latency, step die energy,
        recovery read energy)."""
        return (self.refresh_time_s(cfg, bucket),
                self.refresh_bytes(cfg, bucket),
                self.step_latency_s(cfg, op, bucket),
                self.step_energy_j(cfg, op, bucket),
                self.recovery_read_j(cfg))

    def _evaluate_terms(self, terms, steps: int, interval: int,
                        detect_rate: float) -> IntervalPlan:
        assert interval >= 1, interval
        t_refresh, nbytes, t_step, e_step, e_recovery = terms
        n_refreshes = math.ceil(steps / interval)
        t_window = t_step * interval
        serialized = n_refreshes * t_refresh
        overlapped = n_refreshes * max(0.0, t_refresh - t_window)
        stall = overlapped if self.overlapped else serialized
        refresh_j = n_refreshes * nbytes * self.em.e_dram_pj_per_byte * 1e-12
        staleness = (interval - 1) / 2.0
        detections = min(1.0, detect_rate) * steps
        penalty_j = detections * ((staleness / max(steps, 1)) * e_step
                                  + e_recovery)
        total = refresh_j + penalty_j + stall * self.em.static_w
        return IntervalPlan(interval=interval, n_refreshes=n_refreshes,
                            refresh_s=t_refresh,
                            stall_serialized_s=serialized,
                            stall_s=overlapped,
                            refresh_energy_j=refresh_j,
                            rollback_penalty_j=penalty_j,
                            total_j=total)

    def evaluate(self, cfg, op: dvfs_lib.OperatingPoint, steps: int,
                 bucket: int, interval: int,
                 detect_rate: float) -> IntervalPlan:
        """Modeled cost of one (interval) choice for one run."""
        return self._evaluate_terms(self._per_run_terms(cfg, op, bucket),
                                    steps, interval, detect_rate)

    def sweep(self, cfg, op: dvfs_lib.OperatingPoint, steps: int,
              bucket: int, detect_rate: float,
              candidates: Optional[Sequence[int]] = None
              ) -> List[IntervalPlan]:
        """Cost of every candidate interval. The interval-independent
        perfmodel terms are computed once per sweep (not per candidate),
        and the whole sweep is memoized per query key -- ModelConfig is a
        frozen (hashable) dataclass, so the key carries the config by
        value, never by object identity."""
        if candidates is None:
            candidates = range(1, min(max(steps, 1), MAX_CANDIDATES) + 1)
        key = (cfg, op.name, steps, bucket, f"{detect_rate:.2e}",
               tuple(candidates))
        cached = self._sweep_cache.get(key)
        if cached is None:
            terms = self._per_run_terms(cfg, op, bucket)
            cached = [self._evaluate_terms(terms, steps, n, detect_rate)
                      for n in candidates]
            self._sweep_cache[key] = cached
        return cached

    def plan(self, cfg, op: dvfs_lib.OperatingPoint, steps: int,
             bucket: int, detect_rate: float,
             candidates: Optional[Sequence[int]] = None) -> IntervalPlan:
        """The chosen interval: argmin of the summed objective (ties ->
        the larger interval, i.e. less refresh traffic)."""
        plans = self.sweep(cfg, op, steps, bucket, detect_rate, candidates)
        return min(plans, key=lambda p: (p.total_j, -p.interval))

    def residual_stall_s(self, cfg, op: dvfs_lib.OperatingPoint,
                         steps: int, bucket: int, interval: int) -> float:
        """Per-run stall the engine's virtual clock charges for an
        offload-enabled batch."""
        plan = self.evaluate(cfg, op, steps, bucket, interval,
                             detect_rate=0.0)
        return plan.stall_s if self.overlapped else plan.stall_serialized_s
