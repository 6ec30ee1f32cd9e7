"""Serving-layer energy ledger: per-(component, op) joule accounting.

Counterpart of ``repro.serving.telemetry.energy``, over the port's
``perfmodel.energy.ENERGY_COMPONENTS`` and ``ledger_total``. The engine
runs ``verify_cost`` on the ledger every batch's results share.

``perfmodel.energy.run_cost`` prices every served batch and now returns a
per-component breakdown (``perfmodel.energy.ENERGY_COMPONENTS``) whose
fixed-order sum IS the billed total -- see ``ledger_total``. This module
is the serving-side accumulator over those breakdowns: the engine's
telemetry charges one batch-level breakdown per served batch (labelled by
the operating point that ran) plus one per-request energy observation per
result, and the ledger answers the aggregate questions the SLO engine,
the ``/metrics`` counters, and ``benchmarks/energy_slo.py`` ask --
where do the joules go, per DVFS operating point, and what does a request
cost on average.

The ledger never re-derives totals from its own accumulation order: the
exact-sum guarantee lives in ``perfmodel.energy`` (components are the
primary arithmetic there), and ``verify_cost`` re-checks it on any priced
cost dict, bitwise.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.perfmodel.energy import ENERGY_COMPONENTS, ledger_total

__all__ = ["ENERGY_COMPONENTS", "EnergyLedger", "ledger_total",
           "verify_cost"]


def verify_cost(cost: Dict[str, object]) -> float:
    """Exact-sum check on one priced cost dict (``run_cost`` or
    ``per_request_cost`` output): returns the absolute residual between
    the component sum and the billed ``energy_j`` -- 0.0, bitwise, by
    construction. Raises ``AssertionError`` on any residual; callers that
    want the number (the energy benchmark reports it) read the return."""
    residual = abs(ledger_total(cost["breakdown"]) - cost["energy_j"])
    assert residual == 0.0, (
        f"energy ledger does not reconcile: component sum differs from "
        f"energy_j by {residual!r}")
    return residual


class EnergyLedger:
    """Cumulative joules per (component, operating point) + request stats.

    Bounded by construction: the key space is |ENERGY_COMPONENTS| x the
    operating points that actually served batches, and the per-request
    side keeps two scalars. Mutated on the engine's serving thread only
    (the metrics registry's counters are the thread-safe read surface);
    reads from benchmarks/CLIs happen after a drain.
    """

    def __init__(self) -> None:
        self.joules: Dict[Tuple[str, str], float] = {}
        self.batches = 0
        self.requests = 0
        self.request_joules = 0.0

    # ------------------------------------------------------------ charging
    def charge_batch(self, op: str, breakdown: Dict[str, float]) -> None:
        """Fold one served batch's component breakdown in, attributed to
        the operating point that ran it."""
        self.batches += 1
        for comp in ENERGY_COMPONENTS:
            j = breakdown[comp]
            if j:
                key = (comp, op)
                self.joules[key] = self.joules.get(key, 0.0) + j

    def charge_request(self, energy_j: float) -> None:
        self.requests += 1
        self.request_joules += float(energy_j)

    # ------------------------------------------------------------- queries
    def component_totals(self, op: Optional[str] = None) -> Dict[str, float]:
        """Cumulative joules per component, optionally for one op."""
        out = {comp: 0.0 for comp in ENERGY_COMPONENTS}
        for (comp, o), j in self.joules.items():
            if op is None or o == op:
                out[comp] += j
        return out

    def shares(self, op: Optional[str] = None) -> Dict[str, float]:
        """Each component's fraction of the cumulative total (0.0 when
        nothing has been charged)."""
        totals = self.component_totals(op)
        denom = sum(totals.values())
        if denom <= 0.0:
            return {comp: 0.0 for comp in ENERGY_COMPONENTS}
        return {comp: j / denom for comp, j in totals.items()}

    def ops(self) -> Tuple[str, ...]:
        """Operating points that have been charged, sorted."""
        return tuple(sorted({op for _, op in self.joules}))

    def energy_per_request_j(self) -> float:
        """Mean billed energy per completed request (0.0 before any)."""
        return self.request_joules / self.requests if self.requests else 0.0
