"""Compute-optimal request policy: the joint (steps, precision,
TaylorSeer, DVFS) Pareto frontier the scheduler picks from.

Counterpart of ``repro.serving.frontier``, priced by the port's perfmodel
(equal to the reference's with ``==``), so its points, their order and
``python -m repro_torch.serving.frontier``'s output are the reference's.

DRIFT's Sec 6 design-space exploration treats steps, precision, and the
DVFS operating point as ONE co-design space, but the escalation ladder only
trades steps vs overclock. Following DiffPro (joint timestep + precision
optimization) and the compute-optimal-deployment argument of "Fewer
Denoising Steps or Cheaper Per-Step Inference", this module precomputes,
per (arch, bucket, requested-steps) configuration, the Pareto frontier of

    knob point  =  (DVFS op, step count, precision plan, TaylorSeer)
    cost vector =  (quality proxy MAX, energy_j MIN, latency_s MIN)

and the ``DeadlineScheduler`` consults it whenever a request states a
frontier objective (``energy_budget_j`` / ``quality_floor``): minimum
energy meeting the deadline, or minimum latency meeting the quality
floor, or maximum quality inside the budget.

Pricing is the SAME perfmodel the engine bills results with
(``perfmodel.energy.run_cost`` -- V^2 energy scaling, frequency latency
scaling, TaylorSeer skip schedule, the ``body_bits`` precision branches),
so a frontier projection equals the engine's virtual-clock charge for
that configuration. Energy is quoted per request slot assuming a full
bucket; latency is the shared full-bucket batch latency. The residual
checkpoint-offload stall is deliberately NOT in the point (it depends on
the engine's offload store); the scheduler adds
``engine.offload_stall_s`` on top when filtering against a deadline.

The quality proxy is derived from the resilience metrics the repo
already ranks configurations by -- it is an *ordering* device for the
frontier, not a calibrated LPIPS predictor:

* ``(steps / requested) ** 0.35`` -- diminishing returns of DDIM steps
  (DiffPro's observation: quality collapses only under a handful);
* ``1 - 2.0 * excess_noise * body_frac`` -- precision term: the narrowed
  plan's quantization step in excess of the INT8 baseline
  (``core.quant.quant_noise``), weighted by the resilient-body MAC share
  (the sensitive sites never narrow, mirroring ``core.policies``'
  CLASS_EMBED/CLASS_FIRST_BLOCK protection). Exactly 1.0 for "int8".
* ``1 - 0.15 * skipped_frac`` -- TaylorSeer term: forecast steps reuse
  stale features; the skipped fraction uses the exact compute schedule
  ``run_cost`` prices (interval 3, first ``nominal_steps`` protected);
* ``1 - 0.05 * min(1, ber_of(op) / 3e-3)`` -- DVFS term: residual error
  exposure at the point's BER relative to the monitor target; ~1.0 at
  nominal, 0.95 at the deep-undervolt/overclock corners.

All four factors live in (0, 1] and are monotone the way the invariant
tests demand: fewer steps or fewer bits never raise quality at a fixed
op. The product form keeps the proxy free of cross terms, so dominance
pruning (``pareto_front``, the ``serving/offload/planner.py`` helper
pattern lifted to three objectives) is exact.

Frontiers are memoized per (arch, bucket, requested steps, mode,
rollback interval) exactly like ``engine.auto_rollback_interval`` -- the
sweep is pure arithmetic (~2k points) and runs nothing on the card.

Worked example + the scheduler's selection rules: docs/frontier.md.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core import dvfs as dvfs_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core.rollback import DEFAULT_INTERVAL
from repro_torch.perfmodel import energy as energy_lib

# Modes that pay ABFT + checkpoint overheads (mirrors engine's table;
# duplicated here to keep this module importable without the engine).
_PROTECTED_MODES = ("drift", "thundervolt", "approx_abft", "dmr",
                    "stat_abft")

#: The DVFS knob: every monitor-ladder point plus the speed-mode
#: overclock corner (the escalation target the scheduler's ladder uses).
FRONTIER_OPS: Tuple[dvfs_lib.OperatingPoint, ...] = \
    dvfs_lib.OP_LADDER + (dvfs_lib.OVERCLOCK,)

#: TaylorSeer compute interval the pricing (and the servable's RunConfig)
#: assumes -- keep in sync with DiffusionServable.finalize.
TAYLORSEER_INTERVAL = 3

# Quality-proxy coefficients (see module docstring for the derivation).
_STEP_EXPONENT = 0.35
_PREC_WEIGHT = 2.0
_TS_WEIGHT = 0.15
_OP_WEIGHT = 0.05
_OP_BER_SCALE = 3e-3          # the monitor target the ladder regulates to
#: Resilient-body share of per-step MACs (1 - embedding share); constant
#: so the precision term cannot break monotonicity in the step count.
_BODY_FRAC = 1.0 - 0.02


@dataclasses.dataclass(frozen=True)
class FrontierPoint:
    """One knob assignment with its priced cost vector."""
    op: str                    # operating-point name (FRONTIER_OPS)
    steps: int                 # DDIM step count
    precision: str             # core.quant.PRECISION_PLANS name
    taylorseer: bool
    quality: float             # proxy in (0, 1], maximize
    energy_j: float            # per request slot at a full bucket, minimize
    latency_s: float           # full-bucket batch latency, minimize

    def knobs(self) -> Tuple[str, int, str, bool]:
        return (self.op, self.steps, self.precision, self.taylorseer)


def sort_key(p: FrontierPoint) -> Tuple:
    """Deterministic total order: best quality first, then cheapest, then
    the knob tuple -- the scheduler's final tie-break, so equal-cost picks
    never depend on enumeration order."""
    return (-p.quality, p.energy_j, p.latency_s, p.op, -p.steps,
            p.precision, p.taylorseer)


def dominates(a: FrontierPoint, b: FrontierPoint) -> bool:
    """True iff ``a`` is at least as good as ``b`` on every objective and
    strictly better on at least one (quality max; energy/latency min)."""
    ge = (a.quality >= b.quality and a.energy_j <= b.energy_j
          and a.latency_s <= b.latency_s)
    gt = (a.quality > b.quality or a.energy_j < b.energy_j
          or a.latency_s < b.latency_s)
    return ge and gt


def pareto_front(points: Sequence[FrontierPoint]) -> List[FrontierPoint]:
    """Non-dominated subset over (quality, energy_j, latency_s), ties
    kept -- ``serving/offload/planner.pareto_frontier`` lifted to three
    objectives. Returned in :func:`sort_key` order (deterministic)."""
    out = [p for p in points
           if not any(dominates(q, p) for q in points)]
    return sorted(out, key=sort_key)


def taylorseer_computed_steps(steps: int, nominal_steps: int) -> int:
    """Computed (non-forecast) steps under TaylorSeer -- the exact
    schedule ``energy.run_cost`` prices: every ``TAYLORSEER_INTERVAL``-th
    step plus the protected first ``nominal_steps``."""
    return sum(1 for s in range(steps)
               if s % TAYLORSEER_INTERVAL == 0 or s < nominal_steps)


def quality_proxy(steps: int, requested_steps: int,
                  plan: quant_lib.PrecisionPlan, taylorseer: bool,
                  op: dvfs_lib.OperatingPoint,
                  nominal_steps: int = 2) -> float:
    """Resilience-derived quality ordering for one knob point (see module
    docstring). 1.0 only for (requested steps, baseline precision,
    TaylorSeer off) at a BER-free operating point; monotone
    non-increasing as steps shrink or ``plan`` narrows at a fixed op."""
    assert 1 <= steps <= requested_steps, (steps, requested_steps)
    q_steps = (steps / requested_steps) ** _STEP_EXPONENT
    excess = quant_lib.quant_noise(plan.body_bits) \
        - quant_lib.quant_noise(quant_lib.BASE_BITS)
    q_prec = 1.0 - _PREC_WEIGHT * excess * _BODY_FRAC
    if taylorseer:
        skipped = 1.0 - taylorseer_computed_steps(steps, nominal_steps) \
            / steps
        q_ts = 1.0 - _TS_WEIGHT * skipped
    else:
        q_ts = 1.0
    q_op = 1.0 - _OP_WEIGHT * min(1.0, dvfs_lib.ber_of(op) / _OP_BER_SCALE)
    return q_steps * q_prec * q_ts * q_op


class FrontierBuilder:
    """Per-(arch config, bucket, requested steps) frontier enumerator.

    Mirrors ``OffloadPlanner``: constructed once with the engine's energy
    model and protection constants, consulted per configuration, memoized
    (``auto_rollback_interval`` style) because the sweep re-prices ~2k
    pure-arithmetic points.
    """

    def __init__(self, em: Optional[energy_lib.EnergyModel] = None,
                 nominal_steps: int = 2, min_steps: int = 4,
                 ops: Tuple[dvfs_lib.OperatingPoint, ...] = FRONTIER_OPS,
                 plans: Optional[Iterable[quant_lib.PrecisionPlan]] = None
                 ) -> None:
        self.em = em if em is not None else energy_lib.calibrate()
        self.nominal_steps = nominal_steps
        self.min_steps = min_steps
        self.ops = ops
        self.plans = tuple(plans) if plans is not None \
            else tuple(quant_lib.PRECISION_PLANS.values())
        self._memo: Dict[tuple, List[FrontierPoint]] = {}

    # ------------------------------------------------------------ pricing
    def price(self, cfg, op: dvfs_lib.OperatingPoint, steps: int,
              requested_steps: int, plan: quant_lib.PrecisionPlan,
              taylorseer: bool, bucket: int, mode: str = "drift",
              rollback_interval: int = DEFAULT_INTERVAL) -> FrontierPoint:
        """One knob point's cost vector, priced exactly as the engine
        bills it (same RunConfig shape ``DiffusionServable.finalize``
        builds, minus the realized rollback-recovery traffic, which is
        unknowable at admission time)."""
        protected = mode in _PROTECTED_MODES
        rc = energy_lib.RunConfig(
            num_steps=steps, nominal_steps=self.nominal_steps,
            aggressive=op,
            ckpt_interval=rollback_interval if protected else 10 ** 9,
            abft_enabled=protected,
            taylorseer_interval=TAYLORSEER_INTERVAL if taylorseer else 0,
            body_bits=plan.body_bits)
        cost = energy_lib.run_cost(cfg, rc, batch=bucket, em=self.em)
        return FrontierPoint(
            op=op.name, steps=steps, precision=plan.name,
            taylorseer=taylorseer,
            quality=quality_proxy(steps, requested_steps, plan, taylorseer,
                                  op, self.nominal_steps),
            energy_j=cost["energy_j"] / bucket,
            latency_s=cost["latency_s"])

    def enumerate(self, cfg, requested_steps: int, bucket: int,
                  mode: str = "drift",
                  rollback_interval: int = DEFAULT_INTERVAL
                  ) -> List[FrontierPoint]:
        """The FULL knob space, unpruned -- the brute-force ground truth
        the frontier tests compare the pruned set (and the scheduler's
        pick) against. Steps sweep from ``requested_steps`` down to
        ``min_steps`` (never above the request: the frontier degrades,
        it does not spend more than asked)."""
        floor = min(requested_steps, self.min_steps)
        points = []
        for op in self.ops:
            for steps in range(requested_steps, floor - 1, -1):
                for plan in self.plans:
                    for ts in (False, True):
                        points.append(self.price(
                            cfg, op, steps, requested_steps, plan, ts,
                            bucket, mode, rollback_interval))
        return points

    def frontier(self, cfg, requested_steps: int, bucket: int,
                 mode: str = "drift",
                 rollback_interval: int = DEFAULT_INTERVAL
                 ) -> List[FrontierPoint]:
        """Memoized Pareto set for one configuration, in :func:`sort_key`
        order. The memo key carries everything the pricing depends on."""
        key = (cfg.name, requested_steps, bucket, mode,
               int(rollback_interval))
        cached = self._memo.get(key)
        if cached is None:
            cached = self._memo[key] = pareto_front(self.enumerate(
                cfg, requested_steps, bucket, mode, rollback_interval))
        return cached


def _main() -> None:
    """Print one arch's frontier (the docs/frontier.md worked example)."""
    import argparse
    import json

    from repro_torch import configs

    ap = argparse.ArgumentParser(
        description="Enumerate the compute-optimal serving frontier for "
                    "one (arch, bucket, steps) configuration.")
    ap.add_argument("--arch", default="dit-xl-512")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--bucket", type=int, default=2)
    ap.add_argument("--mode", default="drift")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable JSON instead of a table")
    args = ap.parse_args()

    builder = FrontierBuilder()
    cfg = configs.get_config(args.arch)
    full = builder.enumerate(cfg, args.steps, args.bucket, args.mode)
    front = builder.frontier(cfg, args.steps, args.bucket, args.mode)
    if args.json:
        print(json.dumps({
            "arch": args.arch, "enumerated": len(full),
            "frontier": [dataclasses.asdict(p) for p in front]}))
        return
    print(f"# {args.arch} steps={args.steps} bucket={args.bucket} "
          f"mode={args.mode}: {len(front)} frontier points "
          f"of {len(full)} enumerated")
    print(f"{'op':>14} {'steps':>5} {'precision':>10} {'ts':>3} "
          f"{'quality':>8} {'energy_j':>9} {'latency_s':>9}")
    for p in front:
        print(f"{p.op:>14} {p.steps:>5} {p.precision:>10} "
              f"{'on' if p.taylorseer else 'off':>3} {p.quality:>8.4f} "
              f"{p.energy_j:>9.4f} {p.latency_s:>9.5f}")


if __name__ == "__main__":
    _main()
