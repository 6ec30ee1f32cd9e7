"""Deadline- and priority-aware scheduling on top of the DRIFT engine.

Counterpart of ``repro.serving.scheduler``: the same policy, projection
and formation, on the port's engine; the priority batcher keeps the
engine batcher's ``key_extra`` (a sharded engine's mesh placement).

The engine gives every request two orthogonal quality/cost levers:

* the **DVFS operating point** (DRIFT Sec 5.1/5.2): undervolt saves ~36%
  energy at equal speed, overclock runs ~1.75x faster at nominal-ish
  energy -- reliability is bought back by ABFT + rollback either way;
* the **denoising step budget** (DiffPro-style): fewer DDIM steps cost
  proportionally less latency and energy at some quality loss.

``DeadlineScheduler`` navigates both jointly, per request, against an
admission-control projection of the queue:

1.  **Projection.** A request's completion time is estimated on the
    engine's virtual clock as ``clock + backlog + own batch latency``.
    Batch latencies come from the engine telemetry's **learned
    estimator** (EWMA + conservative percentile over served-batch
    history, per (arch, op, steps, bucket) plus mode/taylorseer/
    rollback-interval discriminators -- ``serving/telemetry``)
    when that configuration has history, and otherwise fall back to the
    same perfmodel the engine bills with
    (``perfmodel.energy.run_cost``) -- with no history the two paths
    are bit-identical, so a fresh scheduler behaves exactly like the
    pre-telemetry one. The backlog counts only pending requests that
    will be served *before* the newcomer under priority order.
2.  **Policy.** Given the time left after the backlog, pick (op, steps):
    keep the request as submitted if it fits; otherwise escalate the
    operating point to ``overclock`` (speed mode); otherwise trim steps at
    overclock down to ``SchedulerConfig.min_steps``; otherwise the request
    is hopeless -- reject it (default) or admit it flagged as a projected
    miss. Requests without a deadline are never touched: background work
    keeps its energy-saving ladder (``op="auto"`` stays auto).
3.  **Formation.** ``PriorityMicroBatcher`` seeds each bucket from the
    most urgent pending request -- (priority rank, absolute deadline,
    FIFO) -- instead of the queue head, with an aging escape hatch: any
    request that has waited longer than ``age_s`` virtual seconds is
    promoted to top rank, so a steady interactive stream cannot starve
    background work forever.

The scheduler *rewrites* the admitted request's ``op``/``steps`` fields,
so its assignment flows into ``SamplerKey`` bucketing and the perfmodel
accounting with no engine changes; ``priority``/``deadline_s`` ride along
for formation order and miss bookkeeping. Everything is deterministic:
time is the engine's virtual clock (modeled-accelerator seconds), never
host wall-clock.

Worked example and the full policy table: ``docs/scheduler.md``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core import dvfs as dvfs_lib
from repro_torch.core import rollback as rollback_lib
from repro_torch.perfmodel import energy
from repro_torch.serving import frontier as frontier_lib
from repro_torch.serving import servable as servable_lib
from repro_torch.serving.batcher import MicroBatch, MicroBatcher, request_key
from repro_torch.serving.engine import DriftServeEngine
from repro_torch.serving.request import (PRIORITY_RANK, GenerationRequest,
                                   RequestQueue)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Knobs for admission control and batch formation."""
    # Floor for deadline-driven step trimming: below this the sample is
    # assumed too degraded to be worth serving (DiffPro's observation that
    # quality collapses under a handful of steps).
    min_steps: int = 4
    # Reject requests whose deadline cannot be met even at (overclock,
    # min_steps); False admits them flagged as projected misses instead.
    reject_hopeless: bool = True
    # A pending request older than this (virtual seconds) is treated as
    # top priority by the batcher regardless of its class -- the
    # starvation guard. None disables aging.
    age_s: Optional[float] = 1.0
    # Consult the engine telemetry's learned latency estimator before the
    # perfmodel (False pins admission to the perfmodel clock even with
    # telemetry on; with empty history the two are bit-identical anyway).
    use_learned_latency: bool = True


@dataclasses.dataclass(frozen=True)
class Admission:
    """Outcome of one admission decision."""
    admitted: bool
    # Concrete assignment for admitted requests (echoes the request for
    # rejected ones, for the record).
    op: str
    steps: int
    # "as-requested" | "escalated-op" | "trimmed-steps" | "frontier"
    # | "projected-miss" | "rejected"
    action: str
    # Projected wait behind the existing queue and projected completion
    # latency (wait + own batch), both in engine virtual seconds. None
    # when the request has no deadline (no projection is computed).
    projected_wait_s: Optional[float] = None
    projected_total_s: Optional[float] = None
    request_id: int = -1           # -1 = rejected, never enqueued
    reason: str = ""
    # Frontier-chosen knobs beyond (op, steps); ladder decisions echo the
    # request's own fields so the submit rewrite is uniform.
    precision: str = "int8"
    taylorseer: bool = False
    # Frontier projections (None for ladder decisions): the picked
    # point's per-request energy share and quality proxy.
    projected_energy_j: Optional[float] = None
    quality: Optional[float] = None


@dataclasses.dataclass
class SchedulerStats:
    submitted: int = 0
    admitted: int = 0
    rejected: int = 0
    escalated_op: int = 0          # op bumped to overclock for a deadline
    trimmed_steps: int = 0         # step budget cut for a deadline
    frontier_selected: int = 0     # compute-optimal frontier picks
    projected_misses: int = 0      # admitted although projected to miss


class PriorityMicroBatcher(MicroBatcher):
    """MicroBatcher that seeds each bucket from the most urgent pending
    request instead of the FIFO head.

    Urgency is whatever ``urgency(req)`` sorts first -- the scheduler
    supplies (priority rank with aging, absolute deadline, request id).
    The seed's resolved ``SamplerKey`` is swept through the whole queue
    (``take_matching``) and the bucket is filled with the most urgent
    matches (scheduler fields are not part of the key, so an interactive
    and a background request share a configuration -- the urgency ranking,
    not FIFO, decides who rides the urgent bucket). Non-matching and
    unchosen requests keep their FIFO positions.
    """

    def __init__(self, bucket: int,
                 urgency: Optional[Callable[[GenerationRequest], Tuple]]
                 = None,
                 key_extra: Optional[Dict[str, object]] = None) -> None:
        super().__init__(bucket, key_extra=key_extra)
        self._urgency = urgency or (lambda r: r.request_id)

    def next_batch(self, queue: RequestQueue,
                   resolve_op: Callable[[GenerationRequest], str],
                   resolve_interval: Optional[
                       Callable[[GenerationRequest], int]] = None
                   ) -> MicroBatch:
        pending = queue.pending()
        if not pending:
            raise ValueError("next_batch on an empty queue")
        seed = min(pending, key=self._urgency)
        def key_of(r):
            return request_key(
                r, self.bucket, resolve_op(r), self.key_extra,
                resolve_interval(r) if resolve_interval is not None
                else None)
        key = key_of(seed)
        reqs = queue.take_matching(key, key_of, self.bucket,
                                   rank=self._urgency)
        return MicroBatch(key=key, requests=reqs)


class DeadlineScheduler:
    """Admission control + priority batch formation around one engine.

    Wraps an existing ``DriftServeEngine``:
    replaces its batcher with a ``PriorityMicroBatcher`` and funnels
    submissions through :meth:`submit`, which returns an :class:`Admission`
    record instead of a bare id. ``run()``/``run_stream()`` delegate to the
    engine unchanged -- results and previews come back exactly as without
    the scheduler, plus the deadline bookkeeping the engine already stamps.

    With no deadlines and uniform priorities the scheduler is behaviorally
    identical to the bare engine (the urgency sort degenerates to FIFO),
    so launchers can wrap unconditionally.
    """

    def __init__(self, engine: DriftServeEngine,
                 config: Optional[SchedulerConfig] = None) -> None:
        self.engine = engine
        self.cfg = config or SchedulerConfig()
        self.stats = SchedulerStats()
        engine.batcher = PriorityMicroBatcher(
            engine.batcher.bucket, urgency=self._urgency,
            key_extra=engine.batcher.key_extra)
        # Modeled-latency memo (run_cost is pure arithmetic but admission
        # sits on the submit path). Keyed on the *operating-point
        # parameters* -- (arch, voltage, frequency, steps, bucket,
        # nominal_steps) -- never on a request-facing name: "auto"
        # resolves through the monitor ladder and the guardband floor, so
        # a name-keyed memo would keep serving the latency of whatever
        # point "auto" meant at first call after the ladder adapts.
        # Learned estimates are never memoized here (history moves every
        # batch; the estimator lookup is O(1) anyway).
        self._latency_cache: Dict[
            Tuple[str, float, float, int, int, int], float] = {}
        # Compute-optimal frontier builder (serving/frontier.py), built
        # lazily against the engine's energy model so deadline-only
        # workloads never pay the calibration.
        self._frontier_builder: Optional[frontier_lib.FrontierBuilder] = \
            None
        # Decision-audit scratch: _plan_frontier stashes the candidate
        # set it considered here so submit() can attach it to the
        # request's "admission" span (docs/tracing.md). Reset per plan().
        self._frontier_audit: Optional[Dict[str, object]] = None

    # ------------------------------------------------------------- intake
    def submit(self, **fields) -> Admission:
        """Plan and (maybe) enqueue one request; returns the decision.

        ``fields`` are ``GenerationRequest`` fields as for
        ``engine.submit``. Admitted requests are enqueued with the planned
        ``(op, steps)`` rewritten in; rejected ones never touch the queue.
        """
        self.stats.submitted += 1
        eng = self.engine
        fields.setdefault("arch", eng.default_arch)
        fields.setdefault("smoke", eng.default_smoke)
        fields.setdefault("submitted_at_s", eng.clock_s)
        # Probe request: normalizes defaults + runs field validation once.
        try:
            probe = GenerationRequest(request_id=-1, **fields)
        except (TypeError, ValueError) as exc:
            eng.telemetry.on_rejection("validation")
            eng.tracer.record("admission", "admission",
                              t0_virtual_s=eng.clock_s, admitted=False,
                              action="rejected",
                              reason=f"validation: {exc}")
            raise
        adm = self.plan(probe)
        eng.telemetry.on_admission(adm.action)
        if not adm.admitted:
            self.stats.rejected += 1
            wants_frontier = (probe.energy_budget_j is not None
                              or probe.quality_floor is not None)
            eng.telemetry.on_rejection(
                "budget-infeasible" if wants_frontier else "projected-miss")
            self._record_decision(adm, request_id=-1)
            return adm
        self.stats.admitted += 1
        if adm.action == "escalated-op":
            self.stats.escalated_op += 1
        elif adm.action == "trimmed-steps":
            self.stats.trimmed_steps += 1
        elif adm.action == "frontier":
            self.stats.frontier_selected += 1
        elif adm.action == "projected-miss":
            self.stats.projected_misses += 1
        rewrite = {**fields, "op": adm.op, "steps": adm.steps}
        if adm.action == "frontier":
            # the frontier owns ALL four knobs; ladder decisions leave the
            # request's own precision/taylorseer untouched
            rewrite["precision"] = adm.precision
            rewrite["taylorseer"] = adm.taylorseer
        rid = eng.submit(**rewrite)
        adm = dataclasses.replace(adm, request_id=rid)
        self._record_decision(adm, request_id=rid)
        return adm

    def _record_decision(self, adm: Admission, request_id: int) -> None:
        """Decision audit (docs/tracing.md): one ``admission`` span per
        planned request in the engine's flight recorder, carrying the
        full :class:`Admission` record -- and, when a frontier objective
        was consulted, the candidate set ``_plan_frontier`` weighed --
        so every ``action="frontier"`` rewrite (and every fallback) is
        reconstructible from the trace alone."""
        eng = self.engine
        attrs: Dict[str, object] = dict(
            admitted=adm.admitted, action=adm.action, op=adm.op,
            steps=adm.steps, precision=adm.precision,
            taylorseer=adm.taylorseer)
        if adm.reason:
            attrs["reason"] = adm.reason
        if adm.projected_wait_s is not None:
            attrs["projected_wait_s"] = adm.projected_wait_s
            attrs["projected_total_s"] = adm.projected_total_s
        if adm.projected_energy_j is not None:
            attrs["projected_energy_j"] = adm.projected_energy_j
            attrs["quality"] = adm.quality
        # SLO context at decision time (docs/slo.md): which objectives
        # were burning when this admission was taken, so a post-hoc audit
        # can tell "admitted into a healthy fleet" from "admitted while
        # the energy budget was already breached".
        slo = getattr(eng.telemetry, "slo", None)
        if slo is not None and slo.any_breached:
            attrs["slo_breached"] = list(slo.breached_objectives())
        if self._frontier_audit is not None:
            if adm.action == "frontier":
                attrs.update(self._frontier_audit)
            else:
                # unsatisfiable objective that fell back to the ladder
                # (or to rejection): keep the evidence of what was
                # considered next to the fallback decision
                attrs["frontier_fallback"] = dict(self._frontier_audit)
        ids = () if request_id < 0 else (request_id,)
        eng.tracer.record("admission", "admission", request_ids=ids,
                          t0_virtual_s=eng.clock_s, **attrs)

    # ------------------------------------------------------------- policy
    def plan(self, req: GenerationRequest) -> Admission:
        """Joint (operating point, step count) assignment for one request.

        Requests stating a frontier objective (``energy_budget_j`` /
        ``quality_floor``) resolve against the compute-optimal
        (steps x precision x TaylorSeer x DVFS) Pareto frontier first --
        minimum energy meeting the deadline, minimum latency meeting the
        quality floor, or maximum quality inside the budget -- and fall
        back to the escalation ladder when no frontier point qualifies.

        The ladder, cheapest first (see docs/scheduler.md for the
        table): as-requested -> overclock at full steps -> overclock with
        trimmed steps -> reject / projected-miss.
        """
        cap = req.steps if req.step_budget is None \
            else min(req.steps, req.step_budget)
        self._frontier_audit = None
        wants_frontier = (req.energy_budget_j is not None
                          or req.quality_floor is not None)
        if req.deadline_s is None:
            if wants_frontier:
                adm = self._plan_frontier(req, cap, wait=None, budget=None)
                if adm is not None:
                    return adm
            # No deadline: never touch the energy-saving assignment.
            # (Unsatisfiable floor/budget falls through here too --
            # best-effort as-requested, documented in docs/frontier.md.)
            return Admission(admitted=True, op=req.op, steps=cap,
                             action="as-requested")
        wait = self.projected_wait_s(req)
        budget = req.deadline_s - wait     # time left for the own batch
        if wants_frontier:
            adm = self._plan_frontier(req, cap, wait=wait, budget=budget)
            if adm is not None:
                return adm
            # no qualifying frontier point: the existing escalation
            # ladder decides (including reject / projected-miss)
        disc = self._discriminators(req)
        candidates = [(req.op, cap, "as-requested")]
        if self._concrete_op(req.op) != "overclock":
            candidates.append(("overclock", cap, "escalated-op"))
        for op_name, steps, action in candidates:
            lat = self.batch_latency_s(req.arch, op_name, steps, **disc)
            if lat <= budget:
                return Admission(admitted=True, op=op_name, steps=steps,
                                 action=action, projected_wait_s=wait,
                                 projected_total_s=wait + lat)
        floor = min(cap, self.cfg.min_steps)
        for steps in range(cap - 1, floor - 1, -1):
            lat = self.batch_latency_s(req.arch, "overclock", steps, **disc)
            if lat <= budget:
                return Admission(admitted=True, op="overclock", steps=steps,
                                 action="trimmed-steps",
                                 projected_wait_s=wait,
                                 projected_total_s=wait + lat)
        lat = self.batch_latency_s(req.arch, "overclock", floor, **disc)
        if self.cfg.reject_hopeless:
            return Admission(
                admitted=False, op=req.op, steps=cap, action="rejected",
                projected_wait_s=wait, projected_total_s=wait + lat,
                reason=(f"projected {wait + lat:.3f}s > deadline "
                        f"{req.deadline_s:.3f}s even at (overclock, "
                        f"{floor} steps)"))
        return Admission(admitted=True, op="overclock", steps=floor,
                         action="projected-miss", projected_wait_s=wait,
                         projected_total_s=wait + lat,
                         reason="admitted past its deadline "
                                "(reject_hopeless=False)")

    # ----------------------------------------------------------- frontier
    def frontier_builder(self) -> frontier_lib.FrontierBuilder:
        """The scheduler's (lazily built) frontier enumerator -- public so
        tests and benchmarks sweep the same memoized frontiers admission
        consults."""
        if self._frontier_builder is None:
            eng = self.engine
            self._frontier_builder = frontier_lib.FrontierBuilder(
                em=eng._energy_model_for(),
                nominal_steps=eng.nominal_steps,
                min_steps=self.cfg.min_steps)
        return self._frontier_builder

    def frontier_latency_s(self, req: GenerationRequest,
                           point: frontier_lib.FrontierPoint) -> float:
        """A frontier point's completion latency as the engine will bill
        it: the point's full-bucket perfmodel latency plus the residual
        offload stall for this configuration (0.0 offload-free)."""
        return point.latency_s + self.engine.offload_stall_s(
            req.arch, point.op, point.steps,
            self.engine.resolve_interval(req), req.mode)

    def _plan_frontier(self, req: GenerationRequest, cap: int,
                       wait: Optional[float],
                       budget: Optional[float]) -> Optional[Admission]:
        """Frontier resolution step: pick the compute-optimal knob point
        for a request with an ``energy_budget_j``/``quality_floor``
        objective, or None when no point qualifies (the caller falls back
        to the escalation ladder).

        Selection is provably optimal over the FULL knob space even
        though only the pruned Pareto set is searched: every constraint
        here is monotone in the objectives (deadline/budget cap two
        minimized axes, the floor bounds the maximized one), so any
        feasible dominated point has a dominating frontier point that is
        also feasible and at least as good under every objective below
        -- the brute-force equivalence test in tests/test_frontier.py
        checks exactly this.
        """
        if servable_lib.paradigm_for(req.arch) != "diffusion":
            # AR requests reject these knobs at engine.submit with a
            # reasoned error; never consult a diffusion frontier for them.
            return None
        eng = self.engine
        points = self.frontier_builder().frontier(
            eng._full_cfg(req.arch), cap, eng.batcher.bucket, req.mode,
            eng.resolve_interval(req))
        lat = {p: self.frontier_latency_s(req, p) for p in points}
        ok = [p for p in points
              if (req.quality_floor is None
                  or p.quality >= req.quality_floor - 1e-12)
              and (req.energy_budget_j is None
                   or p.energy_j <= req.energy_budget_j + 1e-12)
              and (budget is None or lat[p] <= budget)]
        # Audit record for the admission span: every Pareto point that
        # was on the table, rendered compactly (the frontier is the
        # pruned set, typically a handful of points).
        self._frontier_audit = dict(
            frontier_points=len(points), frontier_ok=len(ok),
            frontier_considered=tuple(
                f"{p.op}/{p.steps}st/{p.precision}"
                + ("/ts" if p.taylorseer else "")
                + f" q={p.quality:.4f} e={p.energy_j:.4g}J"
                  f" l={lat[p]:.4g}s"
                for p in points))
        if not ok:
            return None
        if budget is not None:
            # deadline-constrained: cheapest energy that makes it in time
            objective = "min-energy"
            pick = min(ok, key=lambda p: (p.energy_j, -p.quality, lat[p],
                                          frontier_lib.sort_key(p)))
        elif req.quality_floor is not None:
            # quality floor, no deadline: fastest point at/above the floor
            objective = "min-latency"
            pick = min(ok, key=lambda p: (lat[p], -p.quality, p.energy_j,
                                          frontier_lib.sort_key(p)))
        else:
            # budget only: best quality the budget buys
            objective = "max-quality"
            pick = min(ok, key=lambda p: (-p.quality, p.energy_j, lat[p],
                                          frontier_lib.sort_key(p)))
        eng.telemetry.on_frontier_choice(objective, len(points))
        self._frontier_audit.update(
            objective=objective,
            chosen=(f"{pick.op}/{pick.steps}st/{pick.precision}"
                    + ("/ts" if pick.taylorseer else "")))
        return Admission(
            admitted=True, op=pick.op, steps=pick.steps, action="frontier",
            projected_wait_s=wait,
            projected_total_s=None if wait is None else wait + lat[pick],
            precision=pick.precision, taylorseer=pick.taylorseer,
            projected_energy_j=pick.energy_j, quality=pick.quality)

    # --------------------------------------------------------- projection
    def projected_wait_s(self, req: GenerationRequest) -> float:
        """Modeled time until ``req``'s bucket could start: the batch
        latencies of every pending request that outranks it, grouped into
        same-configuration buckets of the engine's bucket size.

        Approximations, on purpose (documented in docs/scheduler.md): the
        newcomer is assumed to open its own bucket (no co-batching credit),
        ``auto`` ops are priced at the monitor's current ladder point, and
        aging promotions between now and formation are ignored. All errors
        are conservative or second-order for admission purposes.
        """
        mine = self._urgency(req, _tiebreak=math.inf)
        ahead: Dict[Tuple, int] = {}
        for r in self.engine.queue.pending():
            if self._urgency(r) < mine:
                k = (r.arch, self._concrete_op(r.op), r.steps,
                     tuple(sorted(self._discriminators(r).items())))
                ahead[k] = ahead.get(k, 0) + 1
        bucket = self.engine.batcher.bucket
        wait = 0.0
        for (arch, op_name, steps, disc), n in ahead.items():
            n_batches = -(-n // bucket)            # ceil
            wait += n_batches * self.batch_latency_s(arch, op_name, steps,
                                                     **dict(disc))
        return wait

    def _discriminators(self, req: GenerationRequest) -> Dict[str, object]:
        """Learned-estimator key discriminators beyond (arch, op, steps,
        bucket): fields that change a batch's billed latency without
        changing its perfmodel admission price (the fallback deliberately
        ignores them to stay bit-identical to the pre-telemetry path).
        ``rollback_interval="auto"`` resolves through the engine's offload
        planner here, so projections price the interval that will actually
        run -- the same single-resolution contract as ``op="auto"``."""
        return {"mode": req.mode, "taylorseer": req.taylorseer,
                "rollback_interval": self.engine.resolve_interval(req),
                "precision": req.precision}

    def batch_latency_s(self, arch: str, op_name: str, steps: int,
                        **disc) -> float:
        """Estimated latency of one full bucket of this configuration.

        Learned first: if the engine telemetry's estimator has
        served-batch history for (arch, resolved op, steps, bucket) --
        plus the ``disc`` discriminators (mode, taylorseer,
        rollback_interval; defaulting to the standard drift
        configuration) -- its estimate wins: measured, not modeled,
        cost. Otherwise the perfmodel fallback is the same
        ``energy.run_cost`` call (full-size arch, batch = bucket) the
        engine bills results with and advances its clock by, memoized on
        operating-point *parameters* so ladder/guardband adaptation of
        "auto" can never be served a stale projection. With checkpoint
        offload enabled the perfmodel path additionally charges the
        planner's residual refresh stall (``engine.offload_stall_s``) --
        the same term the engine adds to its virtual clock -- while the
        learned path already sees it inside observed batch latencies."""
        eng = self.engine
        concrete = self._concrete_op(op_name)
        bucket = eng.batcher.bucket
        tele = getattr(eng, "telemetry", None)
        if self.cfg.use_learned_latency and tele is not None:
            learned = tele.learned_latency_s(arch, concrete, steps, bucket,
                                             **disc)
            if learned is not None:
                tele.on_projection("learned")
                return learned
            tele.on_projection("perfmodel")
        op = dvfs_lib.OP_BY_NAME.get(concrete, dvfs_lib.NOMINAL)
        key = (arch, op.voltage, op.freq_ghz, steps, bucket,
               eng.nominal_steps)
        cached = self._latency_cache.get(key)
        if cached is None:
            rc = energy.RunConfig(num_steps=steps,
                                  nominal_steps=eng.nominal_steps,
                                  aggressive=op)
            cost = energy.run_cost(eng._full_cfg(arch), rc, batch=bucket,
                                   em=eng._energy_model_for())
            cached = self._latency_cache[key] = cost["latency_s"]
        # refresh stall is interval-dependent, so it stays outside the
        # operating-point memo (the engine memoizes it per configuration);
        # identically 0.0 on an offload-free engine -- the bit-identical
        # pre-offload projection
        return cached + eng.offload_stall_s(
            arch, concrete, steps,
            disc.get("rollback_interval", rollback_lib.DEFAULT_INTERVAL),
            disc.get("mode", "drift"))

    # ---------------------------------------------------------- formation
    def _concrete_op(self, op_name: str) -> str:
        """Resolve "auto" to the point it would run at right now --
        ``engine.auto_op_name()``, i.e. the monitor's ladder index floored
        by the telemetry guardband -- for cost estimation (the batcher
        re-resolves through the same method at formation time; the ladder
        rarely moves between admission and formation, and all ladder
        points share nominal frequency, so the latency estimate is exact
        anyway)."""
        if op_name == "auto":
            return self.engine.auto_op_name()
        return op_name

    def _urgency(self, req: GenerationRequest,
                 _tiebreak: Optional[float] = None) -> Tuple:
        """Sort key for batch formation: (priority rank, absolute deadline,
        FIFO). Aged-out requests jump to rank -1 -- ahead of everything --
        which is the starvation guard. ``_tiebreak`` overrides the id for
        not-yet-enqueued probes so equal-urgency incumbents sort ahead."""
        rank = PRIORITY_RANK[req.priority]
        if (self.cfg.age_s is not None
                and self.engine.clock_s - req.submitted_at_s
                >= self.cfg.age_s):
            rank = -1
        dl = req.absolute_deadline_s
        return (rank, math.inf if dl is None else dl,
                req.request_id if _tiebreak is None else _tiebreak)

    # ------------------------------------------------------------ serving
    def run(self):
        """Drain the queue through the engine (priority formation order,
        results in submission order -- see ``DriftServeEngine.run``)."""
        return self.engine.run()

    def run_stream(self, preview_interval: int = 1):
        """Streaming drain: ``PreviewEvent``s + ``RequestResult``s in
        priority formation order (see ``DriftServeEngine.run_stream``)."""
        return self.engine.run_stream(preview_interval)
