"""Serving request/result types and the FIFO request queue.

Counterpart of ``repro.serving.request``. A ``GenerationRequest`` names
the arch, step count (denoising steps, or tokens to decode), protection
mode, DVFS operating point (``"auto"`` defers to the engine's
BER-monitor ladder), TaylorSeer and the precision plan. Which modes and
knobs an arch takes depends on its paradigm and is checked at submit by
its servable (``servable.validate_request``). ``rollback_interval`` is an
int >= 1 or ``"auto"`` (the engine's offload planner picks it). The
scheduling contract -- ``priority``, ``deadline_s``, ``step_budget``,
``energy_budget_j``, ``quality_floor`` -- is validated as the reference
validates it; ``serving.scheduler.DeadlineScheduler`` turns it into a
concrete assignment at admission. ``PreviewEvent`` is one streamed
preview (``DriftServeEngine.run_stream``).

Time base: ``submitted_at_s`` and ``RequestResult.completed_at_s`` are
stamps of the engine's virtual clock (``DriftServeEngine.clock_s``),
which advances by the perfmodel latency of each served batch: seconds
on the modeled paper accelerator, not on the GPU or the host.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, List, Optional, Union

from repro_torch.core.dvfs import OP_LADDER
from repro_torch.core.exec_ctx import MODES
from repro_torch.core.quant import get_plan
from repro_torch.core.rollback import DEFAULT_INTERVAL

REQUEST_OPS = ("nominal", "undervolt", "overclock", "auto") + tuple(
    p.name for p in OP_LADDER
    if p.name not in ("nominal", "undervolt", "overclock"))

# Scheduling classes, most to least urgent: the priority batcher serves
# "interactive" buckets before "standard" before "background"; within a
# class, earlier deadlines first, then FIFO.
REQUEST_PRIORITIES = ("interactive", "standard", "background")
PRIORITY_RANK = {name: i for i, name in enumerate(REQUEST_PRIORITIES)}


@dataclasses.dataclass(frozen=True)
class GenerationRequest:
    """One queued generation job. Frozen: the queue hands out copies only."""
    request_id: int
    arch: str = "dit-xl-512"
    smoke: bool = True
    steps: int = 10
    mode: str = "drift"
    op: str = "undervolt"
    seed: int = 0                  # drives its initial latents or prompt
    taylorseer: bool = False
    precision: str = "int8"
    rollback_interval: Union[int, str] = DEFAULT_INTERVAL
    # --- scheduling contract (serving/scheduler.py)
    priority: str = "standard"     # REQUEST_PRIORITIES member
    # relative deadline in engine virtual seconds from submission
    deadline_s: Optional[float] = None
    # cap on steps; the engine clamps ``steps`` to it at submit()
    step_budget: Optional[int] = None
    # frontier objectives (serving/frontier.py): joules for this
    # request's share, and the quality proxy's floor in (0, 1]
    energy_budget_j: Optional[float] = None
    quality_floor: Optional[float] = None
    # engine virtual-clock stamp at submission; set by the engine
    submitted_at_s: float = 0.0

    def __post_init__(self):
        if self.op not in REQUEST_OPS:
            raise ValueError(
                f"unknown operating point {self.op!r}; one of {REQUEST_OPS}")
        if self.mode not in MODES:
            raise ValueError(
                f"unknown DRIFT mode {self.mode!r}; one of {MODES}")
        if self.priority not in REQUEST_PRIORITIES:
            raise ValueError(
                f"unknown priority {self.priority!r}; one of "
                f"{REQUEST_PRIORITIES}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")
        if self.step_budget is not None and self.step_budget < 1:
            raise ValueError(
                f"step_budget must be >= 1, got {self.step_budget}")
        if self.energy_budget_j is not None and self.energy_budget_j <= 0:
            raise ValueError(
                f"energy_budget_j must be > 0, got {self.energy_budget_j}")
        if self.quality_floor is not None and not (
                0.0 < self.quality_floor <= 1.0):
            raise ValueError(
                f"quality_floor must be in (0, 1], got {self.quality_floor}")
        if self.steps < 1:
            raise ValueError(f"steps must be >= 1, got {self.steps}")
        get_plan(self.precision)          # unknown plan names raise
        if isinstance(self.rollback_interval, str):
            if self.rollback_interval != "auto":
                raise ValueError(
                    f"rollback_interval must be an int >= 1 or 'auto', "
                    f"got {self.rollback_interval!r}")
        elif self.rollback_interval < 1:
            raise ValueError(
                f"rollback_interval must be >= 1, got "
                f"{self.rollback_interval}")

    @property
    def absolute_deadline_s(self) -> Optional[float]:
        """Deadline on the engine's virtual clock, or None."""
        if self.deadline_s is None:
            return None
        return self.submitted_at_s + self.deadline_s


@dataclasses.dataclass(frozen=True)
class PreviewEvent:
    """One streamed intermediate result: a request's slot of the batch
    latents after ``step`` of ``total_steps`` denoising steps. Yielded by
    ``DriftServeEngine.run_stream`` between windows; the matching
    ``RequestResult`` follows once the batch finishes."""
    request_id: int
    batch_index: int
    step: int                      # completed denoising steps (1-based)
    total_steps: int
    latents: object                # (H, W, C), clipped to [-1, 1]


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """Structured per-request outcome of one engine run."""
    request_id: int
    batch_index: int               # which micro-batch served this request
    bucket_size: int
    op: str                        # resolved operating-point name
    mode: str
    steps: int
    # quality vs the cached clean reference (same latents, BER 0)
    lpips_vs_clean: float
    psnr_vs_clean_db: float
    # rollback-corrected elements summed over the WHOLE batch tensor
    # (padded slots included): one count per batch, not per request
    batch_corrected_elems: int
    # computed model evaluations of the batch (< steps when TaylorSeer
    # forecasts; prefill, decodes and replays for autoregressive requests)
    n_model_evals: int
    # perfmodel attribution, in joules and virtual seconds of the modeled
    # paper accelerator (not the GPU): this request's share of the
    # bucket's cost; latency is the shared batch latency
    energy_j: float
    latency_s: float
    baseline_energy_j: float
    baseline_latency_s: float
    # BER-monitor state after this request's batch
    monitor_ber: float
    monitor_op_index: int
    # knobs the batch ran under
    taylorseer: bool = False
    precision: str = "int8"
    # this request's sample: its slot of the batch latents, clipped to
    # [-1, 1], shape (H, W, C); None for autoregressive requests
    latents: Optional[object] = None
    # autoregressive requests: generated token ids, the share equal to the
    # clean reference's, statistical-ABFT flagged rows and rolled-back
    # windows (both per batch)
    tokens: Optional[tuple] = None
    token_match_vs_clean: Optional[float] = None
    ar_detections: int = 0
    ar_rollbacks: int = 0
    # deadline bookkeeping, on the engine's virtual clock
    priority: str = "standard"
    deadline_s: Optional[float] = None     # the request's relative deadline
    completed_at_s: float = 0.0            # engine clock after this batch
    queue_wait_s: float = 0.0              # completed_at - submitted - batch
    deadline_missed: bool = False
    # resilience heatmap of the batch: detections per (site, timestep
    # bin) as nested int tuples, with the site labels (trace/heatmap.py);
    # None when the batch produced none
    detect_heatmap: Optional[tuple] = None
    detect_heatmap_blocks: Optional[tuple] = None
    # this request's share of the batch cost per perfmodel.energy.
    # ENERGY_COMPONENTS; its ledger_total equals energy_j bitwise
    energy_breakdown: Optional[dict] = None


class RequestQueue:
    """FIFO queue assigning monotonically increasing request ids; the
    priority batcher imposes its order through ``pending()`` and
    ``take_matching(rank=...)``."""

    def __init__(self) -> None:
        self._pending: Deque[GenerationRequest] = collections.deque()
        self._next_id = 0

    def submit(self, **fields) -> int:
        req = GenerationRequest(request_id=self._next_id, **fields)
        self._next_id += 1
        self._pending.append(req)
        return req.request_id

    def __len__(self) -> int:
        return len(self._pending)

    def peek(self) -> Optional[GenerationRequest]:
        return self._pending[0] if self._pending else None

    def pending(self) -> tuple:
        """Snapshot of the pending requests in FIFO order."""
        return tuple(self._pending)

    def take_matching(self, head_key, key_of, limit: int, rank=None
                      ) -> List[GenerationRequest]:
        """Pop up to ``limit`` pending requests whose ``key_of(req)`` equals
        ``head_key``; the others keep their positions. Without ``rank``
        they are chosen and returned in FIFO order; with it the ``limit``
        lowest-ranked matches are chosen (ties FIFO) and returned in FIFO
        order."""
        if rank is not None:
            matches = [r for r in self._pending if key_of(r) == head_key]
            chosen = sorted(matches, key=rank)[:limit]
            chosen_ids = {r.request_id for r in chosen}
            self._pending = collections.deque(
                r for r in self._pending if r.request_id not in chosen_ids)
            return sorted(chosen, key=lambda r: r.request_id)
        taken: List[GenerationRequest] = []
        kept: Deque[GenerationRequest] = collections.deque()
        while self._pending and len(taken) < limit:
            req = self._pending.popleft()
            if key_of(req) == head_key:
                taken.append(req)
            else:
                kept.append(req)
        kept.extend(self._pending)
        self._pending = kept
        return taken
