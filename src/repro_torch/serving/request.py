"""Serving request/result types and the FIFO request queue.

Counterpart of ``repro.serving.request``. A ``GenerationRequest`` names
the arch, step count (denoising steps, or tokens to decode), protection
mode, DVFS operating point (``"auto"`` defers to the engine's
BER-monitor ladder), TaylorSeer and the precision plan. Which modes and
knobs an arch takes depends on its paradigm and is checked at submit by
its servable (``servable.validate_request``). ``rollback_interval`` is an
int >= 1 or ``"auto"`` (the engine's offload planner picks it). The
request schema keeps the reference's fields, but those whose machinery is
not yet ported -- priority and deadlines, energy budgets and quality
floors -- raise a ``ValueError`` naming the ROADMAP item when a request
sets them. ``PreviewEvent`` is one streamed preview
(``DriftServeEngine.run_stream``).

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


def _not_ported(what: str, item: str) -> ValueError:
    return ValueError(f"{what} is not yet ported to repro_torch (ROADMAP "
                      f"Queue A item {item})")


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
    priority: str = "standard"
    deadline_s: Optional[float] = None
    step_budget: Optional[int] = None
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
        if self.priority != "standard" or self.deadline_s is not None:
            raise _not_ported("priority/deadline_s", "10 (scheduler)")
        if self.energy_budget_j is not None or self.quality_floor is not None:
            raise _not_ported("energy_budget_j/quality_floor",
                              "10 (frontier)")
        if self.step_budget is not None and self.step_budget < 1:
            raise ValueError(
                f"step_budget must be >= 1, got {self.step_budget}")


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
    # engine virtual clock after this request's batch
    completed_at_s: float = 0.0
    # this request's share of the batch cost per perfmodel.energy.
    # ENERGY_COMPONENTS; its ledger_total equals energy_j bitwise
    energy_breakdown: Optional[dict] = None


class RequestQueue:
    """FIFO queue assigning monotonically increasing request ids."""

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

    def take_matching(self, head_key, key_of, limit: int
                      ) -> List[GenerationRequest]:
        """Pop up to ``limit`` pending requests whose ``key_of(req)`` equals
        ``head_key``, in FIFO order; the others keep their positions."""
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
