"""Flight recorder: a bounded ring buffer of serving-stack spans.

Counterpart of ``repro.serving.trace.recorder``, with the same closed
``SPAN_KINDS`` taxonomy and taps. Two kinds read differently in the
port: ``compile`` carries the host time of a ``CompiledSamplerCache``
build (PyTorch compiles nothing), and ``offload_commit`` is recorded
when the offload store joins the copy's CUDA event, its wall duration
the repack and device-to-host copy as the CUDA events timed them (on
the CPU, the host time of the synchronous copy).

Every interesting event in a request's life -- submit, admission decision,
queue wait, batch assembly, compile (cache miss), each step window, each
offload commit/restore, rollback replays, detection summary, finalize --
is recorded as a :class:`Span` carrying BOTH clocks:

* ``virtual_s`` -- the engine's deterministic perfmodel clock
  (``engine.clock_s``, modeled accelerator seconds). The engine only
  advances it when a batch finishes, so every span inside a batch carries
  the batch's *starting* virtual time; ``finalize`` spans carry the
  advanced clock. Virtual durations beyond that resolution are attached
  as attrs (e.g. the batch's modeled ``latency_s``) rather than faked.
* ``wall_s`` -- host ``time.perf_counter`` relative to the recorder's
  epoch. Real durations: compile cost, window cadence, offload commit
  latency.

The recorder is **zero-perturbation by construction**: every hook runs
on the host between windows and adds no device op (the heatmap the
detect spans summarize is computed by the step loop, tracing on or
off), so finals are bit-identical with the recorder enabled, disabled,
or absent -- ``tests/test_torch_trace.py`` asserts it.

Thread-safety: the HTTP front end reads spans from its handler threads
(and ``/events`` drains the engine on one), so all mutation happens
under one lock. Bounded memory: the ring keeps
the newest ``capacity`` spans and counts what it dropped.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

# Span kinds, the full taxonomy (docs/tracing.md documents each):
SPAN_KINDS = (
    "submit",            # request accepted into the queue
    "admission",         # scheduler decision (audit record in attrs)
    "queue_wait",        # submit -> batch assembly, per request
    "batch_assembly",    # micro-batch formed from the queue
    "compile",           # sampler-cache miss: trace + compile
    "window",            # one step window (diffusion steps / AR tokens)
    "offload_commit",    # checkpoint snapshot -> host double buffer
    "offload_restore",   # checkpoint re-upload
    "replay",            # rollback replay (AR window re-decode)
    "detect",            # per-batch detection summary (heatmap attrs)
    "finalize",          # quality/energy attribution, results built
)


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    kind: str                       # one of SPAN_KINDS
    request_ids: Tuple[int, ...]    # every request the span applies to
    batch_index: int                # -1 when not tied to a batch
    t0_virtual_s: float
    t1_virtual_s: float
    t0_wall_s: float
    t1_wall_s: float
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["request_ids"] = list(self.request_ids)
        return d


class FlightRecorder:
    """Bounded span ring buffer shared by one engine and its scheduler."""

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        assert capacity >= 1, capacity
        self.capacity = capacity
        self.enabled = enabled
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self.recorded = 0
        self.dropped = 0
        self._epoch = time.perf_counter()
        # Current-batch context (the engine is single-threaded between
        # batches; readers on other threads take the lock).
        self._batch_index = -1
        self._batch_request_ids: Tuple[int, ...] = ()
        self._batch_virtual_s = 0.0
        self._batch_wall_s = 0.0
        self._last_window_wall_s = 0.0
        self._last_window_steps = 0
        # Per-request submit wall times, for queue_wait spans.
        self._submit_wall: Dict[int, float] = {}
        self._submit_virtual: Dict[int, float] = {}

    # ------------------------------------------------------------ plumbing
    def now_wall(self) -> float:
        return time.perf_counter() - self._epoch

    def record(self, name: str, kind: str, request_ids=(),
               batch_index: int = -1,
               t0_virtual_s: float = 0.0,
               t1_virtual_s: Optional[float] = None,
               t0_wall_s: Optional[float] = None,
               t1_wall_s: Optional[float] = None,
               **attrs) -> Optional[Span]:
        if not self.enabled:
            return None
        wall = self.now_wall()
        span = Span(name=name, kind=kind,
                    request_ids=tuple(int(r) for r in request_ids),
                    batch_index=int(batch_index),
                    t0_virtual_s=float(t0_virtual_s),
                    t1_virtual_s=float(t1_virtual_s
                                       if t1_virtual_s is not None
                                       else t0_virtual_s),
                    t0_wall_s=float(t0_wall_s if t0_wall_s is not None
                                    else wall),
                    t1_wall_s=float(t1_wall_s if t1_wall_s is not None
                                    else wall),
                    attrs=attrs)
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(span)
            self.recorded += 1
        return span

    # --------------------------------------------------------- engine taps
    def on_submit(self, request_id: int, virtual_s: float, **attrs) -> None:
        if not self.enabled:
            return
        wall = self.now_wall()
        with self._lock:
            self._submit_wall[int(request_id)] = wall
            self._submit_virtual[int(request_id)] = float(virtual_s)
        self.record("submit", "submit", request_ids=(request_id,),
                    t0_virtual_s=virtual_s, t0_wall_s=wall, t1_wall_s=wall,
                    **attrs)

    def begin_batch(self, batch_index: int, request_ids, virtual_s: float,
                    **attrs) -> None:
        """Open a batch context: queue_wait spans for each member, then a
        batch_assembly span. Window/offload/detect spans recorded until
        the next ``begin_batch`` attach to this batch."""
        if not self.enabled:
            return
        wall = self.now_wall()
        with self._lock:
            self._batch_index = int(batch_index)
            self._batch_request_ids = tuple(int(r) for r in request_ids)
            self._batch_virtual_s = float(virtual_s)
            self._batch_wall_s = wall
            self._last_window_wall_s = wall
            self._last_window_steps = 0
            submit_wall = dict(self._submit_wall)
            submit_virtual = dict(self._submit_virtual)
        for rid in self._batch_request_ids:
            t0w = submit_wall.get(rid, wall)
            t0v = submit_virtual.get(rid, virtual_s)
            self.record(f"queue_wait r{rid}", "queue_wait",
                        request_ids=(rid,), batch_index=batch_index,
                        t0_virtual_s=t0v, t1_virtual_s=virtual_s,
                        t0_wall_s=t0w, t1_wall_s=wall)
        self.record(f"batch {batch_index}", "batch_assembly",
                    request_ids=self._batch_request_ids,
                    batch_index=batch_index, t0_virtual_s=virtual_s,
                    t0_wall_s=wall, t1_wall_s=wall, **attrs)

    def on_compile(self, wall_elapsed_s: float, **attrs) -> None:
        if not self.enabled:
            return
        wall = self.now_wall()
        with self._lock:
            bi, rids, v = (self._batch_index, self._batch_request_ids,
                           self._batch_virtual_s)
        self.record("compile", "compile", request_ids=rids, batch_index=bi,
                    t0_virtual_s=v, t0_wall_s=wall - wall_elapsed_s,
                    t1_wall_s=wall, **attrs)

    def on_window(self, done_steps: int, **attrs) -> None:
        if not self.enabled:
            return
        wall = self.now_wall()
        with self._lock:
            bi, rids, v = (self._batch_index, self._batch_request_ids,
                           self._batch_virtual_s)
            t0w = self._last_window_wall_s
            from_step = self._last_window_steps
            self._last_window_wall_s = wall
            self._last_window_steps = int(done_steps)
        self.record(f"window ->{done_steps}", "window", request_ids=rids,
                    batch_index=bi, t0_virtual_s=v, t0_wall_s=t0w,
                    t1_wall_s=wall, from_step=from_step,
                    done_steps=int(done_steps), **attrs)

    def on_offload(self, event: str, step: int, wall_elapsed_s: float = 0.0,
                   **attrs) -> None:
        """``event`` is "commit" or "restore"; called by the offload store
        when it settles a commit or restores a snapshot."""
        if not self.enabled:
            return
        wall = self.now_wall()
        with self._lock:
            bi, rids, v = (self._batch_index, self._batch_request_ids,
                           self._batch_virtual_s)
        self.record(f"offload_{event} @{step}", f"offload_{event}",
                    request_ids=rids, batch_index=bi, t0_virtual_s=v,
                    t0_wall_s=wall - max(wall_elapsed_s, 0.0),
                    t1_wall_s=wall, step=int(step), **attrs)

    def on_replay(self, window_start: int, window_len: int, **attrs) -> None:
        if not self.enabled:
            return
        with self._lock:
            bi, rids, v = (self._batch_index, self._batch_request_ids,
                           self._batch_virtual_s)
        self.record(f"replay @{window_start}", "replay", request_ids=rids,
                    batch_index=bi, t0_virtual_s=v,
                    window_start=int(window_start),
                    window_len=int(window_len), **attrs)

    def finish_batch(self, virtual_t1_s: float, detect_attrs=None,
                     **finalize_attrs) -> None:
        """Close the batch: a detect-summary span (heatmap totals) when
        detection ran, then the finalize span spanning the batch's whole
        virtual interval."""
        if not self.enabled:
            return
        wall = self.now_wall()
        with self._lock:
            bi, rids, v0 = (self._batch_index, self._batch_request_ids,
                            self._batch_virtual_s)
            t0w = self._batch_wall_s
            for rid in rids:
                self._submit_wall.pop(rid, None)
                self._submit_virtual.pop(rid, None)
        if detect_attrs is not None:
            self.record(f"detect batch {bi}", "detect", request_ids=rids,
                        batch_index=bi, t0_virtual_s=v0,
                        t1_virtual_s=virtual_t1_s, t0_wall_s=t0w,
                        t1_wall_s=wall, **detect_attrs)
        self.record(f"finalize batch {bi}", "finalize", request_ids=rids,
                    batch_index=bi, t0_virtual_s=v0,
                    t1_virtual_s=virtual_t1_s, t0_wall_s=t0w,
                    t1_wall_s=wall, **finalize_attrs)

    # ------------------------------------------------------------- queries
    def spans(self, request_id: Optional[int] = None) -> List[Span]:
        """Newest-last snapshot; filtered to one request when given."""
        with self._lock:
            snap = list(self._ring)
        if request_id is None:
            return snap
        rid = int(request_id)
        return [s for s in snap if rid in s.request_ids]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
