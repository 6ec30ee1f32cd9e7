"""The DRIFT batched serving engine.

Counterpart of ``repro.serving.engine.DriftServeEngine``, reduced to the
ported paths: DiT diffusion and dense autoregressive decoding, each behind
its servable (``servable_for(arch)``). A FIFO ``RequestQueue`` and
``MicroBatcher`` group requests
into fixed-size same-configuration buckets (short tails padded); a sampler
cache keyed by (arch, steps, mode, operating point, bucket, rollback
interval) that builds each configuration once; a params cache; per-request
operating points, where ``"auto"`` reads the BER monitor's ladder index,
and the monitor carried from batch to batch (Sec 5.1); a bounded LRU of
error-free reference samples per (configuration, latent seeds); and
per-request quality scores returned as ``RequestResult`` records.

Every result carries the perfmodel's attribution: the batch is priced
once (``energy.run_cost`` on the full-width config at the bucket size,
from the servable's ``RunConfig``), each live request bills an equal
share (``per_request_cost``, whose breakdown sums bitwise to its
``energy_j``), beside the nominal unprotected baseline
(``baseline_rc``). A **virtual clock** (``clock_s``) advances by each
batch's modeled latency; requests are stamped with it at submission and
completion. These joules and seconds are the modeled paper
accelerator's, not the GPU's. The attribution runs once per batch, after
the servable has read the batch's counts, so it adds no device work.

The engine runs on ``device`` ("cuda" by default). Without a GPU it raises;
it never falls back to the CPU -- the tests pass ``device="cpu"``. Flip
masks come from ``flip_source_factory(batch_index)``, by default a Philox
source seeded from (base seed, batch index, site); see ``core.fault``.

Every batch drains one windowed sampler (``sample_stream``); the window
is a call argument, so a configuration is built once whatever its
window. **Streaming** (``run_stream``): the same queue drain, with the
preview interval as the window, yielding ``PreviewEvent`` latent
previews between windows before the final ``RequestResult`` records,
with final latents bit-identical to ``run()``.

**Checkpoint offload** (``offload=OffloadConfig()``, the CLI's
``--offload``): monitored-mode batches run the windowed sampler with the
rollback refresh interval as the window, and the engine's one
``OffloadStore`` snapshots the live checkpoint stores between windows
into pinned host memory on a side CUDA stream, overlapped with the next
window (``serving.offload``). Finals are bit-identical with offload on or
off; the planner's modeled residual refresh stall is charged on the
virtual clock, and ``rollback_interval="auto"`` requests resolve their
refresh interval through the offload planner
(``auto_rollback_interval``, the ``auto_op_index`` analogue).

**Telemetry** (``telemetry=EngineTelemetry()``, on by default; the
CLI's ``--no-telemetry`` builds ``EngineTelemetry(enabled=False)``) and
the **flight recorder** (``tracer=FlightRecorder()``, on by default)
are fed on the host once per batch, from numbers the engine already
holds after the batch (the monitor's EMA, the corrected count, the
heatmap moved to the host once): metrics, the latency history the
scheduler reads, the guardband controller that floors ``op="auto"``
(``auto_op_index``), the energy ledger (``verify_cost`` on every
batch's shared ledger), the SLO tracker, and spans with both clocks.
They add no device op and no synchronize, so finals are bit-identical
with them on, disabled or absent. Deadline-aware admission and priority
formation live one layer up, in ``serving.scheduler.DeadlineScheduler``;
the engine stamps each result's queue wait and deadline miss.
"""
from __future__ import annotations

import collections
import dataclasses
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.core import dvfs as dvfs_lib
from repro_torch.core import fault
from repro_torch.core import quant as quant_lib
from repro_torch.diffusion import sampler as sampler_lib
from repro_torch.perfmodel import energy
from repro_torch.serving import servable as servable_lib
from repro_torch.serving.batcher import MicroBatch, MicroBatcher
from repro_torch.serving.cache import CompiledSamplerCache, SamplerKey
from repro_torch.serving.offload import (OffloadConfig, OffloadPlanner,
                                         OffloadStore)
from repro_torch.serving.request import (GenerationRequest, RequestQueue,
                                         RequestResult)
from repro_torch.serving.telemetry import EngineTelemetry, verify_cost
from repro_torch.serving.trace import FlightRecorder


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no GPU present
    raises (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    return dev


@dataclasses.dataclass
class EngineStats:
    batches: int = 0
    padded_slots: int = 0
    clean_samples_computed: int = 0
    clean_sample_hits: int = 0
    preview_events: int = 0        # streamed previews yielded (live slots)
    deadline_misses: int = 0       # requests completed past their deadline


@dataclasses.dataclass
class _BatchCtx:
    """What ``_prepare_batch`` stages for one micro-batch."""
    batch_index: int
    params: object
    padded_seeds: Tuple[int, ...]
    inputs: Tuple                 # (latents, cond) or (prompt tokens,)
    flip_source: fault.FlipSource
    # this batch's OffloadStats delta, set by the drain after it joins
    # the store; None when no offload ran
    offload_delta: Optional[object] = None


class DriftServeEngine:
    """Batched serving engine for DRIFT diffusion sampling and
    autoregressive decoding."""

    def __init__(self, arch: str = "dit-xl-512", smoke: bool = True,
                 bucket: int = 2, base_seed: int = 0,
                 nominal_steps: int = 2,
                 monitor_target_ber: float = 3e-3,
                 clean_cache_size: int = 8,
                 device="cuda",
                 flip_source_factory: Optional[
                     Callable[[int], fault.FlipSource]] = None,
                 sampler_factory: Optional[Callable] = None,
                 offload: Optional[OffloadConfig] = None,
                 telemetry: Optional[EngineTelemetry] = None,
                 tracer: Optional[FlightRecorder] = None):
        self.device = resolve_device(device)
        self.default_arch = arch
        self.default_smoke = smoke
        self.base_seed = int(base_seed)
        self.nominal_steps = nominal_steps
        self.monitor_target_ber = monitor_target_ber
        self.queue = RequestQueue()
        self.batcher = MicroBatcher(bucket)
        self.cache = CompiledSamplerCache()
        self.stats = EngineStats()
        # telemetry and the flight recorder, both on by default; pass
        # EngineTelemetry(enabled=False) / FlightRecorder(enabled=False)
        # to turn either off
        self.telemetry = (telemetry if telemetry is not None
                          else EngineTelemetry()).bind(monitor_target_ber)
        self.tracer = tracer if tracer is not None else FlightRecorder()
        self.cache.on_compile = self._on_compile
        self.monitor = dvfs_lib.ber_monitor_init(self.device)
        self.flip_source_factory = (
            flip_source_factory if flip_source_factory is not None
            else fault.philox_source_factory(self.base_seed, self.device))
        self._sampler_factory = (sampler_factory
                                 or self._default_sampler_factory)
        self._batch_counter = 0
        self._params: Dict[Tuple[str, bool], object] = {}
        self._clean_samples: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._clean_cache_size = clean_cache_size
        self._servables: Dict[str, object] = {}
        # perfmodel: calibrated on first use
        self._energy_model: Optional[energy.EnergyModel] = None
        # virtual clock, modeled-accelerator seconds
        self.clock_s = 0.0
        # One offload store for the whole engine, rebound per batch; None
        # = offload off. The planner exists regardless, so "auto"
        # intervals resolve on an offload-free engine too.
        self.offload_cfg = offload
        self._offload_store = (OffloadStore(self.offload_cfg)
                               if self.offload_cfg is not None else None)
        if self._offload_store is not None:
            self._offload_store.on_event = self.tracer.on_offload
        self._active_offload: Optional[OffloadStore] = None
        # True while a batch drains in windows the reference streams
        # (run_stream, or offload): only then do the window taps fire,
        # as the reference's one-shot scan fires none
        self._stream_taps = False
        self._planner: Optional[OffloadPlanner] = None
        self._interval_memo: Dict[Tuple, int] = {}
        self._stall_memo: Dict[Tuple, float] = {}
        # per-window energy attribution for window/replay spans: a
        # per-computed-step estimate memoized per configuration
        self._window_j_memo: Dict[Tuple, float] = {}
        self._window_step_j = 0.0
        self._window_prev_steps = 0

    def _default_sampler_factory(self, key: SamplerKey, model_cfg, scfg):
        """The windowed ``sample_stream`` with the offload tap on its
        carry; the caller picks the window per call (the whole chain, the
        refresh interval, or the preview interval)."""
        def run(params, flip_source, latents, cond, monitor0, window):
            return sampler_lib.sample_stream(
                model_cfg, params, flip_source, latents, cond, scfg,
                monitor0=monitor0, window=window,
                on_window=self._on_stream_window,
                on_carry=self._offload_on_carry)
        return run

    # ---------------------------------------------------------- servables
    def servable_for(self, arch: str):
        """The servable of this arch's family, one per engine."""
        cls = servable_lib.servable_class(arch)
        sv = self._servables.get(cls.paradigm)
        if sv is None:
            sv = self._servables[cls.paradigm] = cls(self)
        return sv

    @property
    def servable(self):
        """The servable of the engine's default arch."""
        return self.servable_for(self.default_arch)

    # ------------------------------------------------------------- intake
    def submit(self, **fields) -> int:
        """Queue one generation request; returns its request id. ``arch``
        and ``smoke`` default to the engine's; ``steps`` is clamped to
        ``step_budget``. A mode the arch's paradigm does not take, and
        fields whose machinery is not yet ported, raise a ``ValueError``."""
        fields.setdefault("arch", self.default_arch)
        fields.setdefault("smoke", self.default_smoke)
        budget = fields.get("step_budget")
        if budget is not None:
            default_steps = GenerationRequest.__dataclass_fields__[
                "steps"].default
            fields["steps"] = min(fields.get("steps", default_steps), budget)
        configs.get_config(fields["arch"], smoke=fields["smoke"])
        fields.setdefault("submitted_at_s", self.clock_s)
        fields = self.servable_for(fields["arch"]).validate_request(fields)
        rid = self.queue.submit(**fields)
        self.telemetry.on_submit()
        self.tracer.on_submit(rid, self.clock_s,
                              arch=fields["arch"],
                              mode=fields.get("mode", "drift"),
                              op=fields.get("op", "undervolt"),
                              steps=fields.get("steps", 10),
                              priority=fields.get("priority", "standard"))
        return rid

    # ------------------------------------------------------------ serving
    def run(self) -> List[RequestResult]:
        """Drain the queue, one micro-batch at a time; results come back in
        submission order."""
        results: Dict[int, RequestResult] = {}
        while len(self.queue):
            mb = self.batcher.next_batch(self.queue, self._resolve_op,
                                         self._resolve_interval)
            for res in self._run_batch(mb):
                results[res.request_id] = res
        return [results[rid] for rid in sorted(results)]

    def run_stream(self, preview_interval: int = 1):
        """Drain the queue as a generator of streamed events: per
        micro-batch, a ``PreviewEvent`` for every live request after each
        ``preview_interval`` denoising steps, then the batch's
        ``RequestResult`` records (in batch order). Final latents are
        bit-identical to ``run()``'s, from the same built sampler."""
        if preview_interval < 1:
            raise ValueError(f"preview_interval must be >= 1, got "
                             f"{preview_interval}")
        while len(self.queue):
            mb = self.batcher.next_batch(self.queue, self._resolve_op,
                                         self._resolve_interval)
            yield from self._run_batch_stream(mb, preview_interval)

    def _resolve_op(self, req: GenerationRequest) -> str:
        if req.op == "auto":
            return self.auto_op_name()
        return req.op

    def auto_op_index(self) -> int:
        """Ladder index an ``op="auto"`` request resolves to now: the BER
        monitor's index, floored by the telemetry guardband controller
        (the identity with telemetry off). Batch formation and the
        scheduler's pricing both resolve "auto" here."""
        return self.telemetry.clamp_ladder_index(int(self.monitor.op_index))

    def auto_op_name(self) -> str:
        return dvfs_lib.ladder_op(self.auto_op_index()).name

    # -------------------------------------------- rollback-interval auto
    def _resolve_interval(self, req: GenerationRequest) -> int:
        """A request's concrete refresh interval: its own int, or for
        ``rollback_interval="auto"`` the offload planner's choice for
        (arch, resolved op, steps, bucket)."""
        if req.rollback_interval == "auto":
            return self.auto_rollback_interval(req.arch,
                                               self._resolve_op(req),
                                               req.steps)
        return int(req.rollback_interval)

    # public alias: the scheduler prices learned-estimator keys with it
    resolve_interval = _resolve_interval

    def auto_rollback_interval(self, arch: str, op_name: str,
                               steps: int) -> int:
        """The ``rollback_interval="auto"`` resolution point: the offload
        planner's argmin interval for this configuration at the
        detection rate of :meth:`_detect_rate`. Memoized per (arch, op,
        steps, bucket, quantized detection rate)."""
        rate = self._detect_rate(op_name, arch)
        bucket = self.batcher.bucket
        key = (arch, op_name, steps, bucket, f"{rate:.1e}")
        cached = self._interval_memo.get(key)
        if cached is None:
            op = dvfs_lib.OP_BY_NAME.get(op_name, dvfs_lib.NOMINAL)
            plan = self._planner_for().plan(self._full_cfg(arch), op,
                                            steps, bucket,
                                            detect_rate=rate)
            cached = self._interval_memo[key] = plan.interval
        return cached

    def _detect_rate(self, op_name: str, arch: str) -> float:
        """Expected rollback-triggering detections per denoising step, in
        [0, 1]: the realized BER (the guardband controller's EWMA for
        this op once it has history, the monitor's target before that or
        with telemetry off) times the per-step GEMM word count,
        saturated."""
        ber = None
        ctrl = self.telemetry.controller if self.telemetry.enabled else None
        if ctrl is not None:
            ber = ctrl.realized_ber.get(op_name)
        if ber is None:
            ber = self.monitor_target_ber
        words = energy.activation_bytes(self._full_cfg(arch), 1) / 4.0
        return min(1.0, float(ber) * words)

    def _planner_for(self) -> OffloadPlanner:
        if self._planner is None:
            cfg = self.offload_cfg or OffloadConfig()
            self._planner = OffloadPlanner(
                em=self._energy_model_for(),
                nominal_steps=self.nominal_steps,
                repacked=cfg.repacked, overlapped=cfg.async_commit,
                tile_m=cfg.tile_m, tile_n=cfg.tile_n)
        return self._planner

    def offload_stall_s(self, arch: str, op_name: str, steps: int,
                        interval, mode: str = "drift") -> float:
        """Modeled residual refresh stall one batch of this configuration
        pays with offload on (0.0 when offload is off or the mode writes
        no checkpoints); charged on the virtual clock."""
        if (self._offload_store is None
                or mode not in servable_lib.MONITORED_MODES):
            return 0.0
        if interval == "auto":
            interval = self.auto_rollback_interval(arch, op_name, steps)
        key = (arch, op_name, steps, int(interval))
        cached = self._stall_memo.get(key)
        if cached is None:
            op = dvfs_lib.OP_BY_NAME.get(op_name, dvfs_lib.NOMINAL)
            cached = self._stall_memo[key] = \
                self._planner_for().residual_stall_s(
                    self._full_cfg(arch), op, steps, self.batcher.bucket,
                    int(interval))
        return cached

    @property
    def offload_store(self) -> Optional[OffloadStore]:
        """The engine's checkpoint-offload store, or None when offload is
        off: the handle for reading commit stats or driving a restore."""
        return self._offload_store

    def _offload_for(self, key: SamplerKey) -> Optional[OffloadStore]:
        """This batch's offload store, or None: only monitored modes write
        rollback checkpoints worth offloading."""
        if (self._offload_store is None
                or key.mode not in servable_lib.MONITORED_MODES):
            return None
        # host refresh traffic is DRAM traffic in the paper's accounting:
        # commit/restore spans carry the joules they moved
        self._offload_store.energy_per_byte_j = \
            self._energy_model_for().e_dram_pj_per_byte * 1e-12
        return self._offload_store

    def window_energy_per_step_j(self, key: SamplerKey) -> float:
        """Prospective per-computed-step energy of one batch of this
        configuration (recovery traffic, unknown mid-flight, charged
        zero), for window and replay spans; the billed ledger lands at
        finalize."""
        memo = (key.arch, key.op, key.steps, key.mode, key.precision,
                key.taylorseer, key.rollback_interval, key.bucket)
        cached = self._window_j_memo.get(memo)
        if cached is None:
            op = dvfs_lib.OP_BY_NAME.get(key.op, dvfs_lib.NOMINAL)
            protected = key.mode in servable_lib.MONITORED_MODES
            rc = energy.RunConfig(
                num_steps=key.steps, nominal_steps=self.nominal_steps,
                aggressive=op,
                ckpt_interval=(key.rollback_interval if protected
                               else 10 ** 9),
                abft_enabled=protected,
                taylorseer_interval=3 if key.taylorseer else 0,
                body_bits=quant_lib.get_plan(key.precision).body_bits)
            cost = energy.run_cost(self._full_cfg(key.arch), rc,
                                   batch=key.bucket,
                                   em=self._energy_model_for())
            n = max(int(cost.get("n_computed_steps", key.steps)), 1)
            cached = self._window_j_memo[memo] = cost["energy_j"] / n
        return cached

    def _window_energy_delta_j(self, done_steps: int) -> float:
        """Joules of the window that just completed: the steps finished
        since the last window tap times the batch's per-step estimate."""
        delta = max(int(done_steps) - self._window_prev_steps, 0)
        self._window_prev_steps = int(done_steps)
        return delta * self._window_step_j

    def _on_stream_window(self, done_steps: int) -> None:
        """Sampler window tap: the telemetry window counter and a window
        span, for batches the reference streams; host-side only."""
        if not self._stream_taps:
            return
        self.telemetry.on_stream_window(done_steps)
        self.tracer.on_window(done_steps,
                              energy_j=self._window_energy_delta_j(
                                  done_steps))

    def _on_compile(self, key: SamplerKey, elapsed_s: float) -> None:
        """Sampler-cache miss tap: a compile span with the build's host
        time. ``stream`` is the reference's key field, 0 here: the port
        builds one sampler per configuration, streamed or not."""
        self.tracer.on_compile(elapsed_s, arch=key.arch, mode=key.mode,
                               op=key.op, steps=key.steps, stream=0,
                               bucket=key.bucket)

    def _offload_on_carry(self, done_steps: int, carry) -> None:
        """Sampler window tap: forwards the carry to the batch's bound
        offload store; a no-op unless the servable bound one."""
        store = self._active_offload
        if store is not None:
            store.on_window(done_steps, carry)

    # ------------------------------------------------------------ helpers
    def params_for(self, arch: str, smoke: bool):
        """The cached params of (arch, smoke), built on first use from the
        base seed (crc32, not ``hash``: stable across processes)."""
        k = (arch, smoke)
        if k not in self._params:
            cfg = configs.get_config(arch, smoke=smoke)
            tag = zlib.crc32(f"{arch}:{smoke}".encode()) & 0x7FFFFFFF
            self._params[k] = self.servable_for(arch).init_params(
                cfg, fault.mix64(self.base_seed, tag), self.device)
        return self._params[k]

    def set_params(self, arch: str, smoke: bool, params) -> None:
        """Put ``params`` into the params cache for (arch, smoke)."""
        self._params[(arch, smoke)] = params

    def _energy_model_for(self) -> energy.EnergyModel:
        if self._energy_model is None:
            self._energy_model = energy.calibrate()
        return self._energy_model

    def _full_cfg(self, arch: str):
        """The full-width config the perfmodel prices (smoke runs bill as
        the model they stand in for, as in the reference)."""
        return configs.get_config(arch)

    # ---------------------------------------------------------- one batch
    def _prepare_batch(self, mb: MicroBatch) -> _BatchCtx:
        key = mb.key
        batch_index = self._batch_counter
        self._batch_counter += 1
        self.stats.batches += 1
        self.stats.padded_slots += mb.n_pad
        model_cfg = configs.get_config(key.arch, smoke=key.smoke)
        live_seeds = [r.seed for r in mb.requests]
        padded_seeds = tuple(live_seeds + [live_seeds[-1]] * mb.n_pad)
        # queue_wait spans per member and the batch_assembly span; the
        # window/offload/detect spans until the next batch attach to it
        self.tracer.begin_batch(batch_index,
                                [r.request_id for r in mb.requests],
                                self.clock_s, arch=key.arch, mode=key.mode,
                                op=key.op, steps=key.steps,
                                bucket=key.bucket, n_live=len(mb.requests),
                                n_pad=mb.n_pad)
        self._window_prev_steps = 0
        self._window_step_j = self.window_energy_per_step_j(key)
        return _BatchCtx(
            batch_index=batch_index,
            params=self.params_for(key.arch, key.smoke),
            padded_seeds=padded_seeds,
            inputs=self.servable_for(key.arch).batch_inputs(
                model_cfg, list(padded_seeds)),
            flip_source=self.flip_source_factory(batch_index))

    def _run_batch(self, mb: MicroBatch) -> List[RequestResult]:
        ctx = self._prepare_batch(mb)
        out = self.servable_for(mb.key.arch).execute(mb, ctx)
        return self._finish_batch(mb, ctx, out)

    def _run_batch_stream(self, mb: MicroBatch, preview_interval: int):
        """Streaming twin of ``_run_batch``: the servable's previews, then
        the same accounting as the one-shot path. Paradigms without
        previews (autoregressive) raise."""
        ctx = self._prepare_batch(mb)
        out = None
        for ev in self.servable_for(mb.key.arch).execute_stream(
                mb, ctx, preview_interval):
            if isinstance(ev, tuple) and ev and ev[0] == "final":
                out = ev[1]
            else:
                yield ev
        yield from self._finish_batch(mb, ctx, out)

    def _finish_batch(self, mb: MicroBatch, ctx: _BatchCtx,
                      out) -> List[RequestResult]:
        key = mb.key
        sv = self.servable_for(key.arch)
        protected = key.mode in servable_lib.MONITORED_MODES
        if protected:
            self.monitor = out.monitor   # Sec 5.1 carry-over across batches
        outcome = sv.finalize(mb, ctx, out)
        mon_ber = float(self.monitor.ema_ber)
        mon_idx = int(self.monitor.op_index)

        # perfmodel attribution: the bucket priced once, its ledger shared
        # evenly by the live requests (padding lands on them)
        em = self._energy_model_for()
        full = self._full_cfg(key.arch)
        n_live = len(mb.requests)
        bcost = energy.run_cost(full, outcome.rc, batch=key.bucket, em=em)
        cost = energy.per_request_cost(full, outcome.rc, batch=key.bucket,
                                       n_live=n_live, em=em, cost=bcost)
        base = energy.per_request_cost(full, energy.baseline_rc(key.steps),
                                       batch=key.bucket, n_live=n_live,
                                       em=em)
        verify_cost(cost)          # the ledger every result shares
        # every request completes when the batch's modeled latency has
        # passed, plus, with offload on, the planner's residual refresh
        # stall (the part of the host offload the next window's compute
        # could not hide)
        stall_s = self.offload_stall_s(key.arch, key.op or "nominal",
                                       key.steps, key.rollback_interval,
                                       key.mode)
        batch_latency_s = cost["latency_s"] + stall_s
        self.clock_s += batch_latency_s
        completed_at = self.clock_s
        results = []
        for slot, req in enumerate(mb.requests):
            missed = (req.absolute_deadline_s is not None
                      and completed_at > req.absolute_deadline_s + 1e-9)
            self.stats.deadline_misses += int(missed)
            results.append(RequestResult(
                request_id=req.request_id, batch_index=ctx.batch_index,
                bucket_size=key.bucket, op=key.op or "nominal",
                mode=key.mode, steps=key.steps, taylorseer=key.taylorseer,
                precision=key.precision,
                batch_corrected_elems=outcome.corrected,
                n_model_evals=outcome.n_model_evals,
                energy_j=cost["energy_j"],
                energy_breakdown=cost["breakdown"],
                latency_s=batch_latency_s,
                baseline_energy_j=base["energy_j"],
                baseline_latency_s=base["latency_s"], monitor_ber=mon_ber,
                monitor_op_index=mon_idx, priority=req.priority,
                deadline_s=req.deadline_s, completed_at_s=completed_at,
                queue_wait_s=max(completed_at - req.submitted_at_s
                                 - batch_latency_s, 0.0),
                deadline_missed=missed, detect_heatmap=outcome.heatmap,
                detect_heatmap_blocks=outcome.heatmap_blocks,
                **outcome.per_slot[slot]))
        # telemetry: metrics, latency history, energy ledger, SLO, and for
        # monitored modes one guardband observation of the batch
        self.telemetry.on_batch(
            key=key, n_live=n_live, n_pad=mb.n_pad,
            latency_s=batch_latency_s, ema_ber=mon_ber, op_index=mon_idx,
            corrected=outcome.corrected, n_words=outcome.n_words,
            monitored=protected, clock_s=self.clock_s,
            queue_depth=len(self.queue), results=results,
            energy_breakdown=bcost["breakdown"])
        if ctx.offload_delta is not None:
            self.telemetry.on_offload(ctx.offload_delta,
                                      interval=key.rollback_interval,
                                      stall_s=stall_s)
        detect_attrs = None
        if outcome.heatmap is not None:
            self.telemetry.on_heatmap(outcome.heatmap,
                                      outcome.heatmap_blocks)
            detect_attrs = dict(heatmap=outcome.heatmap,
                                blocks=outcome.heatmap_blocks,
                                corrected=outcome.corrected)
        self.tracer.finish_batch(self.clock_s, detect_attrs=detect_attrs,
                                 latency_s=batch_latency_s,
                                 energy_j=cost["energy_j"],
                                 energy_breakdown=dict(bcost["breakdown"]),
                                 stall_s=stall_s, mode=key.mode,
                                 op=key.op or "nominal",
                                 n_model_evals=outcome.n_model_evals)
        return results
