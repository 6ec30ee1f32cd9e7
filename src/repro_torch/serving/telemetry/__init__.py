"""Telemetry & online adaptation for the DRIFT serving stack.

Counterpart of ``repro.serving.telemetry``: the same registry, metric
families (names, help text, labels), estimator, guardband controller,
energy ledger and SLO tracker, with the port's imports. Every hook
reads host scalars the engine already holds after a batch (the
monitor's EMA, the corrected count, the heatmap moved to the host
once per batch), so telemetry adds no device op and no synchronize.

The serving engine runs the DRIFT loop -- detect errors cheaply, adapt
the operating point, correct only what matters -- but before this
subsystem it ran *open loop* at the serving layer: worst-case perfmodel
latencies for admission, a DVFS ladder that never learned from the
detection counts it collects, previews that died at a Python generator.
This package is the observe -> learn -> adapt layer:

===================  =====================================================
module               role
===================  =====================================================
``metrics``          counters / gauges / histograms + Prometheus text
                     exposition (the ``/metrics`` payload)
``history``          served-batch history + learned per-(arch, op, steps,
                     bucket) latency estimator the scheduler consults,
                     with perfmodel fallback on empty history
``controller``       adaptive BER guardband: widens/tightens the floor
                     under the auto-op ladder from the monitor's
                     post-batch detection statistics, with hysteresis
``http``             stdlib HTTP front-end: ``/metrics``, ``/healthz``,
                     and an SSE ``/events`` endpoint relaying
                     ``PreviewEvent`` streams
===================  =====================================================

``EngineTelemetry`` (below) bundles the three host-side parts into the
single object the engine owns (``engine.telemetry``); every tap is a
plain Python call on the batch boundary -- nothing runs on the card, so
telemetry never changes what a given configuration *computes*. It can
change which configuration runs, on purpose: the guardband floors
``op="auto"`` resolution, and learned estimates steer admission once
history exists. With ``enabled=False`` (or for workloads that name
explicit operating points, before any history/guardband effect) serving
is bit-identical to the telemetry-free engine.

Metric catalog, controller state machine, and the SSE wire format:
docs/telemetry.md.
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.serving.telemetry.controller import (
    GuardbandConfig, GuardbandController, GuardbandStats)
from repro_torch.serving.telemetry.energy import (ENERGY_COMPONENTS,
                                                  EnergyLedger, verify_cost)
from repro_torch.serving.telemetry.history import (BatchObservation,
                                                   LatencyEstimator,
                                                   LatencyKey)
from repro_torch.serving.telemetry.metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, merge_labeled_expositions)
from repro_torch.serving.telemetry.slo import (OBJECTIVES, SLOConfig,
                                               SLOTracker)
from repro_torch.version import __version__ as _build_version

__all__ = [
    "EngineTelemetry",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "merge_labeled_expositions",
    "LatencyEstimator", "BatchObservation", "LatencyKey",
    "GuardbandController", "GuardbandConfig", "GuardbandStats",
    "EnergyLedger", "ENERGY_COMPONENTS", "verify_cost",
    "SLOTracker", "SLOConfig", "OBJECTIVES",
    "TelemetryHTTPServer", "serve_telemetry", "aggregate_metrics",
]

# Buckets for the per-request energy histogram: smoke archs bill
# millijoules, full DiT-XL-512 samples land around 4-6 J, and fleets
# budget tens of joules -- log-spaced to cover all three regimes.
REQUEST_ENERGY_BUCKETS_J = (0.001, 0.003, 0.01, 0.03, 0.1, 0.3,
                            1.0, 3.0, 10.0, 30.0, 100.0)


class EngineTelemetry:
    """The engine's telemetry bundle: registry + estimator + controller.

    Construction is cheap and side-effect-free; the engine calls
    :meth:`bind` once with its monitor target BER, which instantiates the
    guardband controller (unless ``guardband=False``) and registers the
    metric families. ``enabled=False`` turns every hook into a no-op and
    keeps the estimator/controller absent, so the scheduler's perfmodel
    fallback and the engine's ladder resolution behave exactly as without
    telemetry (``--no-telemetry`` on the CLIs builds this).
    """

    def __init__(self, enabled: bool = True,
                 registry: Optional[MetricsRegistry] = None,
                 estimator: Optional[LatencyEstimator] = None,
                 controller: Optional[GuardbandController] = None,
                 guardband: bool = True,
                 guardband_config: Optional[GuardbandConfig] = None,
                 slo_config: Optional[SLOConfig] = None) -> None:
        self.enabled = enabled
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        self.estimator = (estimator if estimator is not None else
                          LatencyEstimator()) if enabled else None
        self.controller = controller
        self._want_guardband = guardband and enabled
        self._guardband_config = guardband_config
        self._slo_config = slo_config
        # Energy ledger + SLO tracker, built at bind() (the tracker needs
        # the engine's target BER). None while disabled/unbound.
        self.ledger: Optional[EnergyLedger] = None
        self.slo: Optional[SLOTracker] = None
        self._bound = False

    @classmethod
    def disabled(cls) -> "EngineTelemetry":
        return cls(enabled=False)

    # ------------------------------------------------------------ binding
    def bind(self, target_ber: float) -> "EngineTelemetry":
        """Engine attach point: build the controller against the engine's
        monitor target and register the metric families. Idempotent."""
        if self._bound or not self.enabled:
            self._bound = True
            return self
        self._bound = True
        if self._want_guardband and self.controller is None:
            self.controller = GuardbandController(
                target_ber, self._guardband_config)
        r = self.registry
        self._m_submitted = r.counter(
            "drift_requests_submitted_total",
            "Requests accepted into the engine queue")
        self._m_served = r.counter(
            "drift_requests_served_total",
            "Requests completed with a RequestResult")
        self._m_batches = r.counter(
            "drift_batches_total", "Micro-batches served",
            label_names=("mode", "op"))
        self._m_padded = r.counter(
            "drift_padded_slots_total", "Bucket slots filled with padding")
        self._m_previews = r.counter(
            "drift_preview_events_total", "Streamed latent previews yielded")
        self._m_windows = r.counter(
            "drift_stream_windows_total",
            "Jitted streaming windows executed by the sampler")
        self._m_misses = r.counter(
            "drift_deadline_misses_total",
            "Requests completed past their virtual-clock deadline")
        self._m_corrected = r.counter(
            "drift_rollback_corrected_elems_total",
            "Rollback-corrected tensor elements (whole batches)")
        self._m_batch_lat = r.histogram(
            "drift_batch_latency_seconds",
            "Modeled (virtual-clock) latency per served micro-batch",
            label_names=("op",))
        self._m_queue_wait = r.histogram(
            "drift_queue_wait_seconds",
            "Virtual-clock wait between submission and batch start")
        self._m_clock = r.gauge(
            "drift_clock_seconds", "Engine virtual clock")
        self._m_depth = r.gauge(
            "drift_queue_depth", "Pending requests after the last batch")
        self._m_ema = r.gauge(
            "drift_monitor_ema_ber", "BER monitor EMA after the last batch")
        self._m_ladder = r.gauge(
            "drift_monitor_ladder_index",
            "BER monitor ladder index after the last batch")
        self._m_guard = r.gauge(
            "drift_guardband_index", "Guardband controller ladder floor")
        self._m_widen = r.counter(
            "drift_guardband_widenings_total", "Guardband widen transitions")
        self._m_tighten = r.counter(
            "drift_guardband_tightenings_total",
            "Guardband re-tighten transitions")
        self._m_realized = r.gauge(
            "drift_realized_ber",
            "EWMA of the monitor's BER estimate per operating point",
            label_names=("op",))
        self._m_obs = r.counter(
            "drift_estimator_observations_total",
            "Served-batch latency observations folded into the estimator")
        self._m_est_keys = r.gauge(
            "drift_estimator_keys",
            "Distinct (arch, op, steps, bucket) latency models")
        self._m_admissions = r.counter(
            "drift_admissions_total", "Scheduler admission decisions",
            label_names=("action",))
        self._m_projection = r.counter(
            "drift_projection_source_total",
            "Latency source used for admission projections",
            label_names=("source",))
        self._m_frontier = r.counter(
            "drift_frontier_choices_total",
            "Frontier points selected by the scheduler's compute-optimal "
            "resolution", label_names=("objective",))
        self._m_frontier_size = r.gauge(
            "drift_frontier_size",
            "Pareto-frontier size of the last consulted (arch, bucket)")
        # checkpoint-offload subsystem (repro.serving.offload)
        self._m_off_commits = r.counter(
            "drift_offload_commits_total",
            "Checkpoint snapshots committed to the host offload store")
        self._m_off_skipped = r.counter(
            "drift_offload_skipped_total",
            "Refresh commits deferred by a BER detection spike")
        self._m_off_restores = r.counter(
            "drift_offload_restores_total",
            "Committed snapshots re-uploaded to device (rollback restore)")
        self._m_off_bytes = r.counter(
            "drift_offload_bytes_total",
            "Host bytes offloaded (tile-contiguous layout, padding incl.)")
        self._m_off_stall = r.counter(
            "drift_offload_stall_seconds_total",
            "Modeled residual refresh stall charged on the virtual clock")
        self._m_off_interval = r.gauge(
            "drift_offload_interval",
            "Rollback refresh interval of the last offloaded batch")
        # flight-recorder / forensics surfaces (repro.serving.trace)
        self._m_heatmap = r.counter(
            "drift_detect_heatmap_total",
            "ABFT detections bucketed by model site and timestep bin "
            "(the live analogue of DRIFT Figs 5-6)",
            label_names=("block", "step_bin"))
        self._m_rejections = r.counter(
            "drift_scheduler_rejections_total",
            "Requests the scheduler refused to enqueue",
            label_names=("reason",))
        self._m_build = r.gauge(
            "drift_build_info",
            "Constant 1; build metadata rides in the labels",
            label_names=("version", "paradigms"))
        self._m_build.labels(version=_build_version,
                             paradigms="diffusion,autoregressive").set(1.0)
        self._m_uptime = r.gauge(
            "drift_engine_uptime_seconds",
            "Wall seconds since this engine's telemetry was bound")
        self._t0_wall = time.monotonic()
        self._m_uptime.set(0.0)
        # energy ledger + SLO engine (docs/slo.md)
        self.ledger = EnergyLedger()
        self.slo = SLOTracker(target_ber, self._slo_config)
        self._slo_prev_breached = dict(self.slo.breached)
        self._m_energy = r.counter(
            "drift_energy_joules_total",
            "Billed joules by ledger component and operating point "
            "(component sums reconcile bitwise with billed energy_j)",
            label_names=("component", "op"))
        self._m_req_energy = r.histogram(
            "drift_request_energy_joules",
            "Billed energy per completed request (its share of the "
            "batch ledger)", buckets=REQUEST_ENERGY_BUCKETS_J)
        self._m_burn = r.gauge(
            "drift_slo_burn_rate",
            "Observed/target burn rate per SLO objective and window "
            "(virtual-clock windows; breach = both windows above the "
            "threshold)", label_names=("objective", "window"))
        self._m_slo_breaches = r.gauge(
            "drift_slo_breached",
            "1 while an SLO objective's fast AND slow windows both burn "
            "above threshold, else 0", label_names=("objective",))
        self._m_slo_breach_edges = r.counter(
            "drift_slo_breaches_total",
            "Breach onsets per SLO objective (ok->breached transitions)",
            label_names=("objective",))
        self._m_skew = r.gauge(
            "drift_clock_skew_ratio",
            "Virtual clock seconds per wall uptime second: how fast "
            "modeled-accelerator time runs relative to this host")
        return self

    # -------------------------------------------------------------- hooks
    # Every hook no-ops when disabled; the engine calls them
    # unconditionally so the serving loop stays branch-free.
    def on_submit(self) -> None:
        if self.enabled:
            self._m_submitted.inc()

    def on_batch(self, key, n_live: int, n_pad: int, latency_s: float,
                 ema_ber: float, op_index: int, corrected: int,
                 n_words: int, monitored: bool, clock_s: float,
                 queue_depth: int, results,
                 energy_breakdown=None) -> None:
        """One served micro-batch: metrics, history, energy ledger, SLO
        evaluation, and -- for monitored modes -- one guardband-controller
        observation. ``energy_breakdown`` is the BATCH-level component
        dict from ``perfmodel.energy.run_cost`` (each result additionally
        carries its own per-request share)."""
        if not self.enabled:
            return
        op_name = key.op or "nominal"
        self._m_batches.labels(mode=key.mode, op=op_name).inc()
        self._m_padded.inc(n_pad)
        self._m_served.inc(n_live)
        self._m_batch_lat.labels(op=op_name).observe(latency_s)
        self._m_clock.set(clock_s)
        self._m_depth.set(queue_depth)
        self._m_ema.set(ema_ber)
        self._m_ladder.set(op_index)
        self._m_corrected.inc(corrected)
        # One shared wall sample for uptime AND clock skew, so the two
        # gauges reconcile exactly: skew == clock_gauge / uptime_gauge
        # (tests/test_torch_telemetry.py pins this).
        wall = time.monotonic() - self._t0_wall
        self._m_uptime.set(wall)
        self._m_skew.set(clock_s / wall if wall > 0 else 0.0)
        if energy_breakdown is not None:
            self.ledger.charge_batch(op_name, energy_breakdown)
            for comp in ENERGY_COMPONENTS:
                j = energy_breakdown[comp]
                if j:
                    self._m_energy.labels(component=comp, op=op_name).inc(j)
        for res in results:
            self._m_queue_wait.observe(res.queue_wait_s)
            if res.deadline_missed:
                self._m_misses.inc()
            self.ledger.charge_request(res.energy_j)
            self._m_req_energy.observe(res.energy_j)
        # SLO engine: fold the batch in on the virtual clock, publish burn
        # rates, edge-count breach onsets, and hand the energy objective's
        # breach state to the guardband (its "run cheaper" floor input).
        self.slo.observe_batch(clock_s, ema_ber, monitored, results)
        for (obj, win), rate in self.slo.burn_rates().items():
            self._m_burn.labels(objective=obj, window=win).set(rate)
        for obj, breached in self.slo.breached.items():
            self._m_slo_breaches.labels(objective=obj).set(float(breached))
            if breached and not self._slo_prev_breached[obj]:
                self._m_slo_breach_edges.labels(objective=obj).inc()
        self._slo_prev_breached = dict(self.slo.breached)
        if self.controller is not None:
            self.controller.set_energy_slo_breach(self.slo.energy_breached)
        self.estimator.observe(BatchObservation(
            arch=key.arch, op=op_name, steps=key.steps, bucket=key.bucket,
            latency_s=latency_s, clock_s=clock_s,
            batch_index=results[0].batch_index if results else -1,
            mode=key.mode, taylorseer=key.taylorseer,
            rollback_interval=key.rollback_interval,
            precision=key.precision))
        self._m_obs.inc()
        self._m_est_keys.set(len(self.estimator))
        if monitored and self.controller is not None:
            self.controller.observe_batch(ema_ber, op_name,
                                          corrected_elems=corrected,
                                          n_words=n_words)
            self._m_guard.set(self.controller.guard_index)
            st = self.controller.stats
            self._sync_counter(self._m_widen, st.widenings)
            self._sync_counter(self._m_tighten, st.tightenings)
            self._m_realized.labels(op=op_name).set(
                self.controller.realized_ber[op_name])

    @staticmethod
    def _sync_counter(counter: Counter, target: float) -> None:
        delta = target - counter.value
        if delta > 0:
            counter.inc(delta)

    def on_preview(self) -> None:
        if self.enabled:
            self._m_previews.inc()

    def on_offload(self, delta, interval: int, stall_s: float) -> None:
        """One offload-enabled batch's store accounting: ``delta`` is the
        batch's ``OffloadStats`` delta (commits/skips/restores/bytes),
        ``stall_s`` the modeled residual stall the clock was charged."""
        if not self.enabled:
            return
        self._m_off_commits.inc(delta.commits)
        self._m_off_skipped.inc(delta.skipped)
        self._m_off_restores.inc(delta.restores)
        self._m_off_bytes.inc(delta.bytes_offloaded)
        self._m_off_stall.inc(stall_s)
        self._m_off_interval.set(interval)

    def on_stream_window(self, done_steps: int) -> None:
        """Sampler tap: fires once per completed streaming window
        (``sampler.sample_stream(on_window=...)``)."""
        if self.enabled:
            self._m_windows.inc()

    def on_admission(self, action: str) -> None:
        if self.enabled:
            self._m_admissions.labels(action=action).inc()

    def on_rejection(self, reason: str) -> None:
        """One scheduler refusal. ``reason``: "projected-miss" (deadline
        unreachable on the ladder) | "budget-infeasible" (frontier
        objective with no qualifying point) | "validation" (malformed
        request fields)."""
        if self.enabled:
            self._m_rejections.labels(reason=reason).inc()

    def on_heatmap(self, heatmap, blocks) -> None:
        """One monitored batch's binned detection heatmap: ``heatmap`` is
        the nested int tuple (sites, step_bins) from
        ``trace.heatmap.summarize``, ``blocks`` the matching site labels.
        Accumulated into ``drift_detect_heatmap_total{block, step_bin}``;
        zero cells are skipped so the exposition stays sparse."""
        if not self.enabled or heatmap is None:
            return
        for site, row in zip(blocks, heatmap):
            for b, count in enumerate(row):
                if count:
                    self._m_heatmap.labels(
                        block=site, step_bin=str(b)).inc(count)

    def on_projection(self, source: str) -> None:
        """source: "learned" | "perfmodel" -- which clock priced a
        scheduler projection."""
        if self.enabled:
            self._m_projection.labels(source=source).inc()

    def on_frontier_choice(self, objective: str, frontier_size: int) -> None:
        """One compute-optimal frontier selection by the scheduler.
        ``objective``: "min-energy" (deadline-constrained) |
        "min-latency" (quality-floor) | "max-quality" (budget-only)."""
        if self.enabled:
            self._m_frontier.labels(objective=objective).inc()
            self._m_frontier_size.set(frontier_size)

    # ------------------------------------------------------------ queries
    def slo_snapshot(self) -> Optional[dict]:
        """The ``GET /slo`` body (docs/slo.md), or None while telemetry is
        disabled/unbound."""
        if not self.enabled or self.slo is None:
            return None
        return self.slo.snapshot()

    def clamp_ladder_index(self, op_index: int) -> int:
        """Apply the guardband floor (identity when disabled/absent)."""
        if self.enabled and self.controller is not None:
            return self.controller.clamp(op_index)
        return int(op_index)

    def learned_latency_s(self, arch: str, op: str, steps: int,
                          bucket: int, **disc) -> Optional[float]:
        """Learned batch latency, or None (disabled / empty history).
        ``disc`` are the extra ``LatencyKey`` discriminators (mode,
        taylorseer, rollback_interval), defaulting to the standard drift
        configuration."""
        if not self.enabled or self.estimator is None:
            return None
        return self.estimator.estimate_s(arch, op, steps, bucket, **disc)


# Re-exported late: http imports request types, keep the cheap modules above
# importable without dragging the server in first.
from repro_torch.serving.telemetry.http import (  # noqa: E402
    TelemetryHTTPServer, aggregate_metrics, serve_telemetry)
