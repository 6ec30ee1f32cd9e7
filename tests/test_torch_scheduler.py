"""The port's deadline scheduler and Pareto frontier against the JAX
package's, and the slice as a whole.

* frontier: ``FrontierBuilder``'s enumeration and Pareto set on the
  full-width ``dit-xl-512`` config over a grid of requested steps,
  buckets, modes and refresh intervals, equal with ``==`` and in the same
  order, and ``python -m repro_torch.serving.frontier``'s output equal to
  the reference CLI's;
* scheduler: the same submission stream through both packages'
  ``DeadlineScheduler`` over stub samplers (as ``tests/test_scheduler.py``
  stubs the reference's): rejections, ``escalated-op``, step trims,
  frontier rewrites under each objective, a projected miss, starvation
  aging and learned-latency projections. ``Admission`` records, stats,
  the clock, every result's knobs, queue wait and deadline miss, the
  masked ``/metrics`` text and the spans equal;
* the whole slice: the SMOKE DiT, 3 steps, bucket 2, 4 requests through
  ``DeadlineScheduler`` with telemetry and the recorder on, the JAX
  engine run once in a module fixture and the port's engine fed the same
  params, latents and flip masks (``jax_replay_factory``). Admissions,
  masked ``/metrics``, the SLO snapshot, the spans (kinds, order, virtual
  times, every attr; wall fields dropped) and the heatmaps are equal
  (the samples carrying the monitor's EMA within two f32 ulps, see
  ``test_torch_telemetry``); latents within the 1e-4 that
  ``test_slice_matches_jax_engine`` states.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import dvfs as jdvfs
from repro.diffusion import sampler as jsampler
from repro.serving import DeadlineScheduler as JScheduler
from repro.serving import DriftServeEngine as JaxEngine
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro.serving import frontier as jfrontier
from repro_torch import configs
from repro_torch.core import dvfs
from repro_torch.diffusion.sampler import SampleOutput, StreamEvent
from repro_torch.models import dit
from repro_torch.perfmodel import energy
from repro_torch.serving import (DeadlineScheduler, DriftServeEngine,
                                 EngineTelemetry, SchedulerConfig)
from repro_torch.serving import frontier as tfrontier

from test_torch_core import jax_replay_factory
from test_torch_dit import perturbed_jax_params
from test_torch_telemetry import (assert_metrics_match, assert_slo_match,
                                  mask_metrics)

ARCH = "dit-xl-512"


def span_view(tracer):
    """Every span with its wall-clock fields dropped: (name, kind, ids,
    batch, virtual t0 and t1, attrs)."""
    return [(s.name, s.kind, s.request_ids, s.batch_index, s.t0_virtual_s,
             s.t1_virtual_s, s.attrs) for s in tracer.spans()]


def asdicts(xs):
    return [dataclasses.asdict(x) for x in xs]


# --------------------------------------------------------------- frontier
@pytest.mark.parametrize("steps,bucket,mode,interval", [
    (3, 1, "drift", 10), (10, 2, "drift", 10), (10, 2, "drift", 2),
    (10, 4, "clean", 10), (20, 2, "drift", 5)])
def test_frontier_points_equal(steps, bucket, mode, interval):
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    tb, jb = tfrontier.FrontierBuilder(), jfrontier.FrontierBuilder()
    full = tb.enumerate(cfg, steps, bucket, mode, interval)
    assert asdicts(full) == asdicts(jb.enumerate(jcfg, steps, bucket, mode,
                                                 interval))
    front = tb.frontier(cfg, steps, bucket, mode, interval)
    assert asdicts(front) == asdicts(jb.frontier(jcfg, steps, bucket, mode,
                                                 interval))
    assert asdicts(front) == asdicts(tfrontier.pareto_front(full))
    assert 1 < len(front) < len(full)
    assert tb.frontier(cfg, steps, bucket, mode, interval) is front  # memo
    p, q = full[0], full[-1]
    assert tfrontier.dominates(p, q) == jfrontier.dominates(p, q)


def test_frontier_quality_proxy_equal():
    from repro.core import quant as jquant
    from repro_torch.core import quant
    for op in tfrontier.FRONTIER_OPS:
        jop = {o.name: o for o in jfrontier.FRONTIER_OPS}[op.name]
        for name, plan in quant.PRECISION_PLANS.items():
            for ts in (False, True):
                for steps in (1, 4, 9, 10):
                    assert tfrontier.quality_proxy(
                        steps, 10, plan, ts, op) == jfrontier.quality_proxy(
                        steps, 10, jquant.PRECISION_PLANS[name], ts, jop)


@pytest.mark.parametrize("extra", [[], ["--json"],
                                   ["--steps", "6", "--bucket", "4"]])
def test_frontier_cli_output_equal(extra, monkeypatch, capsys):
    out = []
    for mod, prog in ((jfrontier, "repro"), (tfrontier, "repro_torch")):
        monkeypatch.setattr(sys, "argv", [prog] + extra)
        mod._main()
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] and "frontier" in out[0]


# ------------------------------------------------------ scheduler (stubs)
def _port_stub(key, model_cfg, scfg):
    def run(params, flip_source, latents, cond, monitor0, window):
        n = scfg.num_sample_steps
        for done in range(window, n, window):
            yield StreamEvent(step=done, latents=latents)
        mon = dvfs.BerMonitorState(monitor0.ema_ber, monitor0.op_index,
                                   monitor0.n_updates + 1)
        yield SampleOutput(latents, mon, torch.tensor(0), n)
    return run


def _jax_stub(key, model_cfg, scfg, on_trace):
    """``tests/test_scheduler.py``'s echo sampler."""
    on_trace()

    def output(latents, monitor0):
        mon = jdvfs.BerMonitorState(monitor0.ema_ber, monitor0.op_index,
                                    monitor0.n_updates + 1)
        return jsampler.SampleOutput(latents, mon, jnp.int32(0),
                                     jnp.int32(scfg.num_sample_steps))
    if not key.stream:
        return lambda params, rng, latents, cond, text, monitor0: \
            output(latents, monitor0)

    def run_stream(params, rng, latents, cond, text, monitor0):
        for done in range(key.stream, scfg.num_sample_steps, key.stream):
            yield jsampler.StreamEvent(step=done, latents=latents)
        yield output(latents, monitor0)
    return run_stream


def _stub_pair(bucket, cfg_kw):
    """(reference, port) schedulers over stub engines, the port's fed the
    reference's latents."""
    jeng = JaxEngine(arch=ARCH, smoke=True, bucket=bucket,
                     sampler_factory=_jax_stub)
    jsv = jeng.servable_for(ARCH)
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    teng = DriftServeEngine(arch=ARCH, smoke=True, bucket=bucket,
                            device="cpu", sampler_factory=_port_stub)

    def inputs(cfg, seeds):
        lat, cond, _ = jsv.batch_inputs(jcfg, list(seeds))
        return (torch.from_numpy(np.array(lat)),
                torch.from_numpy(np.array(cond)).long())
    teng.servable.batch_inputs = inputs
    return (JScheduler(jeng, JSchedulerConfig(**cfg_kw)),
            DeadlineScheduler(teng, SchedulerConfig(**cfg_kw)))


def _stream(js):
    """The submission stream, with deadlines and budgets derived from the
    reference scheduler's own projections."""
    uv10 = js.batch_latency_s(ARCH, "undervolt", 10)
    oc10 = js.batch_latency_s(ARCH, "overclock", 10)
    oc4 = js.batch_latency_s(ARCH, "overclock", 4)
    pts = js.frontier_builder().frontier(
        js.engine._full_cfg(ARCH), 10, js.engine.batcher.bucket)
    mid_e = sorted(p.energy_j for p in pts)[len(pts) // 2]
    return [
        dict(steps=10, op="undervolt", priority="background", seed=0),
        dict(steps=10, op="undervolt", priority="background", seed=1),
        dict(steps=10, op="undervolt", priority="interactive",
             deadline_s=(uv10 + oc10) / 2, seed=2),
        dict(steps=10, op="undervolt", priority="interactive",
             deadline_s=oc10 + (oc10 + oc4) / 2, seed=3),
        dict(steps=10, op="undervolt", priority="interactive",
             deadline_s=1e-4, seed=4),
        dict(steps=10, op="auto", step_budget=5, seed=5),
        dict(steps=10, op="undervolt", energy_budget_j=mid_e, seed=6),
        dict(steps=10, op="undervolt", quality_floor=0.9, seed=7),
        dict(steps=10, op="undervolt", energy_budget_j=mid_e,
             deadline_s=3 * uv10, seed=8),
        dict(steps=10, op="undervolt", quality_floor=0.999999,
             energy_budget_j=1e-6, seed=9),
        dict(steps=10, op="undervolt", priority="urgent", seed=10),
        dict(arch="olmo-1b", steps=4, mode="stat_abft", quality_floor=0.5,
             seed=11),
    ]


def _submit_all(sched, stream):
    out = []
    for fields in stream:
        try:
            out.append(dataclasses.asdict(sched.submit(**fields)))
        except ValueError as exc:
            out.append(("ValueError", type(exc).__name__))
    return out


@pytest.mark.parametrize("bucket,cfg_kw", [
    (2, {}), (1, dict(age_s=0.3)), (2, dict(reject_hopeless=False)),
    (1, dict(use_learned_latency=False, min_steps=6))])
def test_scheduler_decisions_match_jax(bucket, cfg_kw):
    """Two rounds of the stream (the second priced by the learned
    estimator once the first has served): every decision, the clock,
    every result and the telemetry and trace surfaces equal."""
    js, ts = _stub_pair(bucket, cfg_kw)
    stream = _stream(js)
    assert _stream(ts) == stream             # prices the same, both sides
    for _ in range(2):
        got, want = _submit_all(ts, stream), _submit_all(js, stream)
        assert got == want
        tres, jres = ts.run(), js.run()
        assert ts.engine.clock_s == js.engine.clock_s
        fields = ("request_id", "batch_index", "op", "steps", "precision",
                  "taylorseer", "priority", "deadline_s", "queue_wait_s",
                  "deadline_missed", "completed_at_s", "energy_j",
                  "latency_s", "mode")
        assert [[getattr(r, f) for f in fields] for r in tres] == \
            [[getattr(r, f) for f in fields] for r in jres]
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
    actions = {a["action"] for a in want if isinstance(a, dict)}
    assert {"as-requested", "escalated-op", "frontier"} <= actions
    assert actions & {"rejected", "projected-miss"}
    assert mask_metrics(ts.engine.telemetry.registry.expose()) == \
        mask_metrics(js.engine.telemetry.registry.expose())
    assert ts.engine.telemetry.slo_snapshot() == \
        js.engine.telemetry.slo_snapshot()
    assert ts.engine.stats.deadline_misses == js.engine.stats.deadline_misses
    # stub samplers: the reference builds one sampler per (key, stream)
    # and counts JAX traces; spans agree but for the compile spans
    drop = lambda v: [s for s in v if s[1] != "compile"]    # noqa: E731
    assert drop(span_view(ts.engine.tracer)) == \
        drop(span_view(js.engine.tracer))


def test_starvation_aging_promotes_background():
    """With ``age_s`` short, a background request overtakes interactive
    ones queued after it once it has aged, on both sides alike."""
    js, ts = _stub_pair(1, dict(age_s=0.25))
    stream = [dict(steps=10, op="undervolt", priority="background", seed=0)]
    stream += [dict(steps=10, op="undervolt", priority="interactive",
                    seed=i) for i in range(1, 8)]
    for s in (js, ts):
        for f in stream:
            s.submit(**f)
    order = [[r.batch_index for r in s.run()] for s in (js, ts)]
    assert order[0] == order[1]
    assert 0 < order[1][0] < len(stream) - 1      # not first, not last


def test_auto_op_prices_through_guardband_floor():
    """A widened guardband floors ``op="auto"``: the engine resolves it
    and the scheduler prices it at the floored point."""
    js, ts = _stub_pair(1, {})
    for s in (js, ts):
        s.engine.telemetry.controller.guard_index = 3
    assert ts.engine.auto_op_name() == js.engine.auto_op_name() == \
        dvfs.OP_LADDER[3].name
    assert ts._concrete_op("auto") == js._concrete_op("auto")
    assert ts.batch_latency_s(ARCH, "auto", 10) == \
        js.batch_latency_s(ARCH, "auto", 10)
    off = DriftServeEngine(device="cpu",
                           telemetry=EngineTelemetry(enabled=False))
    off.telemetry.controller = ts.engine.telemetry.controller
    assert off.auto_op_index() == 0          # disabled: no floor


# ---------------------------------------------------------- whole slice
SLICE_STEPS = 3


def _slice_requests(js):
    """2 background requests at undervolt, 2 interactive ones whose
    deadlines force overclock: between the two points' projections, the
    second's behind the first's projected overclock batch."""
    uv = js.batch_latency_s(ARCH, "undervolt", SLICE_STEPS)
    oc = js.batch_latency_s(ARCH, "overclock", SLICE_STEPS)
    dl = (uv + oc) / 2
    return [dict(steps=SLICE_STEPS, op="undervolt", priority="background",
                 seed=0),
            dict(steps=SLICE_STEPS, op="undervolt", priority="background",
                 seed=1),
            dict(steps=SLICE_STEPS, op="undervolt", priority="interactive",
                 deadline_s=dl, seed=2),
            dict(steps=SLICE_STEPS, op="undervolt", priority="interactive",
                 deadline_s=oc + dl, seed=3)]


@pytest.fixture(scope="module")
def jax_slice():
    eng = JaxEngine(arch=ARCH, smoke=True, bucket=2, base_seed=0)
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    np_params = perturbed_jax_params(jcfg, seed=5)
    eng._params[(ARCH, True)] = jax.tree.map(jnp.asarray, np_params)
    sched = JScheduler(eng)
    requests = _slice_requests(sched)
    adms = [sched.submit(**f) for f in requests]
    return sched, np_params, requests, adms, sched.run()


def port_slice_engine(np_params, jsv, **kw):
    """The port's engine fed the reference's params, its latents for any
    seeds, and its flip masks."""
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    eng = DriftServeEngine(arch=ARCH, smoke=True, bucket=2, base_seed=0,
                           device="cpu",
                           flip_source_factory=jax_replay_factory(0), **kw)
    eng.set_params(ARCH, True, dit.params_from_jax(np_params))

    def inputs(cfg, seeds):
        lat, cond, _ = jsv.batch_inputs(jcfg, list(seeds))
        return (torch.from_numpy(np.array(lat)),
                torch.from_numpy(np.array(cond)).long())
    eng.servable.batch_inputs = inputs
    return eng


def test_slice_through_scheduler_matches_jax_engine(jax_slice):
    js, np_params, jrequests, jadms, want = jax_slice
    eng = port_slice_engine(np_params, js.engine.servable_for(ARCH))
    ts = DeadlineScheduler(eng)
    requests = _slice_requests(ts)
    assert requests == jrequests
    adms = [ts.submit(**f) for f in requests]
    assert asdicts(adms) == asdicts(jadms)
    assert [a.action for a in adms] == ["as-requested"] * 2 + \
        ["escalated-op"] * 2
    got = ts.run()
    for g, w in zip(got, want):
        assert (g.request_id, g.op, g.steps, g.batch_index, g.priority) == \
            (w.request_id, w.op, w.steps, w.batch_index, w.priority)
        assert (g.queue_wait_s, g.deadline_missed, g.completed_at_s) == \
            (w.queue_wait_s, w.deadline_missed, w.completed_at_s)
        assert g.batch_corrected_elems == w.batch_corrected_elems > 0
        assert g.detect_heatmap == w.detect_heatmap
        assert g.detect_heatmap_blocks == w.detect_heatmap_blocks
        assert sum(map(sum, g.detect_heatmap)) > 0
        assert g.energy_breakdown == w.energy_breakdown
        np.testing.assert_allclose(g.latents.numpy(), np.asarray(w.latents),
                                   atol=1e-4, rtol=0)
    assert [r.op for r in got] == ["undervolt"] * 2 + ["overclock"] * 2
    assert got[2].batch_index == 0            # interactive formed first
    assert eng.clock_s == js.engine.clock_s
    assert_metrics_match(eng.telemetry.registry.expose(),
                         js.engine.telemetry.registry.expose())
    assert_slo_match(eng.telemetry.slo_snapshot(),
                     js.engine.telemetry.slo_snapshot())
    assert span_view(eng.tracer) == span_view(js.engine.tracer)
    assert eng.telemetry.controller.guard_index == \
        js.engine.telemetry.controller.guard_index
    assert energy.ledger_total(got[0].energy_breakdown) == got[0].energy_j
