"""The port's flight recorder against the JAX package's.

The recorder, the heatmap helpers and the exporters are host code in both
packages: the same calls on each side give the same spans (wall-clock
fields dropped), the same bins and labels, and the same Chrome trace and
``request_tree`` once wall times and the version are masked. Engine
level: the SMOKE olmo-1b through ``DeadlineScheduler`` on both packages
with the same params, prompts and flip masks (the JAX engine run once in
a module fixture) records the same spans, replays included; the port's
offload commits and restores carry their bytes and modeled joules; a
rejected decision is recorded without a request id.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.serving import DeadlineScheduler as JScheduler
from repro.serving import DriftServeEngine as JaxEngine
from repro.serving import trace as jtrace
from repro.serving.ar import prompt_tokens as jprompt_tokens
from repro_torch.models import transformer
from repro_torch.perfmodel import energy
from repro_torch.serving import (DeadlineScheduler, DriftServeEngine,
                                 OffloadConfig)
from repro_torch.serving import trace as ttrace

from test_torch_core import jax_replay_factory
from test_torch_scheduler import span_view
from test_torch_telemetry import assert_metrics_match
from test_torch_transformer import lm_jax_params

LM = "olmo-1b"


def _drive_recorder(mod, capacity):
    rng = np.random.default_rng(capacity)
    rec = mod.FlightRecorder(capacity=capacity)
    rec.on_submit(0, 0.0, arch="a", priority="standard")
    rec.on_submit(1, 0.0, arch="a", priority="interactive")
    rec.record("admission", "admission", request_ids=(1,), t0_virtual_s=0.0,
               admitted=True, action="escalated-op")
    for b in range(3):
        rec.begin_batch(b, [b % 2], 0.1 * b, arch="a", n_live=1)
        rec.on_compile(0.5, arch="a", stream=0)
        for w in (2, 4):
            rec.on_window(w, energy_j=float(rng.random()))
        rec.on_offload("commit", 2, 0.01, nbytes=4096, energy_j=1e-3)
        rec.on_replay(1, 3, energy_j=0.5)
        rec.finish_batch(0.1 * b + 0.1, detect_attrs=dict(
            heatmap=((0, 1),), blocks=("all",), corrected=3),
            latency_s=0.1, mode="drift")
    return rec


@pytest.mark.parametrize("capacity", [4, 4096])
def test_recorder_spans_match(capacity):
    """The same taps on both recorders: span names, kinds, ids, batches,
    virtual times and attrs, the ring bound and drop count."""
    j, t = _drive_recorder(jtrace, capacity), _drive_recorder(ttrace,
                                                              capacity)
    assert span_view(t) == span_view(j)
    assert (t.recorded, t.dropped, len(t)) == (j.recorded, j.dropped, len(j))
    assert len(t) == min(capacity, t.recorded)
    for rid in (0, 1, 7):
        assert [s.to_dict()["kind"] for s in t.spans(rid)] == \
            [s.to_dict()["kind"] for s in j.spans(rid)]
    off = ttrace.FlightRecorder(enabled=False)
    off.on_submit(0, 0.0)
    off.begin_batch(0, [0], 0.0)
    off.finish_batch(1.0)
    assert len(off) == 0 and off.record("x", "submit") is None
    assert ttrace.SPAN_KINDS == jtrace.SPAN_KINDS


def _mask_wall(obj):
    """A Chrome trace or span tree with wall times and the version
    masked."""
    if isinstance(obj, dict):
        return {k: ("<wall>" if k in ("ts", "dur", "t0_wall_s", "t1_wall_s")
                    else "<v>" if k == "name" and isinstance(v, str)
                    and v.startswith("drift-serve ") else _mask_wall(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask_wall(v) for v in obj]
    return obj


def test_chrome_trace_and_request_tree_match():
    j, t = _drive_recorder(jtrace, 4096), _drive_recorder(ttrace, 4096)
    assert _mask_wall(ttrace.to_chrome_trace(t.spans())) == \
        _mask_wall(jtrace.to_chrome_trace(j.spans()))
    for rid in (0, 1):
        assert _mask_wall(ttrace.request_tree(t.spans(rid), rid)) == \
            _mask_wall(jtrace.request_tree(j.spans(rid), rid))


@pytest.mark.parametrize("steps,sites", [(1, 1), (3, 4), (10, 29), (7, 1)])
def test_heatmap_binning_matches(steps, sites):
    """``summarize`` of a torch tensor (int64, as the port's sampler
    gives it) equals the reference's of the int32 array."""
    heat = np.random.default_rng(steps).integers(0, 50, (steps, sites))
    got = ttrace.summarize(torch.from_numpy(heat))
    assert got == jtrace.summarize(jnp.asarray(heat, jnp.int32))
    assert ttrace.site_labels(sites) == jtrace.site_labels(sites)
    np.testing.assert_array_equal(ttrace.bin_heatmap(heat, 3),
                                  jtrace.bin_heatmap(heat, 3))
    assert ttrace.summarize(None) == (None, None)


# ------------------------------------------------------- olmo-1b, engines
def _lm_requests(sched):
    lat = sched.batch_latency_s(LM, "undervolt", 8)
    return [dict(arch=LM, steps=8, mode="stat_abft", op="undervolt",
                 rollback_interval=3, priority="background", seed=0),
            dict(arch=LM, steps=8, mode="stat_abft", op="undervolt",
                 rollback_interval=3, priority="interactive",
                 deadline_s=2 * lat, seed=1)]


@pytest.fixture(scope="module")
def jax_lm():
    jcfg = jconfigs.get_config(LM, smoke=True)
    np_params = lm_jax_params(jcfg)
    eng = JaxEngine(arch=LM, bucket=2, base_seed=0)
    eng._params[(LM, True)] = jax.tree.map(jnp.asarray, np_params)
    sched = JScheduler(eng)
    reqs = _lm_requests(sched)
    adms = [sched.submit(**f) for f in reqs]
    prompts = np.asarray(jprompt_tokens(jcfg, [0, 1]))
    return sched, np_params, prompts, reqs, adms, sched.run()


def test_lm_through_scheduler_spans_match(jax_lm):
    """Replay spans (one per rolled-back window), window spans with their
    joules, the detect span's single-site heatmap: the same records in
    the same order, and the same admission and metrics."""
    js, np_params, prompts, jreqs, jadms, want = jax_lm
    eng = DriftServeEngine(arch=LM, smoke=True, bucket=2, base_seed=0,
                           device="cpu",
                           flip_source_factory=jax_replay_factory(0))
    eng.set_params(LM, True, transformer.params_from_jax(np_params))
    eng.servable_for(LM).batch_inputs = lambda cfg, seeds: (
        torch.from_numpy(prompts.copy()),)
    ts = DeadlineScheduler(eng)
    reqs = _lm_requests(ts)
    assert reqs == jreqs
    adms = [ts.submit(**f) for f in reqs]
    assert [a.action for a in adms] == [a.action for a in jadms]
    got = ts.run()
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        assert (g.ar_rollbacks, g.detect_heatmap, g.detect_heatmap_blocks) \
            == (w.ar_rollbacks, w.detect_heatmap, w.detect_heatmap_blocks)
        assert (g.queue_wait_s, g.deadline_missed) == \
            (w.queue_wait_s, w.deadline_missed)
    kinds = [s[1] for s in span_view(eng.tracer)]
    assert kinds.count("replay") == got[0].ar_rollbacks >= 1
    assert got[0].detect_heatmap_blocks == ("all",)
    assert span_view(eng.tracer) == span_view(js.engine.tracer)
    assert_metrics_match(eng.telemetry.registry.expose(),
                         js.engine.telemetry.registry.expose())


# ------------------------------------------------------ offload, rejects
def test_offload_commit_and_restore_spans_carry_joules():
    """With offload on, every settled commit records an offload_commit
    span at its refresh step, with the bytes it moved and their modeled
    DRAM joules; ``restore()`` records an offload_restore span."""
    eng = DriftServeEngine(arch="dit-xl-512", smoke=True, bucket=2,
                           device="cpu", offload=OffloadConfig())
    for s in (0, 1):
        eng.submit(steps=5, mode="drift", op="undervolt", seed=s,
                   rollback_interval=2)
    eng.run()
    store = eng.offload_store
    commits = [s for s in eng.tracer.spans() if s.kind == "offload_commit"]
    assert [s.attrs["step"] for s in commits] == [0, 2, 4]
    per_byte = energy.calibrate().e_dram_pj_per_byte * 1e-12
    for s in commits:
        assert s.attrs["nbytes"] == store.committed_nbytes > 0
        assert s.attrs["energy_j"] == s.attrs["nbytes"] * per_byte
        assert s.batch_index == 0 and s.request_ids == (0, 1)
        assert s.t1_wall_s >= s.t0_wall_s
    store.restore()
    (restore,) = [s for s in eng.tracer.spans()
                  if s.kind == "offload_restore"]
    assert restore.attrs["step"] == 4
    assert restore.attrs["energy_j"] == store.committed_nbytes * per_byte
    kinds = [s.kind for s in eng.tracer.spans()]
    assert kinds.count("window") == 3          # offload drains in windows
    assert kinds.index("offload_commit") < kinds.index("finalize")


def test_rejected_decision_recorded_without_request_id():
    eng = DriftServeEngine(arch="dit-xl-512", smoke=True, bucket=1,
                           device="cpu")
    adm = DeadlineScheduler(eng).submit(steps=10, op="undervolt",
                                        deadline_s=1e-6, seed=0)
    assert not adm.admitted
    (span,) = eng.tracer.spans()
    assert span.kind == "admission" and span.request_ids == ()
    assert span.attrs["action"] == "rejected" and "deadline" in \
        span.attrs["reason"]
    with pytest.raises(ValueError):
        DeadlineScheduler(eng).submit(priority="urgent")
    assert eng.tracer.spans()[-1].attrs["reason"].startswith("validation")


def test_recorder_and_registry_keep_every_update_under_threads():
    """More threads than cores record spans and bump a counter and a
    histogram while another thread reads, with a short switch interval:
    nothing is lost (the locks guard every read-modify-write)."""
    import os
    import sys
    import threading

    from repro_torch.serving.telemetry.metrics import MetricsRegistry
    n_threads, per = 2 * (os.cpu_count() or 2) + 2, 200
    rec = ttrace.FlightRecorder(capacity=64)
    reg = MetricsRegistry()
    c = reg.counter("x_total", label_names=("t",))
    h = reg.histogram("y_seconds")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for j in range(per):
                rec.record(f"s{i}.{j}", "window", batch_index=i)
                c.labels(t=str(i % 3)).inc()
                h.observe(j * 1e-3)
        stop = threading.Event()

        def read():
            while not stop.is_set():
                reg.expose()
                rec.spans()
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        reader = threading.Thread(target=read)
        reader.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        reader.join(timeout=60)
        assert not reader.is_alive()
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    total = n_threads * per
    assert rec.recorded == total and len(rec) == 64
    assert rec.dropped == total - 64
    assert sum(c.labels(t=str(k)).value for k in range(3)) == total
    assert h.labels().n == total
