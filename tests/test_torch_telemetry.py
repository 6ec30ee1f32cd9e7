"""The port's telemetry against the JAX package's.

The metrics registry, latency estimator, guardband controller, energy
ledger and SLO tracker are pure host code in both packages: the same
sequence of operations or observations, drawn from a seeded numpy
generator, goes to each side, and expositions must be identical strings
and every estimate, floor, breach state and ``verify_cost`` residual
equal with ``==``. ``EngineTelemetry`` is held the same way through its
engine taps, with the wall-clock samples (uptime and the clock skew
derived from it) and the build version label masked (``mask_metrics``).
The engine-level check is zero perturbation: the SMOKE DiT's finals are
bit-identical with telemetry and the recorder on, disabled, or left to
the engine's defaults.

Engines that run a real sampler read the BER monitor's EMA, which XLA's
CPU compiler computes as ``fma(0.9, ema, det * f32(0.1 / words))`` (the
division folded into a constant, the update contracted) and PyTorch as
written: the two land up to one f32 ulp apart. ``assert_metrics_match``
and ``assert_slo_match`` hold every other sample with ``==`` and the
samples that carry that EMA (the monitor gauge, the realized-BER gauge
and the BER objective's values and burn rates) within ``EMA_RTOL``.
"""
import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from repro.perfmodel import energy as jenergy
from repro.serving import telemetry as jtele
from repro.serving.cache import SamplerKey as JKey
from repro.serving.telemetry import controller as jctrl
from repro.serving.telemetry import energy as jledger
from repro.serving.telemetry import history as jhist
from repro.serving.telemetry import metrics as jmetrics
from repro.serving.telemetry import slo as jslo
from repro_torch import configs
from repro_torch.core import dvfs
from repro_torch.perfmodel import energy
from repro_torch.serving import (DriftServeEngine, EngineTelemetry,
                                 FlightRecorder, SamplerKey)
from repro_torch.serving.request import RequestResult
from repro_torch.serving.telemetry import controller as tctrl
from repro_torch.serving.telemetry import energy as tledger
from repro_torch.serving.telemetry import history as thist
from repro_torch.serving.telemetry import metrics as tmetrics
from repro_torch.serving.telemetry import slo as tslo

# Samples read off the host's wall clock, and the build label: the only
# parts of an exposition that may differ between the two packages.
WALL_METRICS = ("drift_engine_uptime_seconds", "drift_clock_skew_ratio")


def mask_metrics(text: str) -> str:
    """An exposition with the wall-clock samples' values and the build
    version label replaced by placeholders."""
    out = []
    for line in text.splitlines():
        if line.split("{")[0].split(" ")[0] in WALL_METRICS:
            line = line.rsplit(" ", 1)[0] + " <wall>"
        out.append(re.sub(r'version="[^"]*"', 'version="<v>"', line))
    return "\n".join(out)


# Samples that carry the BER monitor's EMA, and their tolerance: two f32
# ulps, relative (see the module docstring).
EMA_METRICS = ("drift_monitor_ema_ber", "drift_realized_ber")
EMA_RTOL = 2.5e-7


def _ema_sample(line: str) -> bool:
    name = line.split("{")[0].split(" ")[0]
    return name in EMA_METRICS or (
        name == "drift_slo_burn_rate"
        and 'objective="ber_detection_rate"' in line)


def assert_metrics_match(got: str, want: str) -> None:
    """Masked expositions equal line for line; the EMA samples' values
    within ``EMA_RTOL``, everything else with ==."""
    g, w = mask_metrics(got).splitlines(), mask_metrics(want).splitlines()
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if a != b and _ema_sample(b):
            (ka, va), (kb, vb) = a.rsplit(" ", 1), b.rsplit(" ", 1)
            assert ka == kb and math.isclose(float(va), float(vb),
                                             rel_tol=EMA_RTOL), (a, b)
        else:
            assert a == b


def assert_slo_match(got: dict, want: dict) -> None:
    """SLO snapshots equal; the BER objective's values and burn rates
    within ``EMA_RTOL``."""
    got, want = dict(got), dict(want)
    gb = dict(got.pop("objectives"))
    wb = dict(want.pop("objectives"))
    assert got == want
    g_ber, w_ber = gb.pop("ber_detection_rate"), wb.pop("ber_detection_rate")
    assert gb == wb
    assert g_ber.keys() == w_ber.keys()
    for k, v in w_ber.items():
        if isinstance(v, float):
            assert math.isclose(g_ber[k], v, rel_tol=EMA_RTOL), k
        else:
            assert g_ber[k] == v, k


# --------------------------------------------------------------- metrics
def _drive_registry(mod, seed):
    """One seeded sequence of registry operations; returns the registry
    and what its percentile and error paths said."""
    rng = np.random.default_rng(seed)
    r = mod.MetricsRegistry()
    c = r.counter("x_total", "a counter")
    lc = r.counter("y_total", 'labels "quoted"\\n', label_names=("a", "b"))
    g = r.gauge("z", "a gauge")
    h = r.histogram("lat_seconds", "latency", label_names=("op",))
    hb = r.histogram("e_joules", "custom buckets", buckets=(0.5, 0.1, 2.0))
    said = []
    for _ in range(200):
        op = int(rng.integers(0, 6))
        v = float(rng.exponential(0.3))
        if op == 0:
            c.inc(v)
        elif op == 1:
            lc.labels(a=str(rng.integers(0, 3)), b='q"\\x').inc()
        elif op == 2:
            g.set(v if rng.random() < 0.5 else int(v * 10))
        elif op == 3:
            h.labels(op=str(rng.choice(["uv", "oc"]))).observe(v)
        elif op == 4:
            hb.observe(v)
        else:
            g.inc(-v)
    said.append(hb.percentile(50))
    said.append(h.labels(op="uv").percentile(99))
    said.append(r.histogram("never_seconds").percentile(50))
    try:
        lc.labels(a="1")
    except ValueError as exc:
        said.append(str(exc))
    assert r.counter("x_total") is c           # idempotent registration
    return r, said


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_exposition_identical(seed):
    jr, jsaid = _drive_registry(jmetrics, seed)
    tr, tsaid = _drive_registry(tmetrics, seed)
    assert tr.expose() == jr.expose()
    assert tsaid == jsaid
    merged = {"a": jr.expose(), "b": _drive_registry(jmetrics, seed + 7)[0]
              .expose()}
    assert tmetrics.merge_labeled_expositions(merged) == \
        jmetrics.merge_labeled_expositions(merged)


@pytest.mark.parametrize("q", [0, 12.5, 50, 90, 99, 100])
def test_nearest_rank_matches(q):
    data = sorted(np.random.default_rng(3).exponential(size=37).tolist())
    assert tmetrics.nearest_rank(data, q) == jmetrics.nearest_rank(data, q)
    with pytest.raises(ValueError):
        tmetrics.nearest_rank([], q)
    with pytest.raises(ValueError):
        tmetrics.nearest_rank(data, 101)


# --------------------------------------------------------------- history
def test_latency_estimator_matches():
    rng = np.random.default_rng(4)
    est = {m: m.LatencyEstimator(decay=0.6, window=16, min_observations=2)
           for m in (jhist, thist)}
    keys = [("dit-xl-512", op, s, b) for op in ("undervolt", "overclock")
            for s in (3, 10) for b in (1, 2)]
    for i in range(300):
        arch, op, steps, bucket = keys[int(rng.integers(0, len(keys)))]
        lat = float(rng.lognormal(-3, 0.4))
        ts = bool(rng.random() < 0.2)
        for m, e in est.items():
            e.observe(m.BatchObservation(
                arch=arch, op=op, steps=steps, bucket=bucket, latency_s=lat,
                clock_s=0.1 * i, batch_index=i, taylorseer=ts))
    j, t = est[jhist], est[thist]
    assert t.keys() == j.keys() and len(t) == len(j)
    assert t.total_observations == j.total_observations == 300
    for k in keys + [("dit-xl-512", "nominal", 3, 2)]:
        for ts in (False, True):
            assert t.estimate_s(*k, taylorseer=ts) == \
                j.estimate_s(*k, taylorseer=ts)
            assert t.n_observations(*k, taylorseer=ts) == \
                j.n_observations(*k, taylorseer=ts)
            for q in (50, 99):
                assert t.percentile_s(*k, q, taylorseer=ts) == \
                    j.percentile_s(*k, q, taylorseer=ts)


# ------------------------------------------------------------- controller
@pytest.mark.parametrize("window_batches,quiet_windows", [(1, 3), (2, 2)])
def test_guardband_controller_matches(window_batches, quiet_windows):
    """A seeded stream of monitor readings with spikes and quiet runs:
    every action, floor, clamp, realized BER and rollback rate equal."""
    rng = np.random.default_rng(5)
    target = 3e-3
    ctl = {m: m.GuardbandController(target, m.GuardbandConfig(
        window_batches=window_batches, quiet_windows=quiet_windows,
        max_guard=3)) for m in (jctrl, tctrl)}
    ops = [p.name for p in dvfs.OP_LADDER]
    for i in range(120):
        regime = (i // 15) % 3                # spike / quiet / in-band
        ber = float(target * (rng.uniform(2.5, 90) if regime == 0 else
                              rng.uniform(0, 0.4) if regime == 1 else
                              rng.uniform(0.6, 1.8)))
        op = ops[int(rng.integers(0, len(ops)))]
        corr = int(rng.integers(0, 2 ** 20))
        words = int(rng.integers(1, 2 ** 16))
        breach = bool(rng.random() < 0.1)
        acts = []
        for c in ctl.values():
            c.set_energy_slo_breach(breach)
            acts.append(c.observe_batch(ber, op, corrected_elems=corr,
                                        n_words=words))
        j, t = ctl[jctrl], ctl[tctrl]
        assert acts[0] == acts[1]
        assert t.guard_index == j.guard_index
        assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
        assert t.realized_ber == j.realized_ber
        assert t.rollback_rate == j.rollback_rate
        assert t.guard_op_name() == j.guard_op_name()
        for idx in range(len(dvfs.OP_LADDER)):
            assert t.clamp(idx) == j.clamp(idx)
    assert ctl[tctrl].stats.widenings > 0 and ctl[tctrl].stats.tightenings > 0


# ----------------------------------------------------------------- energy
@pytest.mark.parametrize("op", ["undervolt", "overclock", "uv-safe"])
@pytest.mark.parametrize("ts,bits", [(False, 8), (True, 4)])
def test_verify_cost_and_ledger_match(op, ts, bits):
    """``verify_cost`` on the port's priced batch and request ledgers is
    0.0 as on the reference's, the ledgers are equal with ==, and the
    ledger's totals, shares and per-request mean agree."""
    cfg = configs.get_config("dit-xl-512")
    from repro import configs as jconfigs
    from repro.serving.engine import OP_BY_NAME
    jcfg = jconfigs.get_config("dit-xl-512")
    rc = energy.RunConfig(num_steps=10, aggressive=dvfs.OP_BY_NAME[op],
                          taylorseer_interval=3 if ts else 0,
                          body_bits=bits, recovery_tiles_per_step=123.5)
    jrc = jenergy.RunConfig(num_steps=10, aggressive=OP_BY_NAME[op],
                            taylorseer_interval=3 if ts else 0,
                            body_bits=bits, recovery_tiles_per_step=123.5)
    em, jem = energy.calibrate(), jenergy.calibrate()
    cost = energy.run_cost(cfg, rc, batch=2, em=em)
    jcost = jenergy.run_cost(jcfg, jrc, batch=2, em=jem)
    req = energy.per_request_cost(cfg, rc, batch=2, n_live=1, em=em,
                                  cost=cost)
    assert cost["breakdown"] == jcost["breakdown"]
    assert tledger.verify_cost(cost) == jledger.verify_cost(jcost) == 0.0
    assert tledger.verify_cost(req) == 0.0
    with pytest.raises(AssertionError):
        tledger.verify_cost(dict(req, energy_j=req["energy_j"] * 1.5))
    ledgers = (jledger.EnergyLedger(), tledger.EnergyLedger())
    for led in ledgers:
        led.charge_batch(op, cost["breakdown"])
        led.charge_batch("nominal", cost["breakdown"])
        led.charge_request(req["energy_j"])
    j, t = ledgers
    assert t.joules == j.joules and t.ops() == j.ops()
    assert t.component_totals() == j.component_totals()
    assert t.component_totals(op) == j.component_totals(op)
    assert t.shares() == j.shares()
    assert t.energy_per_request_j() == j.energy_per_request_j()


# -------------------------------------------------------------------- SLO
@dataclasses.dataclass
class _Res:
    deadline_s: object
    deadline_missed: bool
    energy_j: float
    queue_wait_s: float


def test_slo_tracker_matches():
    rng = np.random.default_rng(6)
    cfg = dict(fast_window_s=0.5, slow_window_s=3.0, energy_per_request_j=1.0)
    trk = {m: m.SLOTracker(3e-3, m.SLOConfig(**cfg)) for m in (jslo, tslo)}
    clock = 0.0
    for _ in range(80):
        clock += float(rng.exponential(0.1))
        res = [_Res(deadline_s=0.1 if rng.random() < 0.5 else None,
                    deadline_missed=bool(rng.random() < 0.1),
                    energy_j=float(rng.exponential(1.5)),
                    queue_wait_s=float(rng.exponential(0.3)))
               for _ in range(int(rng.integers(1, 4)))]
        ber = float(rng.exponential(3e-3))
        mon = bool(rng.random() < 0.8)
        for t in trk.values():
            t.observe_batch(clock, ber, mon, res)
        j, t = trk[jslo], trk[tslo]
        assert t.burn_rates() == j.burn_rates()
        assert t.breached == j.breached
        assert t.snapshot() == j.snapshot()
    assert any(trk[tslo].breached.values())


# ------------------------------------------------- EngineTelemetry taps
def _results(mod_res, rng, batch_index):
    n = int(rng.integers(1, 3))
    out = []
    for i in range(n):
        kw = dict(request_id=batch_index * 2 + i, batch_index=batch_index,
                  bucket_size=2, op="undervolt", mode="drift", steps=3,
                  lpips_vs_clean=0.0, psnr_vs_clean_db=1.0,
                  batch_corrected_elems=0, n_model_evals=3,
                  energy_j=float(rng.exponential(0.5)), latency_s=0.06,
                  baseline_energy_j=1.0, baseline_latency_s=0.07,
                  monitor_ber=0.0, monitor_op_index=0,
                  deadline_s=0.1 if i else None,
                  deadline_missed=bool(i and rng.random() < 0.5),
                  queue_wait_s=float(rng.exponential(0.2)))
        out.append(mod_res(**kw))
    return out


def test_engine_telemetry_taps_match():
    """Every tap of ``EngineTelemetry`` fed the same stream on both
    sides: the masked exposition, the SLO snapshot, the guardband floor
    (and so ``clamp_ladder_index``) and the learned latencies equal; a
    disabled bundle registers nothing and clamps nothing."""
    from repro.serving.offload import OffloadStats as JStats
    from repro.serving.request import RequestResult as JRes
    from repro_torch.serving.offload.store import OffloadStats
    rng = np.random.default_rng(7)
    tele = {"j": jtele.EngineTelemetry().bind(3e-3),
            "t": EngineTelemetry().bind(3e-3)}
    breakdown = energy.run_cost(configs.get_config("dit-xl-512"),
                                energy.RunConfig(num_steps=3),
                                batch=2)["breakdown"]
    for b in range(40):
        op = str(rng.choice(["undervolt", "overclock", "uv-mild"]))
        mode = str(rng.choice(["drift", "clean", "stat_abft"]))
        ema = float(rng.exponential(6e-3))
        corr = int(rng.integers(0, 10 ** 6))
        words = int(rng.integers(1, 10 ** 5))
        clock = 0.07 * (b + 1)
        heat = tuple(tuple(int(v) for v in rng.integers(0, 3, 4))
                     for _ in range(3))
        for side, tl in tele.items():
            mk = (JKey if side == "j" else SamplerKey)
            key = mk(arch="dit-xl-512", smoke=True, steps=3, mode=mode,
                     op="" if mode == "clean" else op, bucket=2)
            res = _results(JRes if side == "j" else RequestResult,
                           np.random.default_rng(b), b)
            tl.on_submit()
            tl.on_admission(str(rng.choice(["as-requested"])))
            tl.on_batch(key=key, n_live=len(res), n_pad=2 - len(res),
                        latency_s=0.06 + 0.001 * b, ema_ber=ema,
                        op_index=b % 5, corrected=corr, n_words=words,
                        monitored=mode != "clean", clock_s=clock,
                        queue_depth=b % 3, results=res,
                        energy_breakdown=breakdown)
            tl.on_preview()
            tl.on_stream_window(2)
            tl.on_offload((JStats if side == "j" else OffloadStats)(
                commits=2, skipped=b % 2, bytes_offloaded=4096 * b),
                interval=2, stall_s=0.001 * b)
            tl.on_heatmap(heat, ("embed", "block0", "block1"))
            tl.on_projection("learned" if b % 2 else "perfmodel")
            tl.on_frontier_choice("min-energy", 7 + b % 3)
            tl.on_rejection("projected-miss")
    j, t = tele["j"], tele["t"]
    assert mask_metrics(t.registry.expose()) == \
        mask_metrics(j.registry.expose())
    assert t.slo_snapshot() == j.slo_snapshot()
    assert t.controller.guard_index == j.controller.guard_index
    for idx in range(5):
        assert t.clamp_ladder_index(idx) == j.clamp_ladder_index(idx)
    for op in ("undervolt", "overclock", "uv-mild"):
        assert t.learned_latency_s("dit-xl-512", op, 3, 2) == \
            j.learned_latency_s("dit-xl-512", op, 3, 2)
    assert t.ledger.joules == j.ledger.joules
    off = EngineTelemetry(enabled=False).bind(3e-3)
    assert off.registry.expose() == "\n"
    assert off.clamp_ladder_index(1) == 1 and off.slo_snapshot() is None
    assert off.learned_latency_s("dit-xl-512", "undervolt", 3, 2) is None


# --------------------------------------------------- zero perturbation
def test_finals_bit_identical_with_telemetry_and_recorder_on_off():
    """The SMOKE DiT's finals, corrected counts and monitor are the same
    bits with telemetry and the recorder on, disabled, or the engine's
    defaults, one-shot and streamed (window taps on)."""
    out = {}
    for label, kw in (("on", dict(telemetry=EngineTelemetry(),
                                  tracer=FlightRecorder())),
                      ("off", dict(telemetry=EngineTelemetry(enabled=False),
                                   tracer=FlightRecorder(enabled=False))),
                      ("default", {})):
        for stream in (0, 2):
            eng = DriftServeEngine(arch="dit-xl-512", smoke=True, bucket=2,
                                   base_seed=3, device="cpu", **kw)
            for s in (0, 1):
                eng.submit(steps=4, mode="drift", op="undervolt", seed=s)
            res = (eng.run() if not stream else
                   [e for e in eng.run_stream(stream)
                    if isinstance(e, RequestResult)])
            out[(label, stream)] = (
                [r.latents.view(torch.int32).clone() for r in res],
                [r.batch_corrected_elems for r in res],
                [r.detect_heatmap for r in res],
                float(eng.monitor.ema_ber))
            if label == "off":
                assert len(eng.tracer) == 0
                assert eng.telemetry.registry.expose() == "\n"
            else:
                kinds = [s.kind for s in eng.tracer.spans()]
                assert kinds.count("window") == (2 if stream else 0)
    base = out[("off", 0)]
    assert base[1][0] > 0 and sum(map(sum, base[2][0])) > 0
    for k, v in out.items():
        assert all(torch.equal(a, b) for a, b in zip(v[0], base[0])), k
        assert v[1:] == base[1:], k
