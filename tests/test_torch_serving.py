"""The port's serving path: queue, batcher, cache and engine, and the slice
as a whole against the JAX engine.

The whole-slice tests serve 2 drift/undervolt requests through the
reference ``DriftServeEngine`` (SMOKE DiT; 3 steps, and 7 steps with
TaylorSeer and the ``int8-body4`` plan) and through the port's engine on
the CPU, fed the same perturbed params, the reference's latents and the
reference's flip masks (``jax_replay_factory``). The perfmodel's
attribution must equal the reference engine's with ``==``. Logic tests use
a stub sampler and run in milliseconds.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import DriftServeEngine as JaxEngine
from repro_torch.core import dvfs
from repro_torch.diffusion.sampler import SampleOutput
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import dit
from repro_torch.perfmodel import energy
from repro_torch.serving import DriftServeEngine, SamplerKey

from test_torch_core import jax_replay_factory
from test_torch_dit import perturbed_jax_params

ARCH = "dit-xl-512"
STEPS = 3
SEEDS = (0, 1)
REPO = Path(__file__).resolve().parents[1]


TS_STEPS = 7
TS_ARGS = ["--taylorseer", "--precision", "int8-body4"]


def _jax_engine_run(**fields):
    """One reference engine run of 2 drift/undervolt requests: (params as
    numpy, latents, class ids, results)."""
    eng = JaxEngine(arch=ARCH, smoke=True, bucket=2, base_seed=0)
    from repro import configs as jconfigs
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    np_params = perturbed_jax_params(jcfg, seed=5)
    eng._params[(ARCH, True)] = jax.tree.map(jnp.asarray, np_params)
    lat, cond, _ = eng.servable_for(ARCH).batch_inputs(jcfg, list(SEEDS))
    for s in SEEDS:
        eng.submit(mode="drift", op="undervolt", seed=s, **fields)
    results = eng.run()
    return np_params, np.asarray(lat), np.asarray(cond), results


@pytest.fixture(scope="module")
def jax_run():
    return _jax_engine_run(steps=STEPS)


@pytest.fixture(scope="module")
def jax_ts_run():
    return _jax_engine_run(steps=TS_STEPS, taylorseer=True,
                           precision="int8-body4")


def assert_attribution_equal(got, want):
    """The perfmodel fields of a result equal the reference engine's with
    ==, and the breakdown sums bitwise to energy_j."""
    for f in ("energy_j", "baseline_energy_j", "latency_s",
              "baseline_latency_s", "completed_at_s", "taylorseer",
              "precision"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.energy_breakdown == want.energy_breakdown
    assert tuple(got.energy_breakdown) == energy.ENERGY_COMPONENTS
    assert energy.ledger_total(got.energy_breakdown) == got.energy_j


def _port_engine(np_params, lat, cond, **kw):
    eng = DriftServeEngine(arch=ARCH, smoke=True, bucket=2, base_seed=0,
                           device="cpu",
                           flip_source_factory=jax_replay_factory(0), **kw)
    eng.set_params(ARCH, True, dit.params_from_jax(np_params))
    eng.servable.batch_inputs = lambda cfg, seeds: (
        torch.from_numpy(lat), torch.from_numpy(cond).long())
    return eng


def test_slice_matches_jax_engine(jax_run):
    """Per request: latents within 1e-4 (f32 SMOKE; XLA and PyTorch sum in
    other orders and the rollback splices checkpoints that carry those
    differences), PSNR within 0.05 dB, LPIPS within 1e-4 absolute;
    corrected elements, model evals and the monitor's ladder index exact."""
    np_params, lat, cond, want = jax_run
    eng = _port_engine(np_params, lat, cond)
    got = serve.main(["--steps", str(STEPS), "--requests", "2", "--mode",
                      "drift", "--op", "undervolt", "--device", "cpu"],
                     engine=eng)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.request_id == w.request_id and g.op == w.op == "undervolt"
        assert g.batch_corrected_elems == w.batch_corrected_elems
        assert g.batch_corrected_elems > 0
        assert g.n_model_evals == w.n_model_evals == STEPS
        assert g.monitor_op_index == w.monitor_op_index
        np.testing.assert_allclose(g.monitor_ber, w.monitor_ber, rtol=1e-5)
        np.testing.assert_allclose(g.latents.numpy(), np.asarray(w.latents),
                                   atol=1e-4, rtol=0)
        assert abs(g.psnr_vs_clean_db - w.psnr_vs_clean_db) < 0.05
        assert abs(g.lpips_vs_clean - w.lpips_vs_clean) < 1e-4
        assert g.psnr_vs_clean_db < 90       # the faults changed something
        assert_attribution_equal(g, w)
        assert g.energy_j < g.baseline_energy_j
    assert eng.cache.builds == 2             # drift + its clean reference
    assert eng.stats.clean_samples_computed == 1
    assert eng.clock_s == got[0].completed_at_s == got[0].latency_s


def test_slice_with_taylorseer_and_body4_matches_jax_engine(jax_ts_run):
    """--taylorseer --precision int8-body4 --steps 7: the drift run and its
    clean reference (TaylorSeer on, int8) compute steps 0, 3 and 6. Counts
    and attribution exact, latents within 1e-4 as above."""
    np_params, lat, cond, want = jax_ts_run
    eng = _port_engine(np_params, lat, cond)
    got = serve.main(["--steps", str(TS_STEPS), "--requests", "2",
                      "--mode", "drift", "--op", "undervolt", "--device",
                      "cpu"] + TS_ARGS, engine=eng)
    for g, w in zip(got, want):
        assert (g.taylorseer, g.precision) == (True, "int8-body4")
        assert g.batch_corrected_elems == w.batch_corrected_elems > 0
        assert g.n_model_evals == w.n_model_evals == 3
        assert g.monitor_op_index == w.monitor_op_index
        np.testing.assert_allclose(g.latents.numpy(), np.asarray(w.latents),
                                   atol=1e-4, rtol=0)
        assert abs(g.psnr_vs_clean_db - w.psnr_vs_clean_db) < 0.05
        assert_attribution_equal(g, w)
    keys = {k.precision: k for k in eng.cache._fns}
    assert set(keys) == {"int8", "int8-body4"}
    assert keys["int8"].mode == "clean" and keys["int8"].taylorseer


# ------------------------------------------------------------ logic (stub)
def stub_factory(calls=None):
    def factory(key: SamplerKey, model_cfg, scfg):
        def run(params, flip_source, latents, cond, monitor0, window):
            if calls is not None:
                calls.append(key)
            mon = dvfs.BerMonitorState(monitor0.ema_ber, monitor0.op_index,
                                       monitor0.n_updates + 1)
            return iter([SampleOutput(latents, mon, torch.tensor(0),
                                      scfg.num_sample_steps)])
        return run
    return factory


def stub_engine(bucket=2, calls=None):
    return DriftServeEngine(arch=ARCH, smoke=True, bucket=bucket,
                            device="cpu", sampler_factory=stub_factory(calls))


def test_results_in_submission_order_and_padding():
    eng = stub_engine(bucket=2)
    for i, op in enumerate(["undervolt", "overclock"] * 2 + ["undervolt"]):
        eng.submit(steps=2, mode="drift", op=op, seed=i)
    results = eng.run()
    assert [r.request_id for r in results] == [0, 1, 2, 3, 4]
    assert results[0].batch_index == results[2].batch_index
    assert results[1].batch_index == results[3].batch_index
    assert eng.stats.batches == 3 and eng.stats.padded_slots == 1
    assert all(r.bucket_size == 2 for r in results)


def test_cache_builds_once_per_config_and_clean_reference_cached():
    calls = []
    eng = stub_engine(bucket=2, calls=calls)
    for _ in range(2):
        for s in (0, 1):
            eng.submit(steps=2, mode="drift", op="undervolt", seed=s)
        eng.run()
    # drift + clean reference built once; the second batch hits both
    assert eng.cache.builds == 2 and eng.cache.hits == 1
    assert eng.stats.clean_samples_computed == 1
    assert eng.stats.clean_sample_hits == 1
    eng.submit(steps=2, mode="clean", op="overclock", seed=0)
    eng.run()
    assert calls[-1].op == "" and calls[-1].mode == "clean"


def test_auto_op_reads_monitor_ladder():
    eng = stub_engine(bucket=1)
    eng.monitor = dvfs.BerMonitorState(torch.tensor(0.0),
                                       torch.tensor(2, dtype=torch.int32), 1)
    eng.submit(steps=2, mode="drift", op="auto", seed=0)
    (res,) = eng.run()
    assert res.op == dvfs.OP_LADDER[2].name == "uv-safe"
    assert res.monitor_op_index == 2


def test_monitor_carries_over_only_for_drift():
    eng = stub_engine(bucket=1)
    eng.submit(steps=2, mode="drift", op="undervolt", seed=0)
    eng.run()
    assert eng.monitor.n_updates == 1
    eng.submit(steps=2, mode="faulty", op="undervolt", seed=0)
    eng.run()
    assert eng.monitor.n_updates == 1


@pytest.mark.parametrize("field,value", [
    ("rollback_interval", "sometimes"), ("priority", "urgent"),
    ("deadline_s", 0), ("energy_budget_j", -1), ("quality_floor", 1.5),
    ("rollback_interval", 0), ("mode", "dmr"), ("op", "warp-speed"),
])
def test_unported_request_fields_raise_at_submit(field, value):
    """Invalid values the reference also rejects, modes a paradigm does
    not take (the Fig 12 baseline dmr on the autoregressive path; the
    diffusion path now takes it) and unknown operating points raise at
    submit and queue nothing."""
    eng = stub_engine()
    extra = {"arch": "olmo-1b"} if field == "mode" else {}
    with pytest.raises(ValueError):
        eng.submit(steps=2, **{field: value}, **extra)
    assert len(eng.queue) == 0


@pytest.mark.parametrize("fields", [
    dict(taylorseer=True), dict(precision="int8-body6"),
    dict(precision="int8-body4"), dict(taylorseer=True, precision="int8-body4"),
])
def test_taylorseer_and_plans_accepted_and_keyed_apart(fields):
    """Each knob is a field of the sampler key: a request setting it does
    not share a batch or a built sampler with a default one, and the
    sampler config carries the engine's protection window."""
    calls, scfgs = [], []
    factory = stub_factory(calls)

    def spy(key, model_cfg, scfg):
        scfgs.append(scfg)
        return factory(key, model_cfg, scfg)
    eng = DriftServeEngine(arch=ARCH, smoke=True, bucket=2, device="cpu",
                           sampler_factory=spy, nominal_steps=3)
    eng.submit(steps=4, seed=0)
    eng.submit(steps=4, seed=1, **fields)
    a, b = eng.run()
    assert a.batch_index != b.batch_index
    assert (a.taylorseer, a.precision) == (False, "int8")
    assert b.taylorseer == fields.get("taylorseer", False)
    assert b.precision == fields.get("precision", "int8")
    drift_keys = [k for k in calls if k.mode == "drift"]
    assert len(set(drift_keys)) == 2
    assert all(s.precision.protect_steps == 3 for s in scfgs)
    assert scfgs[-1].taylorseer.enabled == b.taylorseer


def test_unknown_precision_plan_raises_at_submit():
    eng = stub_engine()
    with pytest.raises(ValueError, match="unknown precision plan"):
        eng.submit(steps=2, precision="int3")
    assert len(eng.queue) == 0


def test_attribution_reads_the_true_corrected_count():
    """A count past 2**32 (the reference's int32 carry would wrap it;
    ROADMAP Queue C item 7) reaches the result and the billed recovery
    energy as it is."""
    big = 2 ** 32 + 5

    def factory(key, model_cfg, scfg):
        def run(params, flip_source, latents, cond, monitor0, window):
            return iter([SampleOutput(latents, monitor0, torch.tensor(big),
                                      scfg.num_sample_steps)])
        return run
    eng = DriftServeEngine(arch=ARCH, smoke=True, bucket=2, device="cpu",
                           sampler_factory=factory)
    eng.submit(steps=4, seed=0)
    (res,) = eng.run()
    assert res.batch_corrected_elems == big
    full = configs.get_config(ARCH)
    rc = energy.RunConfig(num_steps=4, aggressive=dvfs.UNDERVOLT,
                          recovery_tiles_per_step=big / 4 / 1024)
    want = energy.per_request_cost(full, rc, batch=2, n_live=1,
                                   em=energy.calibrate())
    assert res.energy_j == want["energy_j"]
    assert res.energy_breakdown == want["breakdown"]
    assert res.energy_breakdown["recovery"] > 0


def test_virtual_clock_stamps_submission_and_completion():
    eng = stub_engine(bucket=1)
    eng.submit(steps=3, seed=0)
    (r0,) = eng.run()
    assert r0.completed_at_s == eng.clock_s == r0.latency_s > 0
    eng.submit(steps=3, seed=1)
    assert eng.queue.peek().submitted_at_s == eng.clock_s
    (r1,) = eng.run()
    assert r1.completed_at_s == r0.completed_at_s + r1.latency_s


def test_step_budget_clamps_steps():
    eng = stub_engine()
    eng.submit(steps=10, step_budget=4)
    assert eng.queue.peek().steps == 4


def test_default_device_entry_points_raise_without_gpu(monkeypatch):
    """The engine, and the CLI building one, default to "cuda" and raise
    when no GPU is present: no silent CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DriftServeEngine()
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--steps", "1", "--no-smoke"])


def test_cli_smoke_flag_is_a_real_switch():
    ap = serve.build_parser()
    assert ap.parse_args([]).smoke is True
    assert ap.parse_args(["--no-smoke"]).smoke is False
    assert ap.parse_args([]).device == "cuda"
    assert ap.parse_args(["--mode", "thundervolt"]).mode == "thundervolt"
    with pytest.raises(SystemExit):
        ap.parse_args(["--mode", "undervolt"])
    args = ap.parse_args([])
    assert (args.taylorseer, args.precision) == (False, "int8")
    args = ap.parse_args(TS_ARGS)
    assert (args.taylorseer, args.precision) == (True, "int8-body4")
    with pytest.raises(SystemExit):
        ap.parse_args(["--precision", "int3"])


def test_port_imports_neither_jax_nor_repro():
    """Importing every repro_torch module leaves jax and repro unloaded."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(len([n for n in sys.modules if n.startswith("repro_torch")]))
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 25
