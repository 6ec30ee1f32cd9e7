"""The port's checkpoint offload, streaming and Fig 6 gates against the JAX
package's.

``core.repack`` and ``serving.offload.layout`` are compared bit for bit
(packed data, byte counts, row counts with ``==``); the planner's numbers
with ``==`` on the full-width ``dit-xl-512`` config; the store's commit,
skip, restore and failure semantics as ``tests/test_offload.py`` checks
the reference's. The whole-slice tests serve 2 drift/undervolt requests
(SMOKE DiT, 3 steps, rollback interval 2, bucket 2) through the reference
engine with ``offload=OffloadConfig()`` and telemetry off, and through
the port's engine, one-shot and streamed, on the CPU with the same params,
latents and flip masks (``jax_replay_factory``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import dvfs as jdvfs
from repro.core import repack as jrepack
from repro.core.exec_ctx import DriftSystemConfig as JCfg
from repro.diffusion import sampler as jsampler
from repro.serving import DriftServeEngine as JaxEngine
from repro.serving import OffloadConfig as JOffloadConfig
from repro.serving.offload import OffloadPlanner as JPlanner
from repro.serving.offload import layout as jlayout
from repro.serving.offload import pareto_frontier as jpareto
from repro.serving.telemetry import EngineTelemetry as JEngineTelemetry
from repro_torch import configs
from repro_torch.core import dvfs, repack
from repro_torch.core.exec_ctx import DriftSystemConfig
from repro_torch.core.rollback import RollbackConfig
from repro_torch.diffusion import sampler
from repro_torch.diffusion.sampler import SampleOutput
from repro_torch.launch import serve
from repro_torch.models import dit
from repro_torch.serving import (DriftServeEngine, EngineTelemetry,
                                 OffloadConfig, OffloadPlanner, OffloadStore,
                                 PreviewEvent)
from repro_torch.serving.offload import layout, pareto_frontier
from repro_torch.tree import tree_leaves, tree_map

from test_torch_core import JaxReplayFlipSource, jax_replay_factory
from test_torch_dit import perturbed_jax_params
from test_torch_serving import assert_attribution_equal

ARCH, STEPS, BUCKET, INTERVAL, SEEDS = "dit-xl-512", 3, 2, 2, (0, 1)
RUN_ARGS = ["--steps", str(STEPS), "--requests", "2", "--mode", "drift",
            "--op", "undervolt", "--device", "cpu", "--offload",
            "--rollback-interval", str(INTERVAL)]


def _as_np(x) -> np.ndarray:
    """A tensor or array as numpy; bf16 widened to f32 (exact)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if x.dtype == jnp.bfloat16:
        x = x.astype(jnp.float32)
    return np.asarray(x)


def _pair(rng, shape, dtype):
    """The same values as a jnp array and a torch tensor."""
    if dtype == "int32":
        a = rng.integers(-2 ** 31, 2 ** 31 - 1, size=shape, dtype=np.int32)
    else:
        a = rng.standard_normal(shape).astype(np.float32)
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(_as_np(j).copy()).to(getattr(torch, dtype))
    return j, t


# ---------------------------------------------------------------- repack
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("shape,tm,tn", [((37, 19), 8, 8), ((64, 33), 32, 32),
                                         ((5, 70), 16, 8)])
def test_repack_unpack_gather_bit_equal(dtype, shape, tm, tn):
    rng = np.random.default_rng(sum(shape) + tm)
    j, t = _pair(rng, shape, dtype)
    jt, tt = jrepack.repack(j, tm, tn), repack.repack(t, tm, tn)
    assert tt.dtype == t.dtype and tuple(tt.shape) == jt.shape
    np.testing.assert_array_equal(_as_np(tt), _as_np(jt))
    assert tt.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()
    back = repack.unpack(tt, shape, tm, tn)
    np.testing.assert_array_equal(_as_np(back), _as_np(
        jrepack.unpack(jt, shape, tm, tn)))
    assert torch.equal(back, t)
    flags = rng.random(jt.shape[:2]) < 0.4
    np.testing.assert_array_equal(
        _as_np(repack.gather_tiles(tt, torch.from_numpy(flags))),
        _as_np(jrepack.gather_tiles(jt, jnp.asarray(flags))))


# ---------------------------------------------------------------- layout
def _smoke_stores(seed=0):
    """The SMOKE DiT's checkpoint store at bucket 2 with random values, as
    the port's (embed, block) tensors and the reference's arrays."""
    cfg = configs.get_config(ARCH, smoke=True)
    rng = np.random.default_rng(seed)
    embed, block = dit.drift_store_spec(cfg, BUCKET)
    np_tree = tuple({k: rng.standard_normal(v.shape).astype(np.float32)
                     for k, v in d.items()} for d in (embed, block))
    port = tuple({k: torch.from_numpy(v.copy()) for k, v in d.items()}
                 for d in np_tree)
    ref = tuple({k: jnp.asarray(v) for k, v in d.items()} for d in np_tree)
    return port, ref


@pytest.mark.parametrize("repacked", [True, False])
@pytest.mark.parametrize("tm,tn", [(32, 32), (8, 16)])
def test_layout_matches_reference(repacked, tm, tn):
    """Packed data bit-equal leaf by leaf, ``store_nbytes``,
    ``layout_report`` and ``recovery_rows`` equal with ``==``, and the
    round trip exact."""
    port, ref = _smoke_stores()
    got = layout.pack_store(port, tm, tn, repacked)
    want = jlayout.pack_store(ref, tm, tn, repacked)
    for d_got, d_want in zip(got, want):
        assert d_got.keys() == d_want.keys()
        for k in d_got:
            g, w = d_got[k], d_want[k]
            assert (g.packed, g.shape) == (w.packed, w.shape)
            np.testing.assert_array_equal(g.data.numpy(), w.data)
    assert layout.store_nbytes(got) == jlayout.store_nbytes(want) > 0
    assert layout.layout_report(port, tm, tn) == \
        jlayout.layout_report(ref, tm, tn)
    for shape in [(256, 1152), (2, 37, 19), (4608,)]:
        for n_tiles in (1, 7):
            assert layout.recovery_rows(shape, tm, tn, n_tiles, repacked) \
                == jlayout.recovery_rows(shape, tm, tn, n_tiles, repacked)
    back = layout.unpack_store(got)
    for d_back, d_live in zip(back, port):
        for k in d_live:
            assert torch.equal(d_back[k], d_live[k])


# ----------------------------------------------------------------- store
def _carry(stores, ema_ber=0.0):
    """The carry positions the store reads: stores at [1], monitor at
    [3]."""
    mon = dvfs.BerMonitorState(torch.tensor(ema_ber), torch.tensor(0), 1)
    return (None, stores, None, mon, None, None)


def test_store_commits_only_when_refresh_crossed():
    stores = {"w": torch.ones(4, 4)}
    s = OffloadStore(OffloadConfig(async_commit=False))
    s.begin_batch(interval=4, batch_index=0)
    s.on_window(2, _carry(stores))    # refresh step 0 in [0, 2)
    s.on_window(3, _carry(stores))    # no refresh in [2, 3)
    s.on_window(6, _carry(stores))    # refresh step 4 in [3, 6)
    assert s.stats.commits == 2
    assert s.committed_step == 4


def test_store_skips_commit_on_detection_spike():
    stores = {"w": torch.ones(4, 4)}
    s = OffloadStore(OffloadConfig(async_commit=False, skip_spike_ratio=2.0,
                                   target_ber=1e-3))
    s.begin_batch(interval=1, batch_index=0)
    s.on_window(1, _carry(stores, ema_ber=0.0))      # quiet: commit
    s.on_window(2, _carry(stores, ema_ber=5e-3))     # spike: keep old
    st = s.finish_batch()
    assert st.commits == 1 and st.skipped == 1
    assert s.committed_step == 0      # the pre-spike snapshot survives


@pytest.mark.parametrize("async_commit", [True, False])
@pytest.mark.parametrize("repacked", [True, False])
def test_store_restores_a_snapshot_not_the_live_buffer(async_commit,
                                                       repacked):
    """A commit followed by an in-place overwrite of the live store (what
    the next refresh step does) still restores the committed values, bit
    for bit, on non-tile-aligned leaves; the two host sets are reused
    across batches."""
    rng = np.random.default_rng(1)
    stores = ({"q": torch.from_numpy(rng.standard_normal((37, 19))
                                     .astype(np.float32))},
              {"w1": torch.from_numpy(rng.standard_normal((3, 64, 33))
                                      .astype(np.float32))})
    want = tree_map(torch.clone, stores)
    s = OffloadStore(OffloadConfig(async_commit=async_commit,
                                   repacked=repacked, tile_m=8, tile_n=8))
    s.begin_batch(interval=1, batch_index=0)
    s.on_window(1, _carry(stores))
    tree_map(lambda t: t.mul_(-3.0), stores)   # the next refresh
    sets = [list(h) for h in s._host_sets]
    assert s.finish_batch().commits == 1
    for got, ref in zip(tree_leaves(s.restore()),
                        tree_leaves(want)):
        assert got.shape == ref.shape and torch.equal(got, ref)
    assert s.stats.restores == 1 and s.stats.waits == 0
    s.begin_batch(interval=1, batch_index=1)
    s.on_window(1, _carry(stores))
    assert s.finish_batch().commits == 1
    assert all(a is b for x, y in zip(sets, s._host_sets)
               for a, b in zip(x, y))
    assert torch.equal(s.restore()[1]["w1"], stores[1]["w1"])


def test_store_surfaces_commit_failure_at_the_next_join():
    s = OffloadStore(OffloadConfig())
    s.begin_batch(interval=1, batch_index=0)
    s.on_window(1, _carry({"w": object()}))   # unpackable leaf
    with pytest.raises(RuntimeError, match="offload commit failed"):
        s.finish_batch()
    s.begin_batch(interval=1, batch_index=1)  # the store recovers
    s.on_window(1, _carry({"w": torch.ones(4, 4)}))
    assert s.finish_batch().commits == 1
    sync = OffloadStore(OffloadConfig(async_commit=False))
    sync.begin_batch(interval=1, batch_index=0)
    with pytest.raises(RuntimeError, match="offload commit failed"):
        sync.on_window(1, _carry({"w": object()}))
    with pytest.raises(RuntimeError, match="before any committed"):
        OffloadStore().restore()


def test_restore_matches_live_store_after_sample_stream():
    """Drive ``sample_stream`` with the store on its carry: the last
    commit is the refresh at step 2 and restores the final live store bit
    for bit (the DiT's embed dict and stacked block dict)."""
    cfg = configs.get_config(ARCH, smoke=True)
    params = dit.init_params(cfg, 0)
    scfg = sampler.SamplerConfig(
        num_sample_steps=STEPS,
        drift=DriftSystemConfig(mode="drift",
                                rollback=RollbackConfig(interval=INTERVAL)))
    lat0 = torch.randn((1, 8, 8, 4), generator=torch.Generator()
                       .manual_seed(1))
    carries, windows = [], []
    store = OffloadStore(OffloadConfig(tile_m=8, tile_n=8))
    store.begin_batch(interval=INTERVAL, batch_index=0)
    events = list(sampler.sample_stream(
        cfg, params, None, lat0, torch.zeros(1, dtype=torch.int64), scfg,
        window=INTERVAL, on_window=windows.append,
        on_carry=lambda done, carry: (carries.append(carry),
                                      store.on_window(done, carry))))
    assert windows == [2, 3] and isinstance(events[-1], SampleOutput)
    assert [e.step for e in events[:-1]] == [2]
    assert store.finish_batch().commits == 2 and store.committed_step == 2
    live = tree_leaves(carries[-1][1])
    restored = tree_leaves(store.restore())
    assert len(live) == len(restored) == 10
    for a, b in zip(live, restored):
        assert torch.equal(a, b)


# --------------------------------------------------------------- planner
@pytest.mark.parametrize("overlapped,repacked", [(True, True), (False, True),
                                                 (True, False)])
def test_planner_matches_reference(overlapped, repacked):
    """sweep, plan, residual_stall_s and the Pareto frontier equal the
    reference's with == on the full-width config."""
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    got = OffloadPlanner(nominal_steps=2, repacked=repacked,
                         overlapped=overlapped)
    want = JPlanner(nominal_steps=2, repacked=repacked,
                    overlapped=overlapped)
    for name in ("nominal", "undervolt", "overclock", "uv-safe"):
        op, jop = dvfs.OP_BY_NAME[name], _jop(name)
        for steps in (3, 10, 50):
            for bucket in (1, 2, 4):
                for rate in (1e-6, 0.3, 1.0):
                    g = got.sweep(cfg, op, steps, bucket, rate)
                    w = want.sweep(jcfg, jop, steps, bucket, rate)
                    assert [dataclasses.asdict(p) for p in g] == \
                        [dataclasses.asdict(p) for p in w]
                    assert [p.interval for p in pareto_frontier(g)] == \
                        [p.interval for p in jpareto(w)]
                    assert dataclasses.asdict(
                        got.plan(cfg, op, steps, bucket, rate)) == \
                        dataclasses.asdict(want.plan(jcfg, jop, steps,
                                                     bucket, rate))
                for interval in (1, 2, 5, 10):
                    assert got.residual_stall_s(cfg, op, steps, bucket,
                                                interval) == \
                        want.residual_stall_s(jcfg, jop, steps, bucket,
                                              interval)


def _jop(name):
    from repro.serving.engine import OP_BY_NAME
    return OP_BY_NAME[name]


# ------------------------------------------------- engine, stub samplers
def _stub_factory(key, model_cfg, scfg):
    """A port sampler returning its inputs as its one event."""
    def run(params, flip_source, latents, cond, monitor0, window):
        return iter([SampleOutput(latents, monitor0, torch.tensor(0),
                                  scfg.num_sample_steps)])
    return run


def _jax_stub_factory(key, model_cfg, scfg, on_trace):
    """The reference engine's twin of ``_stub_factory``."""
    def run(params, rng, latents, cond, text, monitor0):
        out = jsampler.SampleOutput(latents, monitor0, jnp.int32(0),
                                    jnp.int32(scfg.num_sample_steps))
        return iter([out]) if key.stream else out
    return run


@pytest.mark.parametrize("async_commit", [True, False])
def test_auto_interval_stall_and_clock_match_jax_engine(async_commit):
    """``rollback_interval="auto"`` resolves to the reference's interval,
    and the modeled stall (non-zero when the copy is serialized) lands on
    the virtual clock as the reference's does, with ==."""
    got = DriftServeEngine(arch=ARCH, smoke=True, bucket=BUCKET,
                           device="cpu", sampler_factory=_stub_factory,
                           offload=OffloadConfig(async_commit=async_commit),
                           telemetry=EngineTelemetry(enabled=False))
    want = JaxEngine(arch=ARCH, smoke=True, bucket=BUCKET,
                     sampler_factory=_jax_stub_factory,
                     telemetry=JEngineTelemetry(enabled=False),
                     offload=JOffloadConfig(async_commit=async_commit))
    for op in ("undervolt", "overclock"):
        for steps in (3, 10):
            assert got.auto_rollback_interval(ARCH, op, steps) == \
                want.auto_rollback_interval(ARCH, op, steps)
    stall = got.offload_stall_s(ARCH, "undervolt", 10, "auto")
    assert stall == want.offload_stall_s(ARCH, "undervolt", 10, "auto")
    assert (stall > 0) == (not async_commit)
    for eng in (got, want):
        for s in SEEDS:
            eng.submit(steps=10, mode="drift", op="undervolt", seed=s,
                       rollback_interval="auto")
    g, w = got.run(), want.run()
    assert got.stats.batches == 1
    for a, b in zip(g, w):
        assert a.latency_s == b.latency_s
        assert a.completed_at_s == b.completed_at_s
        assert a.energy_j == b.energy_j
    assert got.clock_s == want.clock_s
    (key,) = [k for k in got.cache._fns if k.mode == "drift"]
    assert key.rollback_interval == got.auto_rollback_interval(
        ARCH, "undervolt", 10)


def test_autoregressive_servable_refuses_to_stream():
    eng = DriftServeEngine(arch="olmo-1b", smoke=True, bucket=1,
                           device="cpu")
    eng.submit(steps=2, mode="stat_abft", seed=0)
    with pytest.raises(ValueError, match="diffusion mechanism"):
        list(eng.run_stream(1))


# ------------------------------------------------------- the whole slice
@pytest.fixture(scope="module")
def jax_offloaded():
    """One reference engine run with offload on: (engine, params as
    numpy, latents, class ids, results)."""
    eng = JaxEngine(arch=ARCH, smoke=True, bucket=BUCKET, base_seed=0,
                    offload=JOffloadConfig(),
                    telemetry=JEngineTelemetry(enabled=False))
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    np_params = perturbed_jax_params(jcfg, seed=5)
    eng._params[(ARCH, True)] = jax.tree.map(jnp.asarray, np_params)
    lat, cond, _ = eng.servable_for(ARCH).batch_inputs(jcfg, list(SEEDS))
    for s in SEEDS:
        eng.submit(steps=STEPS, mode="drift", op="undervolt", seed=s,
                   rollback_interval=INTERVAL)
    return eng, np_params, np.asarray(lat), np.asarray(cond), eng.run()


def _port_engine(np_params, lat, cond, offload=True):
    eng = DriftServeEngine(arch=ARCH, smoke=True, bucket=BUCKET,
                           base_seed=0, device="cpu",
                           flip_source_factory=jax_replay_factory(0),
                           offload=OffloadConfig() if offload else None,
                           telemetry=EngineTelemetry(enabled=False))
    eng.set_params(ARCH, True, dit.params_from_jax(np_params))
    eng.servable.batch_inputs = lambda cfg, seeds: (
        torch.from_numpy(lat.copy()), torch.from_numpy(cond.copy()).long())
    return eng


def _assert_result_matches(g, w):
    assert g.request_id == w.request_id
    assert g.batch_corrected_elems == w.batch_corrected_elems > 0
    assert g.n_model_evals == w.n_model_evals == STEPS
    assert g.monitor_op_index == w.monitor_op_index
    np.testing.assert_allclose(g.latents.numpy(), np.asarray(w.latents),
                               atol=1e-4, rtol=0)
    assert_attribution_equal(g, w)


def test_offloaded_engine_matches_jax_engine(jax_offloaded):
    """``--offload`` through the CLI: counts, commits and committed bytes
    exact, latents within 1e-4, latency, clock (stall included) and
    energy with ==; the offload changes no latent bit of the port."""
    jeng, np_params, lat, cond, want = jax_offloaded
    eng = _port_engine(np_params, lat, cond)
    got = serve.main(RUN_ARGS, engine=eng)
    for g, w in zip(got, want):
        _assert_result_matches(g, w)
    st, jst = eng.offload_store.stats, jeng.offload_store.stats
    assert (st.commits, st.skipped, st.bytes_offloaded) == \
        (jst.commits, jst.skipped, jst.bytes_offloaded)
    assert st.commits == 2 and eng.offload_store.committed_step == 2
    assert eng.offload_store.committed_nbytes == \
        jeng.offload_store.committed_nbytes
    assert eng.clock_s == jeng.clock_s
    plain = _port_engine(np_params, lat, cond, offload=False)
    _submit(plain)
    for a, b in zip(plain.run(), got):
        assert torch.equal(a.latents, b.latents)
        assert a.batch_corrected_elems == b.batch_corrected_elems


def _submit(eng):
    for s in SEEDS:
        eng.submit(steps=STEPS, mode="drift", op="undervolt", seed=s,
                   rollback_interval=INTERVAL)


def test_streamed_offloaded_engine_matches_jax_engine(jax_offloaded):
    """``--offload --stream 1``: (steps - 1) x requests previews, commits
    and finals as the reference's offloaded run, and finals torch.equal
    to the port's own one-shot ``run()``."""
    jeng, np_params, lat, cond, want = jax_offloaded
    eng = _port_engine(np_params, lat, cond)
    got = serve.main(RUN_ARGS + ["--stream", "1"], engine=eng)
    for g, w in zip(got, want):
        _assert_result_matches(g, w)
    assert eng.offload_store.stats.commits == \
        jeng.offload_store.stats.commits == 2
    assert eng.stats.preview_events == (STEPS - 1) * len(SEEDS)
    # the streamed run and its clean reference: one build each
    assert eng.cache.builds == 2
    streamed = _port_engine(np_params, lat, cond)
    _submit(streamed)
    events = list(streamed.run_stream(1))
    previews = [e for e in events if isinstance(e, PreviewEvent)]
    assert [(p.request_id, p.step, p.total_steps) for p in previews] == \
        [(r, i, STEPS) for i in range(1, STEPS) for r in (0, 1)]
    one_shot = _port_engine(np_params, lat, cond, offload=False)
    _submit(one_shot)
    finals = [e for e in events if not isinstance(e, PreviewEvent)]
    for a, b, c in zip(one_shot.run(), finals, got):
        assert torch.equal(a.latents, b.latents)
        assert torch.equal(a.latents, c.latents)
    assert float(previews[-1].latents.abs().max()) <= 1.0   # clipped


def test_gated_sample_stream_matches_jax_sample():
    """The Fig 6 gates: block 1 at half BER, block 2 off, through
    ``sample_stream`` in windows of 2 against the reference's one-shot
    ``sample``: the heatmap and counts exact (no detection in the
    gated-off block), latents within 1e-4."""
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    np_params = perturbed_jax_params(jcfg, seed=5)
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    cond = np.array([3, 8], np.int32)
    gates = dict(layer_gate=np.array([1.0, 0.5, 0.0], np.float32),
                 embed_gate=0.5)
    steps, run_key = 5, jax.random.PRNGKey(11)
    want = jsampler.sample(
        jcfg, jax.tree.map(jnp.asarray, np_params), run_key,
        jnp.asarray(lat), jnp.asarray(cond), None,
        jsampler.SamplerConfig(
            num_sample_steps=steps, drift=JCfg(mode="drift"),
            schedule=jdvfs.fine_grained_schedule(steps, jdvfs.UNDERVOLT),
            **gates))
    cfg = configs.get_config(ARCH, smoke=True)
    *_, got = sampler.sample_stream(
        cfg, dit.params_from_jax(np_params), JaxReplayFlipSource(run_key),
        torch.from_numpy(lat), torch.from_numpy(cond).long(),
        sampler.SamplerConfig(
            num_sample_steps=steps, drift=DriftSystemConfig(mode="drift"),
            schedule=dvfs.fine_grained_schedule(steps, dvfs.UNDERVOLT),
            **gates), window=2)
    heat = got.heatmap.numpy()
    np.testing.assert_array_equal(heat, np.asarray(want.heatmap))
    assert heat[:, 2].any() and not heat[:, 3].any()
    assert int(got.total_corrected) == int(want.total_corrected) > 0
    np.testing.assert_allclose(got.latents.numpy(), np.asarray(want.latents),
                               atol=1e-4, rtol=0)
