"""The sharded serving engine on CPU ranks: the port's side of each of the
reference's sharded tests (``tests/test_serving_sharded.py``).

Each mesh is one group of ranks the module spawns (``spawn`` processes,
gloo over a ``file://`` rendezvous under ``tmp_path``, one torch thread
each, every collective timing out after ``TIMEOUT_S``): a 2-rank data
mesh, a 4-rank data mesh and a (data 2, model 2) mesh. Every rank runs
the same scenario and saves what it served; the tests hold every rank's
results against the single-device engine's on the same requests and
params.

The reference promises bit-equal latents for a data axis and closeness
(5e-3, PSNR > 20) for a model axis of 2; the port gathers each block's
weights whole, so both axes are held bit-equal here. The SMOKE DiT's
adaLN-Zero and output weights are perturbed (seeded), so the requests
have real, distinct latents.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import configs
from repro_torch.models import dit, unet
from repro_torch.serving import (DeadlineScheduler, DriftServeEngine,
                                 EngineTelemetry, GenerationRequest,
                                 OffloadConfig, PreviewEvent, RequestResult)
from repro_torch.serving.batcher import request_key
from repro_torch.serving.telemetry.energy import ledger_total
from repro_torch.tree import tree_leaves, tree_map

STEPS, BUCKET, N_REQ = 3, 4, 6   # 6 requests -> 2 batches, one padded slot
FAMILY_ARCHS = ("pixart-alpha", "sd15-unet")
# the other protection modes: thundervolt and approx_abft correct on whole
# columns (gathered rows on a data mesh); dmr and stat_abft keep the
# rank's own rows
MODES = ("thundervolt", "approx_abft", "dmr", "stat_abft")
TIMEOUT_S = 120                  # per collective
JOIN_S = 300                     # per group
ROOT = Path(__file__).resolve().parents[1]


def perturbed_params(arch: str):
    """SMOKE params of ``arch`` with every all-zero weight of rank >= 2
    (adaLN-Zero, the output projections) given seeded small values."""
    cfg = configs.get_config(arch, smoke=True)
    model = unet if cfg.family == "unet" else dit
    g = torch.Generator()
    g.manual_seed(17)

    def nudge(t):
        if t.ndim >= 2 and not bool(t.any()):
            return 0.05 * torch.randn(t.shape, generator=g)
        return t
    return tree_map(nudge, model.init_params(cfg, 3))


def submit_stream(eng):
    for i in range(N_REQ):
        eng.submit(steps=STEPS, mode="drift",
                   op="auto" if i >= 4 else "undervolt", seed=i)


def monitor_snapshot(eng):
    return (int(eng.monitor.n_updates), int(eng.monitor.op_index),
            float(eng.monitor.ema_ber))


def result_view(r: RequestResult):
    return dict(request_id=r.request_id, op=r.op, latents=r.latents,
                n_model_evals=r.n_model_evals,
                monitor_op_index=r.monitor_op_index,
                corrected=r.batch_corrected_elems, energy_j=r.energy_j,
                energy_breakdown=r.energy_breakdown,
                psnr=r.psnr_vs_clean_db)


def serve(eng, stream: int = 0):
    """Submit the shared stream and drain it; (results, previews)."""
    submit_stream(eng)
    if not stream:
        return [result_view(r) for r in eng.run()], 0
    events = list(eng.run_stream(preview_interval=stream))
    results = sorted((e for e in events if isinstance(e, RequestResult)),
                     key=lambda r: r.request_id)
    previews = [e for e in events if isinstance(e, PreviewEvent)]
    assert all(p.step < STEPS for p in previews)
    return [result_view(r) for r in results], len(previews)


def admission_plans(make):
    """The reference's empty-history admission scenario."""
    def plans(telemetry):
        sched = DeadlineScheduler(make(telemetry=telemetry))
        lat = sched.batch_latency_s("dit-xl-512", "undervolt", STEPS)
        return [sched.submit(steps=STEPS, mode="drift", op="undervolt",
                             priority=prio, deadline_s=dl, seed=i)
                for i, (dl, prio) in enumerate([
                    (None, "background"), (5.0 * lat, "interactive"),
                    (1.2 * lat, "standard"), (1e-7, "interactive")])]
    return plans(None), plans(EngineTelemetry(enabled=False))


def ar_results(make):
    """2 SMOKE olmo-1b stat_abft requests, 8 tokens, window 3."""
    eng = make(arch="olmo-1b")
    for i in range(2):
        eng.submit(steps=8, mode="stat_abft", op="undervolt", seed=i,
                   rollback_interval=3)
    return [(r.tokens, r.ar_detections, r.ar_rollbacks, r.n_model_evals,
             r.energy_j) for r in eng.run()]


def mode_results(make):
    """Two requests in each of ``MODES``, then two drift requests under
    TaylorSeer with a narrowed precision plan (``fake_quant`` of each
    cached derivative at the whole batch's scale)."""
    eng = make()
    for i, mode in enumerate(MODES):
        for j in range(2):
            eng.submit(steps=STEPS, mode=mode, op="undervolt",
                       seed=10 * i + j)
    for j in range(2):
        eng.submit(steps=7, mode="drift", op="undervolt", seed=50 + j,
                   taylorseer=True, precision="int8-body4")
    return [result_view(r) for r in eng.run()]


def family_results(make):
    out = {}
    for arch in FAMILY_ARCHS:
        eng = make(arch=arch)
        eng.set_params(arch, True, perturbed_params(arch))
        for i in range(BUCKET):
            eng.submit(steps=STEPS, mode="drift", op="undervolt", seed=i)
        out[arch] = [result_view(r) for r in eng.run()]
    return out


# ---------------------------------------------------------------- ranks
def _rank_main(rank: int, world: int, model_parallel: int, tmp: str,
               full: bool) -> None:
    """One rank of a group: the scenario on the sharded engine, saved."""
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serving.sharded import (ShardedDriftServeEngine,
                                             make_engine)
    mesh = mesh_lib.make_serving_mesh(
        model_parallel, device="cpu", init_method=f"file://{tmp}/rdzv",
        rank=rank, world_size=world, timeout_s=TIMEOUT_S)
    params = perturbed_params("dit-xl-512")

    def make(**kw):
        eng = ShardedDriftServeEngine(mesh=mesh, bucket=BUCKET,
                                      device="cpu", **kw)
        eng.set_params("dit-xl-512", True, params)
        return eng

    out = {"mesh": dict(mesh.shape), "backend": mesh.backend}
    eng = make()
    out["results"], _ = serve(eng)
    out["monitor"] = monitor_snapshot(eng)
    out["key"] = (eng.batcher.key_extra["mesh_shape"],
                  eng.batcher.key_extra["batch_spec"])
    out["collectives"] = mesh.collectives
    builds, hits = eng.cache.builds, eng.cache.hits
    for i in range(BUCKET):
        eng.submit(steps=STEPS, mode="drift", op="undervolt", seed=i)
    eng.run()
    out["rebuilds"] = eng.cache.builds - builds
    out["new_hits"] = eng.cache.hits - hits
    if full:
        out["stream"] = serve(make(), stream=1)
        off = make(offload=OffloadConfig())
        out["offload"], _ = serve(off)
        st = off.offload_store.stats
        restored = off.offload_store.restore()
        out["offload_stats"] = (st.commits, st.bytes_offloaded)
        out["offload_restored"] = [tuple(t.shape)
                                   for t in tree_leaves(restored)]
        out["admission"] = admission_plans(make)
        out["modes"] = mode_results(make)
        out["families"] = family_results(
            lambda arch: ShardedDriftServeEngine(mesh=mesh, arch=arch,
                                                 bucket=BUCKET,
                                                 device="cpu"))
        out["ar"] = ar_results(
            lambda arch: ShardedDriftServeEngine(mesh=mesh, arch=arch,
                                                 bucket=2, device="cpu"))
        picked = make_engine(bucket=2, device="cpu", mesh=mesh)
        out["make_engine"] = type(picked).__name__
    torch.save(out, f"{tmp}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


def run_group(tmp_path, world: int, model_parallel: int, full: bool):
    """Spawn ``world`` ranks, wait for all, return every rank's record."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, model_parallel, str(tmp_path), full))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, codes
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# -------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def reference():
    """Single-device results for the shared stream, and the scenario's
    other runs on fresh single-device engines."""
    params = perturbed_params("dit-xl-512")

    def make(**kw):
        eng = DriftServeEngine(bucket=BUCKET, device="cpu", **kw)
        eng.set_params("dit-xl-512", True, params)
        return eng
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # as each rank runs
    try:
        eng = make()
        results, _ = serve(eng)
        return dict(results=results, monitor=monitor_snapshot(eng),
                    admission=admission_plans(make),
                    modes=mode_results(make),
                    ar=ar_results(lambda arch: DriftServeEngine(
                        arch=arch, bucket=2, device="cpu")),
                    families=family_results(
                        lambda arch: DriftServeEngine(
                            arch=arch, bucket=BUCKET, device="cpu")))
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    return run_group(tmp_path_factory.mktemp("dp2"), 2, 1, full=True)


@pytest.fixture(scope="module")
def dp4(tmp_path_factory):
    return run_group(tmp_path_factory.mktemp("dp4"), 4, 1, full=False)


@pytest.fixture(scope="module")
def dp2mp2(tmp_path_factory):
    return run_group(tmp_path_factory.mktemp("dp2mp2"), 4, 2, full=False)


def assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in ("request_id", "op", "n_model_evals", "monitor_op_index",
                  "corrected", "energy_j", "energy_breakdown", "psnr"):
            assert a[k] == b[k], k
        assert torch.equal(a["latents"], b["latents"])
        # bit-equal, NaN included
        assert torch.equal(a["latents"].view(torch.int32),
                           b["latents"].view(torch.int32))


MESHES = ["dp2", "dp4", "dp2mp2"]


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("group", MESHES)
def test_latents_bit_equal(group, reference, request):
    """Every request's latents, op, evaluations, corrected count, billed
    joules and PSNR equal to the single-device engine's, on every rank:
    the data axis (the reference's acceptance bar) and the model axis
    (the reference promises only 5e-3 and PSNR > 20 there)."""
    ranks = request.getfixturevalue(group)
    for rec in ranks:
        assert_same(rec["results"], reference["results"])
    assert len({r["backend"] for r in ranks}) == 1
    assert ranks[0]["backend"] == "gloo"


@pytest.mark.parametrize("group", MESHES)
def test_monitor_ladder_consistent_across_mesh(group, reference, request):
    """Counts summed over the data group feed one replicated monitor: the
    ladder walks as on one device, and the "auto" requests (seeds 4, 5)
    resolve alike; the EMA float is bit-equal."""
    ranks = request.getfixturevalue(group)
    for rec in ranks:
        assert rec["monitor"] == reference["monitor"]
        assert [r["op"] for r in rec["results"]][4:] == \
            [r["op"] for r in reference["results"]][4:]


@pytest.mark.parametrize("group", MESHES)
def test_no_rebuild_after_first_batch_per_mesh_config(group, request):
    """Re-serving a built (config, mesh) is all cache hits."""
    for rec in request.getfixturevalue(group):
        assert rec["rebuilds"] == 0 and rec["new_hits"] > 0


@pytest.mark.parametrize("group,mesh,spec", [
    ("dp2", {"data": 2, "model": 1}, "data,None,None,None"),
    ("dp4", {"data": 4, "model": 1}, "data,None,None,None"),
    ("dp2mp2", {"data": 2, "model": 2}, "data,None,None,None")])
def test_results_carry_full_latents_and_mesh_key(group, mesh, spec, request):
    """Results carry one whole (H, W, C) sample each, gathered; every key
    the batcher forms carries the mesh placement; the batch-wide counts
    were reduced by collectives."""
    for rec in request.getfixturevalue(group):
        assert rec["mesh"] == mesh
        assert rec["key"] == (tuple(mesh.items()), spec)
        assert rec["collectives"] > 0
        for r in rec["results"]:
            lat = r["latents"]
            cfg = configs.get_config("dit-xl-512", smoke=True)
            assert tuple(lat.shape) == (cfg.latent_size, cfg.latent_size,
                                        cfg.latent_channels)
            assert bool((lat.abs() <= 1.0).all())


def test_sampler_key_grows_mesh_component():
    """Key hygiene: engines on different meshes never share a sampler,
    and the mesh placement survives the clean-reference key rewrite."""
    req = GenerationRequest(request_id=0, steps=4, mode="drift",
                            op="undervolt")
    base = request_key(req, 4, "undervolt")
    k8 = request_key(req, 4, "undervolt",
                     extra={"mesh_shape": (("data", 8), ("model", 1)),
                            "batch_spec": "data,None,None,None"})
    k42 = request_key(req, 4, "undervolt",
                      extra={"mesh_shape": (("data", 4), ("model", 2)),
                             "batch_spec": "data,None,None,None"})
    assert base.mesh_shape == () and base.batch_spec == ""
    assert len({base, k8, k42}) == 3
    ck = dataclasses.replace(k8, mode="clean", op="")
    assert ck.mesh_shape == k8.mesh_shape


def test_streaming_bit_identical_on_sharded_engine(dp2, reference):
    """A streamed run on the 2-rank data mesh: STEPS - 1 previews per live
    request and finals bit-identical to the single-device one-shot run."""
    for rec in dp2:
        results, previews = rec["stream"]
        assert previews == (STEPS - 1) * N_REQ
        assert_same(results, reference["results"])


def test_offload_bit_identical_on_sharded_engine(dp2, reference):
    """Checkpoint offload on the 2-rank data mesh: each rank commits its
    store shard (one refresh per batch, 2 batches) and restores it; the
    finals stay bit-identical to the offload-free single-device run."""
    for rec in dp2:
        assert_same(rec["offload"], reference["results"])
        commits, nbytes = rec["offload_stats"]
        assert commits == 2 and nbytes > 0
        assert rec["offload_restored"] and all(
            s[0] >= 1 for s in rec["offload_restored"])


def test_make_engine_picks_sharded_on_multi_rank(dp2, monkeypatch):
    """On a mesh of more than one rank ``make_engine`` builds the sharded
    engine; with no process group and no WORLD_SIZE above 1 it builds
    the plain one (the counterpart of ``jax.device_count() == 1``)."""
    from repro_torch.serving.sharded import make_engine
    assert [rec["make_engine"] for rec in dp2] == \
        ["ShardedDriftServeEngine"] * 2
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert type(make_engine(bucket=2, device="cpu")) is DriftServeEngine
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert type(make_engine(bucket=2, device="cpu")) is DriftServeEngine
    with pytest.raises(ValueError, match="not both"):
        make_engine(mesh=object(), model_parallel=2, device="cpu")


def test_empty_history_admission_bit_identical_on_mesh(dp2, reference):
    """With no served history, admissions and their projections on the
    sharded engine equal the telemetry-free path's and the single-device
    engine's."""
    for rec in dp2:
        with_telemetry, without = rec["admission"]
        assert with_telemetry == without == reference["admission"][0]


@pytest.mark.parametrize("group", MESHES)
def test_energy_ledger_exact_on_mesh(group, reference, request):
    """Every billed ledger sums bitwise to its joules, and the sharded
    engine bills the single-device engine's breakdowns."""
    for rec in request.getfixturevalue(group):
        for r in rec["results"]:
            assert ledger_total(r["energy_breakdown"]) == r["energy_j"]
        for a, b in zip(rec["results"], reference["results"]):
            assert a["energy_breakdown"] == b["energy_breakdown"]


def test_autoregressive_buckets_served_whole_on_mesh(dp2, reference):
    """Language-model buckets run whole on every rank (weights still
    gathered per layer): tokens, detections, rollbacks, evaluations and
    joules equal the single-device engine's, as on the reference's mesh."""
    for rec in dp2:
        assert rec["ar"] == reference["ar"]
        assert all(det > 0 for _, det, *_ in rec["ar"])


@pytest.mark.parametrize("mode", MODES + ("taylorseer-int8-body4",))
def test_modes_bit_equal_on_data_mesh(mode, dp2, reference):
    """Each other protection mode, and drift under TaylorSeer with the
    int8-body4 plan, on the 2-rank data mesh: latents, counts, bills and
    PSNR bit-equal to one device."""
    i = (MODES + ("taylorseer-int8-body4",)).index(mode)
    for rec in dp2:
        got = rec["modes"][2 * i:2 * i + 2]
        want = reference["modes"][2 * i:2 * i + 2]
        assert_same(got, want)
        if mode == "dmr":
            assert all(r["corrected"] == 0 for r in got)
        if mode == "taylorseer-int8-body4":
            assert all(r["n_model_evals"] < 7 for r in got)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_families_bit_equal_on_data_mesh(arch, dp2, reference):
    """SMOKE PixArt (text GEMMs of 8 rows a request: their tiles straddle
    ranks and run on the gathered rows) and the SMOKE UNet (cross k/v of
    8 rows, timestep GEMMs at M = batch) on the 2-rank data mesh,
    bit-equal to one device."""
    for rec in dp2:
        assert_same(rec["families"][arch], reference["families"][arch])


def test_sharded_cli_under_torch_distributed_run(tmp_path):
    """``launch.serve --sharded`` on 2 CPU ranks under
    ``torch.distributed.run`` (a free rendezvous port): exit 0, rank 0
    prints the mesh line and the results once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--sharded", "--device", "cpu", "--steps", "3"],
        capture_output=True, text=True, timeout=JOIN_S, env=env,
        cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("[serve] mesh {'data': 2, 'model': 1} "
                            "backend gloo") == 1
    assert out.stdout.count("  req 0 ") == 1
