"""The sharded serving engine's language-model buckets on CPU ranks.

Every LM family of the registry at SMOKE (dense olmo-1b; the GQA models
with windows and softcaps; the MoE models; the SSM and hybrid models) is
served by ``ShardedDriftServeEngine`` on a (data 2, model 1) and a (data
1, model 2) mesh of 2 spawned ranks (gloo over a ``file://`` rendezvous
under ``tmp_path``, one torch thread each, every collective timing out
after ``TIMEOUT_S``), in ``stat_abft`` and in ``faulty``. An AR bucket
runs whole on every rank while each layer's weights, sharded at rest,
are gathered at its boundary; every rank's results must equal the
single-device ``DriftServeEngine``'s field for field (tokens, detections,
rollbacks, evaluations, joules, ledgers, monitor). The single-device
engine is itself held to the JAX package per family by
``tests/test_torch_{ar,gqa,moe,mamba2,hybrid}.py``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.serving import DriftServeEngine
from repro_torch.serving.telemetry.energy import ledger_total

ARCHS = ("olmo-1b", "gemma2-9b", "glm4-9b", "gemma3-27b",
         "deepseek-moe-16b", "kimi-k2-1t-a32b", "mamba2-370m", "hymba-1.5b")
MODES = ("stat_abft", "faulty")
TOKENS, BUCKET, WINDOW, N_REQ = 6, 2, 3, 2
MESHES = {"dp2": 1, "mp2": 2}    # each 2-rank group's model-axis width
WORLD = 2
TIMEOUT_S = 120                  # per collective
JOIN_S = 300                     # per group
ROOT = Path(__file__).resolve().parents[1]


def served(make):
    """Per arch: every result of N_REQ requests in each of MODES on one
    engine (``make(arch)``), whole, and the engine's monitor after."""
    out = {}
    for arch in ARCHS:
        eng = make(arch)
        results = []
        for mode in MODES:
            for i in range(N_REQ):
                eng.submit(steps=TOKENS, mode=mode, op="undervolt", seed=i,
                           rollback_interval=WINDOW)
            results += [dataclasses.asdict(r) for r in eng.run()]
        mon = eng.monitor
        out[arch] = dict(results=results,
                         monitor=(int(mon.n_updates), int(mon.op_index),
                                  float(mon.ema_ber)))
    return out


def _rank_main(rank: int, model_parallel: int, tmp: str) -> None:
    """One rank of a group: every arch on the sharded engine, saved with
    the collectives each arch's runs made."""
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serving.sharded import ShardedDriftServeEngine
    mesh = mesh_lib.make_serving_mesh(
        model_parallel, device="cpu", init_method=f"file://{tmp}/rdzv",
        rank=rank, world_size=WORLD, timeout_s=TIMEOUT_S)
    starts = []                  # the mesh's count as each arch starts

    def make(arch):
        starts.append(mesh.collectives)
        return ShardedDriftServeEngine(mesh=mesh, arch=arch, bucket=BUCKET,
                                       device="cpu")
    out = served(make)
    starts.append(mesh.collectives)
    rec = {"mesh": dict(mesh.shape), "backend": mesh.backend,
           "served": out,
           "collectives": {a: starts[i + 1] - starts[i]
                           for i, a in enumerate(ARCHS)}}
    torch.save(rec, f"{tmp}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


# -------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def reference():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # as each rank runs
    try:
        return served(lambda arch: DriftServeEngine(arch=arch, bucket=BUCKET,
                                                    device="cpu"))
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both groups spawned together; every rank's record, by group."""
    ctx = mp.get_context("spawn")
    tmps = {g: tmp_path_factory.mktemp(g) for g in MESHES}
    procs = [ctx.Process(target=_rank_main, args=(r, mp_, str(tmps[g])))
             for g, mp_ in MESHES.items() for r in range(WORLD)]
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
    assert codes == [0] * len(procs), codes
    return {g: [torch.load(tmps[g] / f"rank{r}.pt", weights_only=False)
                for r in range(WORLD)] for g in MESHES}


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("group", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_served_equal_on_mesh(arch, group, groups, reference):
    """Every rank of the group serves ``arch``'s stat_abft and faulty
    requests exactly as one process does, every field of every result
    (tokens, detections, rollbacks, evaluations, joules and their ledger,
    the monitor's state after each batch) and the engine's monitor after;
    its weights really were gathered (collectives > 0). stat_abft detects
    and rolls back to the clean tokens where the arch has a protected
    GEMM (mamba2-370m has none)."""
    want = reference[arch]
    for rec in groups[group]:
        assert rec["mesh"] == {"data": WORLD // MESHES[group],
                               "model": MESHES[group]}
        assert rec["backend"] == "gloo"
        assert rec["collectives"][arch] > 0
        assert rec["served"][arch] == want
    for r in want["results"]:
        assert len(r["tokens"]) == TOKENS
        assert ledger_total(r["energy_breakdown"]) == r["energy_j"]
        if r["mode"] == "stat_abft":
            assert r["token_match_vs_clean"] == 1.0
            assert (r["ar_detections"] > 0 and r["ar_rollbacks"] >= 1) \
                == (arch != "mamba2-370m")
        else:
            assert r["ar_rollbacks"] == 0


@pytest.mark.parametrize("arch,model_parallel,mesh", [
    ("olmo-1b", 1, {"data": 2, "model": 1}),
    ("deepseek-moe-16b", 2, {"data": 1, "model": 2})])
def test_sharded_lm_cli(arch, model_parallel, mesh, tmp_path):
    """``launch.serve --sharded`` with an LM arch on 2 CPU ranks under
    ``torch.distributed.run``: exit 0, rank 0 alone prints the mesh line
    and each request's line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), "-m", "repro_torch.launch.serve",
         "--sharded", "--model-parallel", str(model_parallel), "--arch",
         arch, "--device", "cpu", "--steps", "4"],
        capture_output=True, text=True, timeout=JOIN_S, env=env,
        cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count(f"[serve] mesh {mesh} backend gloo") == 1
    for i in range(2):
        assert out.stdout.count(f"  req {i} ") == 1
    assert "match-vs-clean 1.000" in out.stdout
