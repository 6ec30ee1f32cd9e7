"""The harness on the CPU at the port's SMOKE sizes: the result line, the
cells and metrics found by name, the plain reference against the port,
the controls and the planted faults that ``correct`` has to catch."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from drift_bench import check, control, devtrace, harness, spec

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SEED = 2 ** 31 + 12345
CELLS = ("dit-xl-512.b16.undervolt", "pixart-alpha.b16.undervolt",
         "dit-xl-512.b16.uv-safe")


def smoke_cell(name, root=ROOT, bench=None):
    """The cell with its configuration cut to the port's SMOKE sizes and
    a bucket of 2; its traffic, limits and metrics as they are."""
    from repro_torch import configs
    cell = spec.load(name, root=root, bench=bench)
    port = configs.get_config(cell.config["arch"], smoke=True)
    cell.config.update(
        n_layers=port.n_layers, d_model=port.d_model, n_heads=port.n_heads,
        head_dim=port.hd, d_ff=port.d_ff, latent_size=port.latent_size,
        num_classes=port.num_classes, cond_tokens=port.cond_tokens,
        cond_dim=port.cond_dim, dtype="float32")
    cell.traffic["bucket"] = 2
    return cell


def one_batch(cell, **kw):
    torch.manual_seed(0)
    return harness.run_cell(cell, SEED, 0.0, False, device="cpu",
                            smoke=True, log=sys.stderr, **kw)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name):
    line = one_batch(smoke_cell(name))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "check"]
    assert line["correct"] is True
    assert line["attempted"] == 2 and line["failed"] == 0
    # no device memory on the CPU: peak_mem_gb is left out
    assert set(line["metrics"]) == {"images_per_s", "setup_s"}
    assert line["device"]["platform"] == "cpu"
    for k, v in line["check"].items():
        assert v["value"] == 0.0, (k, v)
        assert v["limit"] is not None


@pytest.mark.parametrize("name", CELLS[:2])
def test_int4_reference_control_fails(name):
    out = control.int4_reading(smoke_cell(name), SEED, torch.device("cpu"))
    assert out["correct"] is False
    assert out["check"]["drift_eps_rel"] > 0.15
    assert out["check"]["clean_eps_rel"] > 0.15
    assert out["check"]["gemm_out_max_abs"] > 0.0
    assert out["check"]["gemm_ckpt_max_abs"] > 0.0


def test_program_narrowed_plan_control_fails():
    out = control.program_reading(smoke_cell(CELLS[0]), SEED, "cpu",
                                  control.PLAN, smoke=True)
    assert out["correct"] is False
    assert out["check"]["ddim_max_abs"] > 0.02


def _step_unchanged(monkeypatch):
    from repro_torch.diffusion import schedule
    monkeypatch.setattr(schedule.DdpmSchedule, "ddim_step",
                        lambda self, x_t, eps, t, t_prev: x_t)


def _half_batch(monkeypatch):
    """The model evaluates the first half of the batch; the second half's
    noise is the mean of the first's."""
    from repro_torch.models import dit
    orig = dit.forward

    def forward(cfg, params, latents, t, cond, drift=None, text=None):
        eps, stats = orig(cfg, params, latents, t, cond, drift=drift,
                          text=text)
        h = eps.shape[0] // 2
        eps = eps.clone()
        eps[h:] = eps[:h].mean(0, keepdim=True)
        return eps, stats
    monkeypatch.setattr(dit, "forward", forward)


def _answer_altered(monkeypatch):
    """One latent of the final step's output moved by 0.1."""
    from repro_torch.diffusion import schedule
    orig = schedule.DdpmSchedule.ddim_step

    def step(self, x_t, eps, t, t_prev):
        out = orig(self, x_t, eps, t, t_prev)
        if t_prev < 0:
            out = out.clone()
            out.view(-1)[7] += 0.1
        return out
    monkeypatch.setattr(schedule.DdpmSchedule, "ddim_step", step)


def _splice_skipped(monkeypatch):
    """The fused DRIFT GEMM returns its faulted output uncorrected: no
    difference reaches its threshold (only INT32_MIN's would)."""
    from repro_torch.core import exec_ctx
    orig = exec_ctx.drift_gemm_fused

    def fused(aq, bq, flips, sx, sw, ckpt, threshold, union, valid):
        if flips is not None:
            threshold = 2 ** 31 - 1
        return orig(aq, bq, flips, sx, sw, ckpt, threshold, union, valid)
    monkeypatch.setattr(exec_ctx, "drift_gemm_fused", fused)


def _ckpt_not_written(monkeypatch):
    """The checkpoint store is never refreshed."""
    from repro_torch.core import exec_ctx
    monkeypatch.setattr(exec_ctx.ExecContext, "_write_ckpt",
                        lambda self, name, y: None)


@pytest.mark.parametrize("fault", [
    _step_unchanged, _half_batch, _answer_altered, _splice_skipped,
    _ckpt_not_written],
    ids=["step_unchanged", "half_batch", "answer_altered", "splice_skipped",
         "ckpt_not_written"])
def test_planted_fault_is_not_correct(monkeypatch, fault):
    c = smoke_cell(CELLS[0])
    fault(monkeypatch)
    line = one_batch(c)
    assert line["correct"] is False, line["check"]


def test_gemm_samples_cover_the_faulted_steps():
    cell = smoke_cell(CELLS[1])
    tr = cell.traffic
    plan = check.gemm_plan(SEED, cell.config, tr)
    assert plan == check.gemm_plan(SEED, cell.config, tr)
    assert plan != check.gemm_plan(SEED + 1, cell.config, tr)
    steps = range(tr["nominal_steps"], tr["steps"])
    assert [s.step for s in plan] == [s for s in steps
                                      for _ in range(check.GEMMS_PER_STEP)]
    for s in plan:
        assert 1 <= s.scope < cell.config["n_layers"]
        assert s.r0 % 32 == 0 and 0 < s.rows <= check.BAND_ROWS
        assert s.r0 + s.rows <= s.m
    for step in steps:
        sites = [(s.scope, s.name) for s in plan if s.step == step]
        assert len(set(sites)) == len(sites)


@pytest.mark.parametrize("key,value", [
    ("loop", "open"), ("images_per_request", 2), ("mode", "clean"),
    ("arrivals", "poisson")])
def test_traffic_the_harness_does_not_run_raises(key, value):
    cell = smoke_cell(CELLS[0])
    cell.traffic[key] = value
    with pytest.raises(ValueError, match=key):
        one_batch(cell)


def test_cell_and_metric_added_as_files_are_found(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = tmp_path / "drift_bench"
    for sub in ("configs", "traffic", "checks", "metrics"):
        shutil.copytree(BENCH / sub, bench / sub)
    spec_ = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec_["workloads"].append(
        {"name": "dit-xl-512.b2.test", "config": "dit-xl-512",
         "traffic": "b2.test", "chips": 1, "why": "a test"})
    spec_["per_layer"].append(
        {"name": "batches_seen", "unit": "batches", "better": "higher",
         "source": "host_clock", "layer": "engine (serving/engine.py)",
         "moves": "images_per_s", "workloads": ["dit-xl-512.b2.test"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec_))
    traffic = json.loads((BENCH / "traffic" / "b16.uv-safe.json")
                         .read_text())
    (bench / "traffic" / "b2.test.json").write_text(
        json.dumps(dict(traffic, bucket=2)))
    (bench / "metrics" / "batches_seen.py").write_text(
        "def read(run):\n    return float(len(run.batches))\n")
    cell = smoke_cell("dit-xl-512.b2.test", root=tmp_path, bench=bench)
    assert cell.traffic["bucket"] == 2 and cell.limits == {}
    assert [m["name"] for m in cell.per_layer] == ["batches_seen"]
    line = harness.run_cell(cell, SEED, 0.0, True, device="cpu", smoke=True)
    assert line["metrics"] == {"batches_seen": {"value": 1.0,
                                                "unit": "batches"}}
    assert line["correct"] is False          # no limits of its own


def test_run_exits_without_a_card(tmp_path):
    """No CUDA device here: a non-zero exit and no result on stdout; the
    same from a directory holding only the benchmark's own files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "drift_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for root in (ROOT, tmp_path):
        p = subprocess.run(
            [sys.executable, "drift_bench/run.py", "--workload", CELLS[0],
             "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
            cwd=root, capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout == "", (root, p.stderr)


def test_trace_reduction():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 20.0), ("a", 30.0, 40.0)]
    spans = [("engine.run", 0.0, 35.0), ("synchronize", 35.0, 50.0)]
    t = devtrace.Trace(ops=ops, window_s=50e-6, spans=spans, launches={},
                       drift_evals=1, clean_evals=1, corrected=0)
    assert t.busy_s() == pytest.approx(30e-6)
    assert t.time_s("a") == pytest.approx(20e-6)
    assert t.top_ops() == [["a", pytest.approx(20e-6)],
                           ["b", pytest.approx(15e-6)]]
    gaps = t.idle_gaps()
    assert gaps[0] == ["engine.run after b", pytest.approx(10e-6)]
    assert gaps[1] == ["synchronize after a", pytest.approx(10e-6)]
