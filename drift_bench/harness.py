"""One run of one cell: set-up, the measured window, the traced batch, the
comparison with the plain reference, and the result line.

The window drives the port's public entry, ``repro_torch.serving.
DriftServeEngine``: each loop submits one bucket of one-image requests,
each with its own seed from the run seed, calls ``engine.run()`` and takes
the results. The loop is closed and saturated (bulk generation, the queue
never empty); no batch starts after ``seconds``, and the window ends when
the last batch has finished, so every rate counts whole batches over the
whole window.

Set-up makes the weights from the seed on the device
(``drift_bench.weights``) and hands them to the engine with
``set_params``, makes the flip pool (``drift_bench.flips``) the engine
draws its masks from, and serves one warm batch of the cell's own key
(other seeds), which builds every kernel and draws every mask shape.

With ``trace``, one more batch runs after the window under
``torch.profiler`` (CUDA activity only); the per-layer readers take the
device trace of that batch and the counts and host time of the window.

Once the window has closed, its peak memory read and the engine freed,
the plain reference checks the batch that ``drift_bench.tap`` recorded
(``drift_bench.check``).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import sys
import time
from typing import Dict, List, Optional

from drift_bench import check, devtrace, flips, seeds, weights
from drift_bench.reference import REFERENCES
from drift_bench.spec import BENCH, Cell
from drift_bench.tap import Tap



@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    peaks: dict
    setup_s: float
    window_s: float
    images: int
    batch_walls: List[float]
    # per window batch: drift evaluations, corrected elements
    batches: List[dict]
    clean_evals: int
    launches: Dict[str, int]
    memory_peak_bytes: int
    pool_bytes: int
    trace: Optional[devtrace.Trace] = None


def _launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import flash_attention, ops
    return {"drift_gemm_fused": ops.launches,
            "flash_attention": flash_attention.launches}


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


def _check_widths(port_cfg, cfg: dict) -> None:
    """The port's configuration of the arch against the cell's file."""
    port = {"n_layers": port_cfg.n_layers, "d_model": port_cfg.d_model,
            "n_heads": port_cfg.n_heads, "head_dim": port_cfg.hd,
            "d_ff": port_cfg.d_ff, "latent_size": port_cfg.latent_size,
            "latent_channels": port_cfg.latent_channels,
            "patch_size": port_cfg.patch_size,
            "num_classes": port_cfg.num_classes,
            "cond_tokens": port_cfg.cond_tokens,
            "cond_dim": port_cfg.cond_dim,
            "dtype": str(port_cfg.dtype).replace("torch.", "")}
    wrong = {k: (v, cfg[k]) for k, v in port.items() if cfg[k] != v}
    if wrong:
        raise ValueError(f"the port's {cfg['arch']} differs from the cell's "
                         f"configuration (port, cell): {wrong}")


#: the traffic keys the harness implements, and the values it takes where
#: it takes only some
TRAFFIC_KEYS = {"loop", "bucket", "images_per_request", "steps", "mode",
                "op", "ber", "nominal_steps", "rollback_interval",
                "precision", "check_clean_steps", "why"}
TRAFFIC_VALUES = {"loop": ("closed",), "images_per_request": (1,),
                  "mode": ("drift",)}


def check_traffic(tr: dict) -> None:
    """Raise where a traffic file asks for what the harness does not run:
    a key it does not know, or a value it does not implement."""
    unknown = sorted(set(tr) - TRAFFIC_KEYS)
    missing = sorted(TRAFFIC_KEYS - set(tr))
    if unknown or missing:
        raise ValueError(f"traffic keys unknown to the harness: {unknown}; "
                         f"missing: {missing}")
    for k, allowed in TRAFFIC_VALUES.items():
        if tr[k] not in allowed:
            raise ValueError(f"traffic {k}={tr[k]!r}: the harness runs "
                             f"only {allowed}")


class _Clock:
    """Host spans, in wall-clock nanoseconds (the profiler's clock)."""

    def __init__(self):
        self.spans: List[devtrace.Span] = []

    def span(self, name: str, start_ns: int) -> None:
        self.spans.append((name, start_ns, time.time_ns()))

    def relative(self, t0_ns: int) -> List[devtrace.Span]:
        """The spans in microseconds from ``t0_ns``."""
        return [(n, (s - t0_ns) / 1e3, (e - t0_ns) / 1e3)
                for n, s, e in self.spans]


def _serve(engine, req_seeds, request: dict, clock: Optional[_Clock] = None):
    t = time.time_ns()
    for s in req_seeds:
        engine.submit(seed=s, **request)
    if clock:
        clock.span("submit", t)
        t = time.time_ns()
    out = engine.run()
    if clock:
        clock.span("engine.run", t)
    return out


def _clean_sample(engine):
    """The engine's newest clean-reference sample (its LRU's last entry),
    the one of the batch that just ended."""
    return next(reversed(engine._clean_samples.values()))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", smoke: bool = False,
             t_start: Optional[float] = None, log=sys.stderr,
             request_overrides: Optional[dict] = None) -> dict:
    """One run; returns the result line as a dict (``check`` last).
    ``smoke`` serves the port's SMOKE configuration of the arch (the
    cell's file then has to give SMOKE's sizes); ``request_overrides``
    replaces request fields (the control's precision plan)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    from repro_torch import configs as port_configs
    from repro_torch.serving import DriftServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, tr = cell.config, cell.traffic
    check_traffic(tr)
    _check_widths(port_configs.get_config(cfg["arch"], smoke=smoke), cfg)
    bucket, arch = int(tr["bucket"]), cfg["arch"]
    request = dict(arch=arch, smoke=smoke, steps=tr["steps"],
                   mode=tr["mode"], op=tr["op"], precision=tr["precision"],
                   rollback_interval=tr["rollback_interval"])
    request.update(request_overrides or {})
    peaks = json.loads((BENCH / "peaks.json").read_text())
    phases = _Phases(t_start, log)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # ------------------------------------------------------------ set-up
    phases.mark("imports")
    pool = flips.FlipPool(seed, tr["ber"], dev)
    engine = DriftServeEngine(arch=arch, smoke=smoke, bucket=bucket,
                              nominal_steps=tr["nominal_steps"],
                              device=dev, flip_source_factory=pool.factory)
    engine.set_params(arch, smoke, weights.make(cfg, seed, dev))
    sync()
    phases.mark("engine and weights")
    tap = Tap(seeds.mix64(seed, seeds.SAMPLE_TAG), int(tr["steps"]),
              (bucket, cfg["latent_size"], cfg["latent_size"],
               cfg["latent_channels"]),
              check.gemm_plan(seeds.mix64(seed, seeds.GEMM_TAG), cfg, tr),
              dev)
    tap.install()
    try:
        _serve(engine, [seeds.request_seed(seed, seeds.WARM_TAG, j)
                        for j in range(bucket)], request)
        sync()
        pool.freeze()
        phases.mark("warm batch")
        print(f"flip pool: {pool.nbytes} bytes in {len(pool.masks)} "
              "shapes", file=log)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - t_start

        # -------------------------------------------------------- window
        launches0 = _launch_counts()
        clean0 = engine.stats.clean_samples_computed
        walls, batches = [], []
        n_req = images = 0
        t_w = time.perf_counter()
        while True:
            req_seeds = [seeds.request_seed(seed, seeds.REQUEST_TAG,
                                            n_req + j) for j in range(bucket)]
            n_req += bucket
            t_b = time.perf_counter()
            tap.begin()
            res = _serve(engine, req_seeds, request)
            tap.end(res, _clean_sample(engine), req_seeds)
            walls.append(time.perf_counter() - t_b)
            images += len(res)
            batches.append(dict(drift_evals=res[0].n_model_evals,
                                corrected=res[0].batch_corrected_elems))
            del res
            if time.perf_counter() - t_w >= seconds:
                break
        sync()
        window_s = time.perf_counter() - t_w
        mem_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
        launches = _delta(_launch_counts(), launches0)
        clean_evals = (engine.stats.clean_samples_computed - clean0) \
            * tr["steps"]
        print(f"batches: {len(walls)}, walls_s {walls}", file=log)
        phases.mark("window")
        run = Run(cell=cell, peaks=peaks, setup_s=setup_s,
                  window_s=window_s, images=images, batch_walls=walls,
                  batches=batches,
                  clean_evals=clean_evals, launches=launches,
                  memory_peak_bytes=mem_peak, pool_bytes=pool.nbytes)
        if trace and cuda:
            run.trace = devtrace.Trace(**_traced_batch(
                engine, [seeds.request_seed(seed, seeds.TRACE_TAG, j)
                         for j in range(bucket)], request, sync))
            phases.mark("traced batch")
            print(f"traced batch wall {run.trace.window_s:.3f} s, busy "
                  f"{run.trace.busy_s():.3f} s; the window's median batch "
                  f"wall {statistics.median(walls):.3f} s", file=log)

        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = cell.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    finally:
        tap.uninstall()

    # ----------------------------------------------------- output comparison
    rec = tap.kept
    attempted, failed = n_req, n_req - images
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    sync()
    t_ref = time.perf_counter()
    nums = reference_numbers(cell, seed, dev, rec, pool, log=log)
    print(f"setup_s {setup_s:.3f}, window_s {window_s:.3f}, reference_s "
          f"{time.perf_counter() - t_ref:.3f}, memory_peak_bytes {mem_peak}",
          file=log)
    correct, rows = check.judge(nums, cell.limits)

    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics,
            "device": {"platform": "gpu" if cuda else "cpu",
                       "kind": (torch.cuda.get_device_name(dev) if cuda
                                else "cpu"),
                       "count": cell.chips,
                       "memory_peak_bytes": mem_peak}}
    if run.trace is not None:
        line["device"]["busy_s"] = run.trace.busy_s()
        line["device"]["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.top_ops(),
                             "idle_gaps": run.trace.idle_gaps()}
    line["check"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return line


class _Phases:
    """Host seconds of a run's phases, printed as each ends."""

    def __init__(self, t0: float, log):
        self.t = t0
        self.log = log

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name}: {now - self.t:.3f} s", file=self.log)
        self.t = now


def _traced_batch(engine, req_seeds, request, sync) -> dict:
    """One batch after the window, under the profiler (CUDA activity
    only, the profiler started once before it so that its own start-up
    is not traced): its device operations, host spans and counts."""
    from torch.profiler import ProfilerActivity, profile
    import torch
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device=engine.device).add_(1)
        sync()
    launches0 = _launch_counts()
    clean0 = engine.stats.clean_samples_computed
    clock = _Clock()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_start = time.perf_counter()
        res = _serve(engine, req_seeds, request, clock)
        t = time.time_ns()
        sync()
        clock.span("synchronize", t)
        window_s = time.perf_counter() - t_start
    t0_ns, ops = devtrace.device_ops(prof)
    return dict(ops=ops, window_s=window_s, spans=clock.relative(t0_ns),
                launches=_delta(_launch_counts(), launches0),
                drift_evals=res[0].n_model_evals,
                clean_evals=(engine.stats.clean_samples_computed - clean0)
                * request["steps"],
                corrected=res[0].batch_corrected_elems)


def reference_numbers(cell: Cell, seed: int, dev, rec, pool: flips.FlipPool,
                      log=None) -> Dict[str, float]:
    """The plain reference over the recorded batch, from the weights,
    pool and request seeds the run made, against the program's outputs."""
    cfg, tr = cell.config, cell.traffic
    ref = REFERENCES[cfg["reference"]]
    params = weights.make(cfg, seed, dev)
    lat, cond, text = seeds.request_inputs(cfg, list(rec.seeds), dev)
    return check.numbers(
        ref, cfg, params, tr, rec, lat, cond, text,
        pool.factory(rec.batch_index),
        check.clean_steps(seeds.mix64(seed, seeds.CLEAN_STEP_TAG),
                          int(tr["steps"]), int(tr["check_clean_steps"])),
        log=log)
