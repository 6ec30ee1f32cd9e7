"""DRIFT serving launcher on PyTorch: thin CLI over ``repro_torch.serving``.

    PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \\
        --batch 2 --steps 10 --mode drift --op undervolt
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --no-smoke --steps 16 --rollback-interval 4

Submits ``--requests`` generation requests (default: one bucket's worth) to
one engine and prints the per-request results: for diffusion archs quality
vs the engine's cached clean reference, rollback-corrected elements and
model evaluations; for autoregressive archs the generated tokens, their
match against the clean decode, detections, rolled-back windows and model
evaluations. ``--mode`` defaults to ``drift`` for diffusion archs and to
``stat_abft`` (statistical ABFT with KV-window rollback) for
autoregressive ones. ``--taylorseer`` and ``--precision`` (diffusion
only) forecast two of every three denoising steps and narrow the
resilient body's output on resilient steps.

``--stream K`` streams each batch: a latent preview (a ``[preview]`` line)
for every live request after each K denoising steps, before the final
results, whose latents are bit-identical to the unstreamed path.
``--offload`` snapshots the rollback checkpoints between windows into
pinned host memory on a side CUDA stream (an ``offload:`` line sums the
commits), and ``--rollback-interval auto`` lets the offload planner pick
the refresh interval.

``--priority`` / ``--deadline`` / ``--step-budget`` / ``--energy-budget``
/ ``--quality-floor`` route submissions through
``serving.scheduler.DeadlineScheduler``, which prints one ``[admission]``
line per request: its completion is projected on the engine's virtual
clock, and it is kept as asked, overclocked, step-trimmed, resolved on
the Pareto frontier (``serving.frontier``) or rejected.

Telemetry and the flight recorder are on unless ``--no-telemetry`` is
given (which turns telemetry off; the recorder stays on, as in the
reference). ``--metrics-port PORT`` serves ``/metrics``, ``/healthz``,
``/slo``, SSE ``/events`` and ``/trace/<id>`` for the run (0 binds an
ephemeral port, printed at startup), and ``--trace-dir DIR`` writes the
flight recorder's spans as Chrome trace JSON to ``DIR/flight.json``.

Each result's ``perfmodel/request:`` line is the perfmodel's attribution
(``perfmodel.energy.per_request_cost``): baseline and billed joules and
seconds, with the energy saving and speedup. Like the engine line's
virtual ``clock``, these are the modeled paper accelerator's numbers,
not measurements of the GPU the port runs on.

Its flags are ``repro.launch.serve``'s but for ``--sharded`` and
``--model-parallel`` (ROADMAP Queue A 13), plus ``--device``
(default "cuda"; without a GPU the engine raises). ``--smoke/--no-smoke``
is a real switch (default on, like the reference CLI); ``--no-smoke``
serves the full-width model. ``main(argv, engine=...)`` serves
through an injected engine, whose bucket, device and params then win.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Optional, Sequence

from repro_torch.core import dvfs as dvfs_lib
from repro_torch.core.quant import PRECISION_PLANS
from repro_torch.core.rollback import DEFAULT_INTERVAL
from repro_torch.serving import (DeadlineScheduler, DriftServeEngine,
                                 EngineTelemetry, OffloadConfig,
                                 serve_telemetry)
from repro_torch.serving.request import (REQUEST_OPS, REQUEST_PRIORITIES,
                                         PreviewEvent)
from repro_torch.serving.servable import paradigm_for
from repro_torch.serving.trace import write_chrome_trace

OP_LADDER_HELP = " -> ".join(p.name for p in dvfs_lib.OP_LADDER)


def positive_int(value: str) -> int:
    iv = int(value)
    if iv < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {value}")
    return iv


def rollback_interval_arg(value: str):
    """--rollback-interval parser: a positive int or 'auto' (the offload
    planner picks per configuration)."""
    if value.strip().lower() == "auto":
        return "auto"
    iv = int(value)
    if iv < 1:
        raise argparse.ArgumentTypeError(
            f"rollback interval must be >= 1 or 'auto', got {value}")
    return iv


def default_mode_for(arch: str) -> str:
    """``drift`` for diffusion archs, ``stat_abft`` for autoregressive."""
    return "drift" if paradigm_for(arch) == "diffusion" else "stat_abft"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="Serve DRIFT diffusion or autoregressive requests on "
                    "PyTorch through one batching engine.",
        epilog=f"DVFS ladder (op 'auto', walked by the BER monitor): "
               f"{OP_LADDER_HELP}.")
    ap.add_argument("--arch", default="dit-xl-512",
                    help="model to serve (ported: dit-xl-512, diffusion; "
                         "olmo-1b, autoregressive)")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the 3-layer smoke config (--no-smoke: the "
                         "full-width model)")
    ap.add_argument("--batch", type=positive_int, default=2,
                    help="micro-batch bucket size")
    ap.add_argument("--requests", type=int, default=0,
                    help="requests to submit (0 = one bucket's worth)")
    ap.add_argument("--steps", type=positive_int, default=10,
                    help="denoising steps (diffusion) or tokens to decode "
                         "(autoregressive)")
    ap.add_argument("--mode", default=None,
                    choices=["clean", "faulty", "drift", "stat_abft"],
                    help="protection mode (default: 'drift' for diffusion "
                         "archs, 'stat_abft' for autoregressive ones, which "
                         "take clean/faulty/stat_abft only)")
    ap.add_argument("--op", default="undervolt", choices=list(REQUEST_OPS),
                    help="DVFS operating point; 'auto' walks the BER-monitor "
                         f"ladder ({OP_LADDER_HELP})")
    ap.add_argument("--rollback-interval", type=rollback_interval_arg,
                    default=DEFAULT_INTERVAL, metavar="N|auto",
                    help="rollback checkpoint-refresh interval in steps "
                         "(autoregressive: the KV rollback window in "
                         f"tokens; default: {DEFAULT_INTERVAL}); 'auto' "
                         "lets the offload planner pick per (arch, op, "
                         "steps, bucket) from modeled energy+stall at the "
                         "monitor's target detection rate")
    ap.add_argument("--offload", action="store_true",
                    help="offload rollback checkpoints to a host-side "
                         "double buffer asynchronously, overlapped with "
                         "the next denoising window (tile-contiguous "
                         "layout; finals stay bit-identical)")
    ap.add_argument("--stream", type=int, default=0, metavar="K",
                    help="stream a latent preview every K denoising steps "
                         "(0 = off); final latents are bit-identical to "
                         "the unstreamed path")
    ap.add_argument("--taylorseer", action="store_true",
                    help="TaylorSeer (diffusion only): compute every third "
                         "denoising step, forecast the others")
    ap.add_argument("--precision", default="int8",
                    choices=sorted(PRECISION_PLANS),
                    help="precision plan for the resilient denoiser body "
                         "(diffusion only); 'int8' is the baseline path")
    ap.add_argument("--priority", default="standard",
                    choices=list(REQUEST_PRIORITIES),
                    help="scheduling class for all submitted requests; "
                         "interactive buckets form before standard before "
                         "background")
    ap.add_argument("--deadline", type=float, default=None, metavar="SEC",
                    help="per-request relative deadline in engine virtual "
                         "(perfmodel) seconds; enables deadline-aware "
                         "admission control -- requests get overclocked or "
                         "step-trimmed to fit, or rejected when hopeless")
    ap.add_argument("--step-budget", type=int, default=None, metavar="N",
                    help="cap denoising steps per request (the scheduler "
                         "may trim further for a deadline)")
    ap.add_argument("--energy-budget", type=float, default=None,
                    metavar="J",
                    help="per-request energy budget in modeled joules; "
                         "routes admission through the compute-optimal "
                         "(steps x precision x TaylorSeer x DVFS) frontier")
    ap.add_argument("--quality-floor", type=float, default=None,
                    metavar="Q",
                    help="minimum quality proxy in (0, 1]; frontier "
                         "admission picks the fastest point at or above it")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve the telemetry HTTP front end (/metrics, "
                         "/healthz, /slo, SSE /events, /trace/<id>) on "
                         "127.0.0.1:PORT for the run (0 = ephemeral, "
                         "printed at startup; omit = no server)")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="write the flight recorder's spans as Chrome "
                         "trace-event JSON to DIR/flight.json after the "
                         "drain")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="disable telemetry (metrics, learned latency "
                         "estimates, the BER guardband); explicit-op "
                         "serving is bit-identical, op=auto loses the "
                         "guardband floor")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; there is no CPU "
                         "fallback)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv: Optional[Sequence[str]] = None,
         engine: Optional[DriftServeEngine] = None) -> list:
    args = build_parser().parse_args(argv)
    eng = engine if engine is not None else DriftServeEngine(
        arch=args.arch, smoke=args.smoke, bucket=args.batch,
        base_seed=args.seed, device=args.device,
        offload=OffloadConfig() if args.offload else None,
        telemetry=EngineTelemetry(enabled=not args.no_telemetry))
    server = None
    if args.metrics_port is not None:
        server = serve_telemetry(eng, port=args.metrics_port)
        print(f"[serve] telemetry at {server.url} "
              f"(/metrics /healthz /slo /events /trace/<id>)")
    try:
        return _drive(args, eng, server)
    finally:
        # main() is also called in-process: never leak the bound port or
        # the server thread when the drain raises
        if server is not None:
            server.close()


def _drive(args, eng, server) -> list:
    mode = args.mode or default_mode_for(args.arch)
    bucket = eng.batcher.bucket
    n_requests = args.requests or bucket
    use_scheduler = (args.deadline is not None
                     or args.priority != "standard"
                     or args.step_budget is not None
                     or args.energy_budget is not None
                     or args.quality_floor is not None)
    sched = DeadlineScheduler(eng) if use_scheduler else None
    fields = dict(arch=args.arch, smoke=args.smoke, steps=args.steps,
                  mode=mode, op=args.op, taylorseer=args.taylorseer,
                  precision=args.precision,
                  rollback_interval=args.rollback_interval)
    # hold the server's engine lock from the first submission through the
    # drain: a concurrent /events client gets a 503
    drain_lock = (server.engine_lock if server is not None
                  else contextlib.nullcontext())
    with drain_lock:
        for i in range(n_requests):
            if sched is None:
                eng.submit(seed=args.seed + i, **fields)
                continue
            adm = sched.submit(seed=args.seed + i, priority=args.priority,
                               deadline_s=args.deadline,
                               step_budget=args.step_budget,
                               energy_budget_j=args.energy_budget,
                               quality_floor=args.quality_floor, **fields)
            knobs = f"op {adm.op}, {adm.steps} steps"
            if adm.action == "frontier":
                knobs += (f", {adm.precision}, taylorseer "
                          f"{'on' if adm.taylorseer else 'off'}, quality "
                          f"{adm.quality:.3f}, {adm.projected_energy_j:.4f}J "
                          "projected (modeled)")
            print(f"[admission] req {adm.request_id}: {adm.action} ({knobs})"
                  + (f" -- {adm.reason}" if adm.reason else ""))
        t0 = time.perf_counter()
        previews = 0
        if args.stream:
            results = []
            for ev in eng.run_stream(args.stream):
                if isinstance(ev, PreviewEvent):
                    previews += 1
                    print(f"  [preview] req {ev.request_id} step "
                          f"{ev.step}/{ev.total_steps}")
                else:
                    results.append(ev)
            results.sort(key=lambda r: r.request_id)
        else:
            results = eng.run()
        wall = time.perf_counter() - t0

    print(f"[serve] {args.arch} smoke={args.smoke} mode={mode} "
          f"op={args.op} steps={args.steps} taylorseer={args.taylorseer} "
          f"precision={args.precision} requests={n_requests} "
          f"bucket={bucket} device={eng.device} wall={wall:.2f}s"
          + (f" previews={previews}" if args.stream else ""))
    for r in results:
        head = (f"  req {r.request_id} (batch {r.batch_index}, op {r.op}, "
                f"{r.priority}): ")
        miss = "  DEADLINE MISSED" if r.deadline_missed else ""
        if r.tokens is not None:
            print(head + f"tokens {list(r.tokens)}  match-vs-clean "
                  f"{r.token_match_vs_clean:.3f}  abft-detections "
                  f"{r.ar_detections}  kv-rollbacks {r.ar_rollbacks}  "
                  f"evals {r.n_model_evals}{miss}")
        else:
            print(head + f"lpips-proxy {r.lpips_vs_clean:.4f}  "
                  f"psnr {r.psnr_vs_clean_db:.2f} dB  "
                  f"corrected(batch) {r.batch_corrected_elems}  "
                  f"evals {r.n_model_evals}{miss}")
        print(f"    perfmodel/request (modeled accelerator): baseline "
              f"{r.baseline_energy_j:.4f}J/{r.baseline_latency_s:.4f}s -> "
              f"{r.energy_j:.4f}J/{r.latency_s:.4f}s "
              f"({100 * (1 - r.energy_j / r.baseline_energy_j):.1f}% energy, "
              f"{r.baseline_latency_s / r.latency_s:.2f}x speed)")
    print(f"  engine: {eng.cache.builds} sampler builds, {eng.cache.hits} "
          f"cache hits, {eng.stats.batches} batches, "
          f"{eng.stats.padded_slots} padded slots; monitor "
          f"ber={float(eng.monitor.ema_ber):.2e} "
          f"ladder={int(eng.monitor.op_index)}; modeled clock "
          f"{eng.clock_s:.4f}s, {eng.stats.deadline_misses} deadline misses")
    if eng.offload_store is not None:
        ost = eng.offload_store.stats
        print(f"  offload: {ost.commits} commits "
              f"({ost.bytes_offloaded / 1e6:.2f} MB tile-contiguous), "
              f"{ost.skipped} spike-skipped, {ost.restores} restores; "
              f"last committed step {eng.offload_store.committed_step}")
    if sched is not None:
        s = sched.stats
        print(f"  scheduler: {s.admitted}/{s.submitted} admitted "
              f"({s.rejected} rejected, {s.escalated_op} op-escalated, "
              f"{s.trimmed_steps} step-trimmed, {s.frontier_selected} "
              f"frontier-selected, {s.projected_misses} projected misses)")
    tele = eng.telemetry
    if tele.enabled:
        ctrl = tele.controller
        print(f"  telemetry: {tele.estimator.total_observations} latency "
              f"observations over {len(tele.estimator)} configs; guardband "
              f"floor {ctrl.guard_index if ctrl else 0} "
              f"({ctrl.guard_op_name() if ctrl else 'n/a'})")
        if tele.ledger.batches:
            top = sorted(tele.ledger.shares().items(),
                         key=lambda kv: -kv[1])[:3]
            burning = tele.slo.breached_objectives()
            print(f"  energy (modeled): "
                  f"{tele.ledger.energy_per_request_j():.4f} J/request ("
                  + ", ".join(f"{c} {s:.0%}" for c, s in top)
                  + "); slo breached: "
                  + (", ".join(burning) if burning else "none"))
    if args.trace_dir is not None:
        os.makedirs(args.trace_dir, exist_ok=True)
        path = os.path.join(args.trace_dir, "flight.json")
        write_chrome_trace(path, eng.tracer.spans())
        print(f"  trace: {len(eng.tracer)} spans -> {path}")
    return results


if __name__ == "__main__":
    main()
