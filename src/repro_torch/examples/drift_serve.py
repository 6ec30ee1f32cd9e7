"""Serve a stream of generation requests with mixed DVFS operating points,
priorities, and deadlines through one DRIFT serving engine, on PyTorch.

Counterpart of ``examples/drift_serve.py``, with its flags plus
``--device`` (default ``cuda``; ``--device cpu`` runs the kernels' plain
versions) and ``--smoke/--no-smoke`` (default: the SMOKE config).
``--arch`` picks any registered model: diffusion archs run the DRIFT
denoiser (mode ``drift``), autoregressive archs run token decoding with
statistical ABFT + KV-window rollback (mode ``stat_abft``) -- same
engine, queue, DVFS ladder, and monitor either way:

    PYTHONPATH=src python -m repro_torch.examples.drift_serve \\
        --arch olmo-1b --requests 2 --batch 2 --steps 8

Each request picks its own operating point (``--op`` is a comma-separated
list cycled across requests; ``auto`` defers to the engine's BER-monitor
ladder, ``core.dvfs.OP_LADDER``) and scheduling class (``--priority`` is
cycled the same way). The engine buckets same-configuration requests
into fixed-size micro-batches, builds each configuration's sampler once
(``serving.cache``; the reference's jit traces), reuses the cached clean
reference for quality metrics, and carries the BER monitor across
batches. Per-request energy and latency are the perfmodel's (the modeled
paper accelerator's, not the card's).

``--deadline`` (a cycled list like ``--op``; ``none`` = no deadline,
with optional ``--step-budget``) routes submissions through the
deadline-aware scheduler; ``--stream K`` yields latent previews every K
denoising steps ahead of the final results; ``--energy-budget`` /
``--quality-floor`` resolve admission against the Pareto frontier.
``--sharded`` runs the stream through ``ShardedDriftServeEngine`` on the
``torch.distributed`` ranks of the run (one rank: the plain engine);
``--metrics-port PORT`` serves the run's telemetry over HTTP and
``--no-telemetry`` switches the subsystem off; ``--trace-dir DIR``
writes the flight recorder to ``DIR/flight.json``.

After the drain it checks what the reference checks: at most one
sampler build per distinct configuration and one per clean reference,
cache hits once a configuration serves a second batch, and previews when
streaming.
"""
from __future__ import annotations

import argparse
import contextlib
import os
from typing import Optional

from repro_torch.core import dvfs as dvfs_lib
from repro_torch.core.rollback import DEFAULT_INTERVAL
from repro_torch.launch.serve import (arch_family_help, default_mode_for,
                                      rollback_interval_arg)
from repro_torch.serving import (DeadlineScheduler, DriftServeEngine,
                                 EngineTelemetry, OffloadConfig,
                                 ShardedDriftServeEngine, make_engine,
                                 serve_telemetry)
from repro_torch.serving.request import REQUEST_PRIORITIES, PreviewEvent
from repro_torch.serving.servable import paradigm_for
from repro_torch.serving.trace import write_chrome_trace

OP_LADDER_HELP = " -> ".join(p.name for p in dvfs_lib.OP_LADDER)


def build_parser():
    ap = argparse.ArgumentParser(
        prog="repro_torch.examples.drift_serve",
        description="Mixed-op / mixed-priority DRIFT serving demo.",
        epilog=f"The op 'auto' walks core.dvfs.OP_LADDER "
               f"({OP_LADDER_HELP}) via the engine's BER monitor.")
    ap.add_argument("--arch", default="dit-xl-512",
                    help="model to serve; paradigm comes from the "
                         f"ServableModel registry -- {arch_family_help()}")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--op", default="undervolt,overclock",
                    help="comma-separated operating points, cycled per "
                         "request (nominal/undervolt/overclock/auto; "
                         f"'auto' walks the ladder {OP_LADDER_HELP})")
    ap.add_argument("--priority", default="standard",
                    help="comma-separated scheduling classes "
                         f"({'/'.join(REQUEST_PRIORITIES)}), cycled per "
                         "request; non-standard classes enable the "
                         "deadline-aware scheduler")
    ap.add_argument("--deadline", default=None, metavar="SEC[,SEC|none...]",
                    help="comma-separated relative deadlines (engine "
                         "virtual seconds; 'none' = no deadline), cycled "
                         "per request; enables admission control with "
                         "op-escalation / step-trimming")
    ap.add_argument("--step-budget", type=int, default=None, metavar="N",
                    help="per-request cap on denoising steps")
    ap.add_argument("--energy-budget", type=float, default=None,
                    metavar="J",
                    help="per-request energy budget in Joules; admission "
                         "resolves against the compute-optimal (steps x "
                         "precision x TaylorSeer x DVFS) frontier")
    ap.add_argument("--quality-floor", type=float, default=None,
                    metavar="Q",
                    help="minimum quality proxy in (0, 1]; the frontier "
                         "picks the fastest point at or above it")
    ap.add_argument("--stream", type=int, default=0, metavar="K",
                    help="yield latent previews every K denoising steps "
                         "(0 = off)")
    ap.add_argument("--rollback-interval", type=rollback_interval_arg,
                    default=DEFAULT_INTERVAL, metavar="N|auto",
                    dest="rollback_interval",
                    help="rollback checkpoint-refresh interval "
                         f"(default: {DEFAULT_INTERVAL}, from "
                         "core.rollback.DEFAULT_INTERVAL); 'auto' = the "
                         "offload planner's per-configuration choice")
    ap.add_argument("--offload", action="store_true",
                    help="async host offload of rollback checkpoints, "
                         "overlapped with the next window")
    ap.add_argument("--sharded", action="store_true",
                    help="spread micro-batches across the ranks' mesh")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve /metrics, /healthz, and SSE /events over "
                         "HTTP for this run (0 = ephemeral port)")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="disable metrics + learned latency estimates + "
                         "the adaptive BER guardband (explicit-op serving "
                         "is bit-identical; auto loses the floor)")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="write the flight recorder as Chrome/Perfetto "
                         "trace JSON to DIR/flight.json after the run")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the smoke config (--no-smoke: the "
                         "full-width model)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    return ap


def main(argv: Optional[list] = None) -> list:
    args = build_parser().parse_args(argv)
    ops = [o.strip() for o in args.op.split(",") if o.strip()]
    priorities = [p.strip() for p in args.priority.split(",") if p.strip()]
    deadlines = [None if d.strip().lower() == "none" else float(d)
                 for d in args.deadline.split(",") if d.strip()] \
        if args.deadline is not None else [None]
    if not ops or not priorities or not deadlines:
        raise SystemExit("--op/--priority/--deadline need at least one "
                         "non-empty entry")
    if args.stream and paradigm_for(args.arch) != "diffusion":
        raise SystemExit("--stream previews are latent images; "
                         f"{args.arch} serves autoregressively (tokens "
                         "come back in the final results)")
    common = dict(arch=args.arch, smoke=args.smoke, bucket=args.batch,
                  device=args.device,
                  telemetry=EngineTelemetry(enabled=not args.no_telemetry),
                  offload=OffloadConfig() if args.offload else None)
    if args.sharded:
        engine = make_engine(model_parallel=args.model_parallel, **common)
    else:
        if args.model_parallel != 1:
            raise SystemExit("--model-parallel requires --sharded")
        engine = DriftServeEngine(**common)
    server = None
    if args.metrics_port is not None:
        server = serve_telemetry(engine, port=args.metrics_port)
        print(f"[drift_serve] telemetry at {server.url}")
    try:
        return _drive(args, engine, server, ops, priorities, deadlines)
    finally:
        # never leak the bound port or the server thread when the drain
        # or one of the self-asserts raises
        if server is not None:
            server.close()


def _drive(args, engine, server, ops, priorities, deadlines) -> list:
    use_scheduler = (args.deadline is not None
                     or args.step_budget is not None
                     or args.energy_budget is not None
                     or args.quality_floor is not None
                     or any(p != "standard" for p in priorities))
    sched = DeadlineScheduler(engine) if use_scheduler else None
    previews = 0
    # hold the server's engine lock from the first submission through the
    # drain: a concurrent /events client gets a 503
    drain_lock = server.engine_lock if server is not None \
        else contextlib.nullcontext()
    mode = default_mode_for(args.arch)
    with drain_lock:
        for i in range(args.requests):
            fields = dict(arch=args.arch, smoke=args.smoke, steps=args.steps,
                          mode=mode, op=ops[i % len(ops)], seed=i,
                          rollback_interval=args.rollback_interval)
            if sched is not None:
                adm = sched.submit(priority=priorities[i % len(priorities)],
                                   deadline_s=deadlines[i % len(deadlines)],
                                   step_budget=args.step_budget,
                                   energy_budget_j=args.energy_budget,
                                   quality_floor=args.quality_floor,
                                   **fields)
                frontier = (f" precision={adm.precision} "
                            f"taylorseer={adm.taylorseer} "
                            f"quality={adm.quality:.3f}"
                            if adm.action == "frontier" else "")
                print(f"[admission] {adm.action}: op={adm.op} "
                      f"steps={adm.steps}{frontier}"
                      + (f" ({adm.reason})" if adm.reason else ""))
            else:
                engine.submit(**fields)

        mesh = (dict(engine.mesh.shape)
                if isinstance(engine, ShardedDriftServeEngine)
                else "1 device")
        print(f"[drift_serve] {args.requests} requests, "
              f"bucket={args.batch}, ops={ops}, mesh={mesh}, "
              f"device={engine.device}")
        if args.stream:
            results = []
            for ev in engine.run_stream(args.stream):
                if isinstance(ev, PreviewEvent):
                    previews += 1
                else:
                    results.append(ev)
            results.sort(key=lambda r: r.request_id)
            print(f"[drift_serve] {previews} preview events streamed")
        else:
            results = engine.run()

    for r in results:
        miss = " MISSED-DEADLINE" if r.deadline_missed else ""
        if r.tokens is not None:
            quality = (f"{len(r.tokens)} tokens "
                       f"match-vs-clean {r.token_match_vs_clean:.3f} "
                       f"abft-detections {r.ar_detections} "
                       f"kv-rollbacks {r.ar_rollbacks} "
                       f"evals {r.n_model_evals}")
        else:
            quality = (f"lpips={r.lpips_vs_clean:.4f} "
                       f"psnr={r.psnr_vs_clean_db:.1f}dB "
                       f"corrected(batch)={r.batch_corrected_elems}")
        print(f"req {r.request_id}: op={r.op} steps={r.steps} "
              f"prio={r.priority} batch={r.batch_index} {quality} "
              f"energy={r.energy_j:.2f}J (baseline "
              f"{r.baseline_energy_j:.2f}J, modeled) "
              f"monitor_ber={r.monitor_ber:.2e}{miss}")

    # precision and taylorseer are SamplerKey dimensions too (the frontier
    # may assign them per request), so they discriminate built configs.
    # The port builds one sampler per configuration, streamed, offloaded
    # or autoregressive alike, and one per clean reference (keyed by step
    # count: the scheduler may trim steps per request).
    distinct = len({(r.op, r.mode, r.steps, r.precision, r.taylorseer)
                    for r in results})
    clean_configs = len({r.steps for r in results})
    expected_builds = distinct + clean_configs
    print(f"engine: {engine.stats.batches} batches, {engine.cache.builds} "
          f"sampler builds for {distinct} drift configs "
          f"(+{clean_configs} clean), {engine.cache.hits} cache hits; "
          f"clock {engine.clock_s:.3f}s (modeled), "
          f"{engine.stats.deadline_misses} deadline misses")
    if sched is not None:
        print(f"scheduler: {sched.stats}")
    # after the first batch of a configuration, every later batch must
    # hit the sampler cache instead of building again (skipped when
    # admission rejected everything)
    assert engine.cache.builds <= expected_builds, \
        (engine.cache.builds, expected_builds)
    if results and engine.stats.batches > engine.cache.builds - 1:
        assert engine.cache.hits > 0, "expected sampler-cache hits"
    if args.stream and any(r.steps > args.stream for r in results):
        assert previews >= 1, "streaming produced no previews"
    print("sampler cache verified: no rebuilds after first batch per config")
    if engine.telemetry.enabled and results:
        est = engine.telemetry.estimator
        ctrl = engine.telemetry.controller
        print(f"telemetry: {est.total_observations} latency observations "
              f"over {len(est)} configs; guardband floor "
              f"{ctrl.guard_index if ctrl else 0}")
        ledger, slo = engine.telemetry.ledger, engine.telemetry.slo
        if ledger is not None and ledger.batches:
            top = sorted(ledger.shares().items(), key=lambda kv: -kv[1])[:3]
            burning = slo.breached_objectives()
            print(f"energy (modeled): {ledger.energy_per_request_j():.2f} "
                  "J/request ("
                  + ", ".join(f"{c} {s:.0%}" for c, s in top)
                  + "); slo breached: "
                  + (", ".join(burning) if burning else "none"))
    if engine.offload_store is not None:
        ost = engine.offload_store.stats
        print(f"offload: {ost.commits} commits, "
              f"{ost.bytes_offloaded / 1e6:.2f} MB offloaded, "
              f"{ost.restores} restores")
    if args.trace_dir is not None:
        os.makedirs(args.trace_dir, exist_ok=True)
        path = os.path.join(args.trace_dir, "flight.json")
        write_chrome_trace(path, engine.tracer.spans())
        print(f"trace: {len(engine.tracer)} spans -> {path}")
    return results


if __name__ == "__main__":
    main()
