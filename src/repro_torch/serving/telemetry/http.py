"""HTTP front-end for one serving engine: /metrics, /healthz, SSE /events.

Counterpart of ``repro.serving.telemetry.http``, with the same routes,
wire format and engine lock. The port's latents are torch tensors,
often on the card: the wire helpers move each one to the host once,
per event, before hashing it (``_host``). ``/events`` runs the drain
on the handler's thread; the engine's CUDA work (and the offload
store's events) go to the stream current in that thread.

Stdlib only (``http.server``), one server thread per engine plus one
handler thread per connection (``ThreadingHTTPServer``); the engine
itself stays single-threaded -- a server-level lock serializes queue
*drains* (``/events`` handlers and the CLIs' own ``run()`` calls), so
batches and the BER-monitor carry remain well-ordered no matter how
many clients poll. ``/healthz`` and ``/metrics`` are lock-free reads of
scalar snapshots: individually atomic under the GIL, but a response
racing a drain may mix pre-/post-batch values across fields.

Endpoints:

``GET /healthz``
    Liveness + a one-glance engine snapshot, as JSON: virtual clock,
    queue depth, batches served, monitor ladder index, guardband floor.
    Always 200 when the process is up (load balancers key on this).

``GET /metrics``
    The engine's ``MetricsRegistry`` in Prometheus text exposition
    format (``text/plain; version=0.0.4``). With telemetry disabled the
    payload is a single comment line, still 200.

``GET /slo``
    The SLO engine's snapshot as JSON (docs/slo.md): per objective the
    target, fast/slow virtual-clock window values, burn rates, and
    breach state. Deterministic on the virtual clock; multi-engine
    servers add a per-engine map like ``/healthz``.

``GET /events?interval=K``
    Server-Sent Events: drains the engine's queue through
    ``run_stream(K)`` (default: the server's ``preview_interval``) and
    relays every ``PreviewEvent`` and ``RequestResult`` as SSE frames --
    the *same* event sequence the in-process generator yields, with
    latent tensors replaced by their SHA-256 so finals can be checked
    bit-identical to ``run()`` without shipping arrays
    (tests/test_torch_http.py asserts both). ``K`` is restricted to the
    server's ``allowed_intervals``, as in the reference. If the client disconnects mid-stream the server finishes
    the drain engine-side, so no queued request is ever lost to a
    dropped connection. Frames:

    .. code-block:: text

        event: preview
        id: 0
        data: {"request_id": 0, "batch_index": 0, "step": 2,
               "total_steps": 6, "shape": [8, 8, 4], "dtype": "float32",
               "latents_sha256": "..."}

        event: result
        id: 1
        data: {"request_id": 0, "op": "undervolt", ... ,
               "latents_sha256": "..."}

        event: end
        data: {"served": 1, "previews": 2}

    A concurrent ``/events`` drain answers 503 rather than interleaving
    batches. The lock can only see drains that go through it: in-process
    callers that run the engine directly while the server is up must
    hold ``server.engine_lock`` around their own ``run()``/
    ``run_stream()`` (the serve CLIs do), which makes a simultaneous
    ``/events`` request 503 instead of corrupting the single-threaded
    engine.

``GET /trace/<request_id>``
    One request's span tree from the engine's flight recorder
    (``serving/trace``), as JSON: spans oldest-first with both clocks,
    plus the scheduler's decision record surfaced at the top level.
    404 when the id is unknown, has been evicted from the bounded ring
    buffer, or the recorder is disabled.

``GET /flight``
    The whole flight-recorder ring buffer as Chrome/Perfetto
    trace-event JSON -- save it and load at ``ui.perfetto.dev``. Empty
    ``traceEvents`` (plus metadata) when nothing is recorded.

Wire-format details and the metric catalog: docs/telemetry.md; span
taxonomy and recorder bounds: docs/tracing.md.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from repro_torch.serving.request import PreviewEvent, RequestResult
from repro_torch.serving.telemetry.metrics import merge_labeled_expositions
from repro_torch.serving.trace import request_tree, to_chrome_trace


def _host(latents) -> np.ndarray:
    """A latent tensor (on the card or the CPU) or array as numpy: one
    device-to-host copy per event."""
    if isinstance(latents, torch.Tensor):
        return latents.detach().cpu().numpy()
    return np.asarray(latents)


def latents_sha256(latents) -> str:
    """Digest of the raw latent bytes -- the bit-identity currency of the
    SSE wire format (arrays never leave the process)."""
    return hashlib.sha256(_host(latents).tobytes()).hexdigest()


def preview_wire(ev: PreviewEvent) -> Dict[str, object]:
    """JSON-able body of one SSE ``preview`` frame."""
    arr = _host(ev.latents)
    return {"request_id": ev.request_id, "batch_index": ev.batch_index,
            "step": ev.step, "total_steps": ev.total_steps,
            "shape": list(arr.shape), "dtype": str(arr.dtype),
            "latents_sha256": latents_sha256(arr)}


def result_wire(res: RequestResult) -> Dict[str, object]:
    """JSON-able body of one SSE ``result`` frame: every scalar field of
    the RequestResult, latents replaced by shape/dtype/digest."""
    body = {}
    for f in dataclasses.fields(res):
        v = getattr(res, f.name)
        if f.name == "latents":
            continue
        body[f.name] = v
    if res.latents is not None:
        arr = _host(res.latents)
        body["shape"] = list(arr.shape)
        body["dtype"] = str(arr.dtype)
        body["latents_sha256"] = latents_sha256(arr)
    return body


class TelemetryHTTPServer:
    """Threaded HTTP server bound to one engine (or DeadlineScheduler).

    ``port=0`` binds an ephemeral port (read it back from ``.port`` --
    what the tests and the smoke tool do); ``start()`` serves on a daemon
    thread, ``close()`` shuts down and joins. Usable as a context
    manager. Pass a ``DeadlineScheduler`` to expose its engine; the
    scheduler's own admission metrics land in the same registry.

    ``engine_lock`` serializes queue drains: ``/events`` handlers take
    it, and in-process code that drains the engine while the server is
    up should hold it too (``with server.engine_lock: engine.run()``).
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 preview_interval: int = 1,
                 allowed_intervals: Tuple[int, ...] = (1, 2, 4, 8),
                 engines: Optional[Dict[str, object]] = None) -> None:
        # accept a DeadlineScheduler transparently
        self.engine = getattr(engine, "engine", engine)
        # Multi-engine aggregation (ROADMAP telemetry follow-on): pass
        # ``engines={"name": engine, ...}`` and /metrics merges every
        # engine's registry into one scrape payload with an
        # engine="<name>" label per series (scrape-friendly family
        # grouping -- see metrics.merge_labeled_expositions). /healthz
        # reports a per-engine snapshot map; /events still drains only
        # the primary ``engine``.
        self.engines: Optional[Dict[str, object]] = (
            {n: getattr(e, "engine", e) for n, e in engines.items()}
            if engines else None)
        self.preview_interval = preview_interval
        # /events?interval=K values clients may request beyond the default
        # (the reference's bound on its compiled-sampler cache; kept so
        # the endpoint answers alike).
        self.allowed_intervals = tuple(allowed_intervals)
        self.engine_lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):      # tests/CLIs stay quiet
                pass

            def do_GET(self):
                try:
                    server._route(self)
                except (BrokenPipeError, ConnectionResetError):
                    pass                    # client went away mid-stream

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ control
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> "TelemetryHTTPServer":
        assert self._thread is None, "already started"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="drift-telemetry-http",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        # shutdown() blocks on an event only serve_forever() sets; calling
        # it on a never-started server would deadlock, so skip straight to
        # releasing the socket in that case.
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "TelemetryHTTPServer":
        return self if self._thread is not None else self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ routing
    def _route(self, h: BaseHTTPRequestHandler) -> None:
        parsed = urlparse(h.path)
        if parsed.path == "/healthz":
            return self._healthz(h)
        if parsed.path == "/metrics":
            return self._metrics(h)
        if parsed.path == "/slo":
            return self._slo(h)
        if parsed.path == "/events":
            return self._events(h, parse_qs(parsed.query))
        if parsed.path == "/flight":
            return self._flight(h)
        if parsed.path.startswith("/trace/"):
            return self._trace(h, parsed.path[len("/trace/"):])
        self._respond(h, 404, "application/json",
                      json.dumps({"error": f"no route {parsed.path}"}))

    @staticmethod
    def _respond(h, code: int, ctype: str, body: str) -> None:
        data = body.encode("utf-8")
        h.send_response(code)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)

    # ---------------------------------------------------------- endpoints
    @staticmethod
    def _engine_snapshot(eng) -> Dict[str, object]:
        tele = getattr(eng, "telemetry", None)
        ctrl = getattr(tele, "controller", None) if tele else None
        return {
            "status": "ok",
            "arch": eng.default_arch,
            "clock_s": eng.clock_s,
            "queue_depth": len(eng.queue),
            "batches": eng.stats.batches,
            "deadline_misses": eng.stats.deadline_misses,
            "monitor_ladder_index": int(eng.monitor.op_index),
            "monitor_ema_ber": float(eng.monitor.ema_ber),
            "guardband_index": ctrl.guard_index if ctrl else 0,
            "telemetry_enabled": bool(tele is not None and tele.enabled),
        }

    def _healthz(self, h) -> None:
        body = self._engine_snapshot(self.engine)
        if self.engines:
            body["engines"] = {name: self._engine_snapshot(e)
                               for name, e in self.engines.items()}
        self._respond(h, 200, "application/json", json.dumps(body))

    def _metrics(self, h) -> None:
        if self.engines:
            self._respond(h, 200, "text/plain; version=0.0.4; charset=utf-8",
                          aggregate_metrics(self.engines))
            return
        tele = getattr(self.engine, "telemetry", None)
        if tele is None or not tele.enabled:
            self._respond(h, 200, "text/plain; charset=utf-8",
                          "# telemetry disabled\n")
            return
        self._respond(h, 200, tele.registry.CONTENT_TYPE,
                      tele.registry.expose())

    @staticmethod
    def _slo_snapshot(eng):
        tele = getattr(eng, "telemetry", None)
        snap = tele.slo_snapshot() if tele is not None else None
        return snap if snap is not None else {"slo": "disabled"}

    def _slo(self, h) -> None:
        """``GET /slo``: the engine's SLO tracker snapshot (objectives,
        targets, fast/slow window values, burn rates, breach state) on
        the deterministic virtual clock -- wire format in docs/slo.md.
        Multi-engine servers report a per-engine map like /healthz."""
        body = self._slo_snapshot(self.engine)
        if self.engines:
            body["engines"] = {name: self._slo_snapshot(e)
                               for name, e in self.engines.items()}
        self._respond(h, 200, "application/json", json.dumps(body))

    def _flight(self, h) -> None:
        """The whole ring buffer as Chrome trace JSON (lock-free read:
        the recorder snapshots its deque under its own lock)."""
        tracer = getattr(self.engine, "tracer", None)
        spans = tracer.spans() if tracer is not None else []
        self._respond(h, 200, "application/json",
                      json.dumps(to_chrome_trace(spans)))

    def _trace(self, h, tail: str) -> None:
        """``GET /trace/<request_id>``: one request's span tree, or 404
        for a non-integer id, an unknown/evicted request, or a disabled
        (or absent) recorder -- an empty ring buffer can't distinguish
        "never existed" from "evicted", so both are 404."""
        try:
            rid = int(tail)
        except ValueError:
            self._respond(h, 404, "application/json",
                          json.dumps({"error": f"bad request id {tail!r}"}))
            return
        tracer = getattr(self.engine, "tracer", None)
        spans = tracer.spans(request_id=rid) if tracer is not None else []
        if not spans:
            self._respond(h, 404, "application/json",
                          json.dumps({"error": f"no trace for request "
                                               f"{rid} (unknown, evicted, "
                                               "or recorder disabled)"}))
            return
        self._respond(h, 200, "application/json",
                      json.dumps(request_tree(spans, rid)))

    def _events(self, h, query) -> None:
        try:
            interval = int(query.get("interval", [self.preview_interval])[0])
            assert interval >= 1
        except (ValueError, AssertionError):
            self._respond(h, 400, "application/json",
                          json.dumps({"error": "interval must be an int "
                                               ">= 1"}))
            return
        if interval != self.preview_interval \
                and interval not in self.allowed_intervals:
            # the reference's bound (each interval is a compiled sampler
            # there); the port keeps the same answer
            self._respond(h, 400, "application/json",
                          json.dumps({"error": f"interval {interval} not "
                                      "allowed; one of "
                                      f"{sorted(self.allowed_intervals)}"}))
            return
        if not self.engine_lock.acquire(blocking=False):
            self._respond(h, 503, "application/json",
                          json.dumps({"error": "engine busy: another drain "
                                               "is in progress"}))
            return
        try:
            h.send_response(200)
            h.send_header("Content-Type", "text/event-stream")
            h.send_header("Cache-Control", "no-cache")
            # SSE is open-ended; no Content-Length, so close delimits it
            h.send_header("Connection", "close")
            h.end_headers()
            served = previews = n = 0
            client_gone = False
            if len(self.engine.queue):
                for ev in self.engine.run_stream(interval):
                    if isinstance(ev, PreviewEvent):
                        kind, body = "preview", preview_wire(ev)
                        previews += 1
                    else:
                        kind, body = "result", result_wire(ev)
                        served += 1
                    if client_gone:
                        continue    # keep draining; see below
                    try:
                        self._write_frame(h, kind, body, event_id=n)
                        n += 1
                    except (BrokenPipeError, ConnectionResetError):
                        # The client went away mid-batch. Abandoning the
                        # generator here would LOSE the in-flight bucket:
                        # its requests were already popped from the queue
                        # and the monitor/clock carry happens at batch
                        # end. Finish the drain engine-side (discarding
                        # frames) so every request completes and the
                        # engine stays consistent; results are only lost
                        # to this client.
                        client_gone = True
            if not client_gone:
                self._write_frame(h, "end",
                                  {"served": served, "previews": previews})
                h.wfile.flush()
        finally:
            self.engine_lock.release()

    @staticmethod
    def _write_frame(h, kind: str, body: Dict[str, object],
                     event_id: Optional[int] = None) -> None:
        frame = f"event: {kind}\n"
        if event_id is not None:
            frame += f"id: {event_id}\n"
        frame += f"data: {json.dumps(body)}\n\n"
        h.wfile.write(frame.encode("utf-8"))
        h.wfile.flush()


def aggregate_metrics(engines: Dict[str, object]) -> str:
    """One Prometheus payload for several engines, every series tagged
    ``engine="<name>"``. Engines with telemetry disabled contribute a
    comment only (their registry has nothing registered)."""
    named = {}
    for name, eng in engines.items():
        eng = getattr(eng, "engine", eng)       # DeadlineScheduler ok
        tele = getattr(eng, "telemetry", None)
        named[name] = (tele.registry.expose()
                       if tele is not None and tele.enabled else "")
    return merge_labeled_expositions(named)


def serve_telemetry(engine, host: str = "127.0.0.1", port: int = 0,
                    engines: Optional[Dict[str, object]] = None
                    ) -> TelemetryHTTPServer:
    """Build + start a telemetry server for ``engine``; returns it running
    (the CLIs print ``server.url`` and ``close()`` it after the drain).
    ``engines`` additionally aggregates several engines' registries under
    one /metrics endpoint with an ``engine`` label per series."""
    return TelemetryHTTPServer(engine, host=host, port=port,
                               engines=engines).start()
