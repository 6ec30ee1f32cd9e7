"""The port's telemetry HTTP front end against the JAX package's.

Both servers run in this process on ``127.0.0.1:0`` (loopback only), each
over an engine with an echo stub sampler (``test_torch_scheduler``'s
pair), the port's fed the reference's latents, so every number on the
wire is comparable. ``/healthz``, ``/metrics`` (wall samples and the
version masked), ``/slo``, ``/trace/<id>`` and ``/flight`` (wall times and
the version masked) answer alike, one ``/events`` drain's frames are
equal frame for frame (latent digests included), a drain while another
holds the engine answers 503, the error routes answer alike, and the
multi-engine ``engines={...}`` form merges the registries the same way.
A real SMOKE DiT drained through ``/events`` with offload on gives the
finals ``run()`` gives, bit for bit.
"""
import json
import urllib.error
import urllib.request

import pytest

from repro.serving import serve_telemetry as jserve
from repro.serving.telemetry import TelemetryHTTPServer as JServer
from repro_torch.serving import (DriftServeEngine, OffloadConfig,
                                 TelemetryHTTPServer, serve_telemetry)
from repro_torch.serving.telemetry.http import latents_sha256

from test_torch_scheduler import _stub_pair
from test_torch_telemetry import mask_metrics
from test_torch_trace import _mask_wall


def fetch(url):
    with urllib.request.urlopen(url, timeout=120) as resp:
        return resp.status, resp.headers, resp.read().decode("utf-8")


def fetch_json(url):
    return json.loads(fetch(url)[2])


def status_of(url):
    try:
        return fetch(url)[0]
    except urllib.error.HTTPError as exc:
        return exc.code


def parse_sse(payload):
    events, kind = [], None
    for line in payload.splitlines():
        if line.startswith("event: "):
            kind = line[len("event: "):]
        elif line.startswith("data: "):
            events.append((kind, json.loads(line[len("data: "):])))
    return events


REQUESTS = [dict(steps=6, op="undervolt", priority="background", seed=0),
            dict(steps=6, op="overclock", priority="interactive",
                 deadline_s=1.0, seed=1),
            dict(steps=6, op="undervolt", seed=2)]


@pytest.fixture(scope="module")
def servers():
    js, ts = _stub_pair(2, {})
    for s in (js, ts):
        for f in REQUESTS:
            s.submit(**f)
    srv = {"j": jserve(js, port=0), "t": serve_telemetry(ts, port=0)}
    for k, s in (("j", js), ("t", ts)):
        with srv[k].engine_lock:
            s.run()
    yield js, ts, srv
    for s in srv.values():
        s.close()


def test_healthz_metrics_slo_equal(servers):
    js, ts, srv = servers
    j, t = srv["j"].url, srv["t"].url
    assert fetch_json(t + "/healthz") == fetch_json(j + "/healthz")
    assert fetch_json(t + "/healthz")["batches"] == 2
    st, headers, tm = fetch(t + "/metrics")
    assert st == 200 and headers["Content-Type"].startswith("text/plain")
    assert mask_metrics(tm) == mask_metrics(fetch(j + "/metrics")[2])
    assert "drift_build_info" in tm and "drift_admissions_total" in tm
    assert fetch_json(t + "/slo") == fetch_json(j + "/slo")


def test_trace_and_flight_equal(servers):
    js, ts, srv = servers
    j, t = srv["j"].url, srv["t"].url
    for rid in range(len(REQUESTS)):
        tree = fetch_json(f"{t}/trace/{rid}")
        assert _mask_wall(tree) == _mask_wall(fetch_json(f"{j}/trace/{rid}"))
        kinds = [s["kind"] for s in tree["spans"]]
        assert kinds[:2] == ["submit", "admission"] and "finalize" in kinds
    assert _mask_wall(fetch_json(t + "/flight")) == \
        _mask_wall(fetch_json(j + "/flight"))


@pytest.mark.parametrize("path,code", [
    ("/trace/999", 404), ("/trace/abc", 404), ("/nope", 404),
    ("/events?interval=zero", 400), ("/events?interval=63", 400)])
def test_error_routes_equal(servers, path, code):
    _, _, srv = servers
    assert status_of(srv["t"].url + path) == status_of(srv["j"].url + path) \
        == code


def test_events_drain_frames_equal_and_busy_answers_503(servers):
    js, ts, srv = servers
    for s in (js, ts):
        for f in REQUESTS:
            s.submit(**dict(f, seed=f["seed"] + 10))
    with srv["t"].engine_lock:          # a drain in flight
        assert status_of(srv["t"].url + "/events?interval=2") == 503
    frames = {k: parse_sse(fetch(srv[k].url + "/events?interval=2")[2])
              for k in ("j", "t")}
    assert frames["t"] == frames["j"]
    kinds = [k for k, _ in frames["t"]]
    assert kinds.count("result") == 3 and kinds.count("preview") == 6
    assert frames["t"][-1] == ("end", {"served": 3, "previews": 6})
    empty = parse_sse(fetch(srv["t"].url + "/events")[2])
    assert empty == [("end", {"served": 0, "previews": 0})]


def test_multi_engine_metrics_and_healthz_equal(servers):
    js, ts, _ = servers
    j = JServer(js, engines={"a": js, "b": js.engine}).start()
    t = TelemetryHTTPServer(ts, engines={"a": ts, "b": ts.engine}).start()
    try:
        tm, jm = fetch(t.url + "/metrics")[2], fetch(j.url + "/metrics")[2]
        assert mask_metrics(tm) == mask_metrics(jm)
        assert 'engine="a"' in tm and 'engine="b"' in tm
        assert fetch_json(t.url + "/healthz") == fetch_json(j.url + "/healthz")
        assert set(fetch_json(t.url + "/slo")["engines"]) == {"a", "b"}
    finally:
        j.close()
        t.close()
    TelemetryHTTPServer(ts).close()          # never started: no deadlock


def test_events_drain_with_offload_bit_identical_to_run():
    """A real SMOKE DiT with offload on, drained through /events on the
    server's handler thread: every result's digest equals ``run()``'s on
    a twin engine, and every commit is traced."""
    def engine():
        return DriftServeEngine(arch="dit-xl-512", smoke=True, bucket=2,
                                base_seed=4, device="cpu",
                                offload=OffloadConfig())
    want = engine()
    got = engine()
    for eng in (want, got):
        for s in (0, 1, 2):
            eng.submit(steps=4, mode="drift", op="undervolt", seed=s,
                       rollback_interval=2)
    ref = {r.request_id: latents_sha256(r.latents) for r in want.run()}
    server = serve_telemetry(got, port=0)
    try:
        frames = parse_sse(fetch(server.url + "/events?interval=2")[2])
        results = {d["request_id"]: d["latents_sha256"]
                   for k, d in frames if k == "result"}
        assert results == ref
        assert got.offload_store.stats.commits == \
            want.offload_store.stats.commits == 4
        kinds = [s.kind for s in got.tracer.spans()]
        assert kinds.count("offload_commit") == 4
    finally:
        server.close()
