"""Exporters for the flight recorder: Chrome/Perfetto trace-event JSON
and the per-request span tree served by ``GET /trace/<id>``.

Counterpart of ``repro.serving.trace.export``; the process name carries
the port's version.

The Chrome format (loadable at ``ui.perfetto.dev`` or
``chrome://tracing``) wants complete events::

    {"name", "cat", "ph": "X", "ts": <us>, "dur": <us>, "pid", "tid",
     "args": {...}}

Wall-clock timestamps drive ``ts``/``dur`` (that is what a trace viewer
lays out); the virtual-clock interval and every span attr ride along in
``args`` so the perfmodel story stays reconstructible from the file.
Spans are grouped one ``tid`` per batch (``tid 0`` for pre-batch spans
like submit/admission), all under a single ``pid``.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List

from repro_torch.version import __version__

from .recorder import Span

_PID = 1


def span_to_event(span: Span) -> Dict[str, Any]:
    dur_us = max((span.t1_wall_s - span.t0_wall_s) * 1e6, 1.0)
    return {
        "name": span.name,
        "cat": span.kind,
        "ph": "X",
        "ts": span.t0_wall_s * 1e6,
        "dur": dur_us,
        "pid": _PID,
        "tid": span.batch_index + 1,     # batch -1 (pre-batch) -> tid 0
        "args": {
            "request_ids": list(span.request_ids),
            "virtual_t0_s": span.t0_virtual_s,
            "virtual_t1_s": span.t1_virtual_s,
            **span.attrs,
        },
    }


def to_chrome_trace(spans: Iterable[Span]) -> Dict[str, Any]:
    spans = list(spans)
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": _PID,
        "args": {"name": f"drift-serve {__version__}"},
    }]
    for bi in sorted({s.batch_index for s in spans}):
        events.append({
            "name": "thread_name", "ph": "M", "pid": _PID, "tid": bi + 1,
            "args": {"name": "scheduler/queue" if bi < 0
                     else f"batch {bi}"},
        })
    events.extend(span_to_event(s) for s in spans)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Iterable[Span]) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(spans), f, indent=1)


def request_tree(spans: Iterable[Span], request_id: int) -> Dict[str, Any]:
    """The ``GET /trace/<id>`` payload: the request's spans oldest-first,
    both clocks explicit, with the scheduler decision record (if any)
    surfaced at the top level."""
    rid = int(request_id)
    mine = [s for s in spans if rid in s.request_ids]
    decision = None
    for s in mine:
        if s.kind == "admission":
            decision = s.attrs
    return {
        "request_id": rid,
        "n_spans": len(mine),
        "decision": decision,
        "spans": [s.to_dict() for s in mine],
    }
