"""Metrics registry: counters, gauges, histograms, Prometheus exposition.

Counterpart of ``repro.serving.telemetry.metrics``, unchanged: the same
exposition text for the same operations.

A deliberately small, stdlib-only metrics core for the serving stack.
Three metric kinds, all label-aware:

* ``Counter`` -- monotonically increasing (``inc``);
* ``Gauge``   -- set to the latest value (``set``), optionally ``inc``;
* ``Histogram`` -- ``observe`` values into fixed cumulative buckets, with
  ``_sum``/``_count`` series and a bounded reservoir of recent raw
  observations so percentile queries (``percentile``) don't need a
  sidecar store.

One ``MetricsRegistry`` holds every metric an engine emits;
``registry.expose()`` renders the whole set in the Prometheus text
exposition format (``text/plain; version=0.0.4``), which is what the
HTTP front-end serves at ``/metrics`` (``telemetry/http.py``).

Thread-safety: the engine mutates metrics from its serving thread while
the HTTP server reads from per-connection threads, so every mutation and
the exposition walk take the registry's lock. The engine's hot path does
a handful of dict updates per *batch* (not per step), so the lock is
uncontended in practice.

Metric catalog for the serving engine: docs/telemetry.md.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Default histogram buckets in (virtual) seconds: spans the smoke models'
# millisecond batches through multi-second full-arch buckets.
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0)


def nearest_rank(sorted_data: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) over already-sorted data --
    the one shared definition for histogram reservoirs and the latency
    estimator's observation windows.

    Raises ``ValueError`` on empty data or an out-of-range ``q`` (real
    errors, not asserts: they must survive ``python -O``, and the empty
    case is reachable from any caller that forgets the
    ``percentile() -> None`` contract on a fresh reservoir)."""
    if not sorted_data:
        raise ValueError("percentile of empty data")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q!r} outside [0, 100]")
    rank = round(q / 100.0 * (len(sorted_data) - 1))
    return sorted_data[max(0, min(len(sorted_data) - 1, int(rank)))]


def _fmt(v: float) -> str:
    """Prometheus float rendering: integers without a trailing .0 noise."""
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    body = ",".join(
        '%s="%s"' % (k, v.replace("\\", r"\\").replace('"', r"\"")
                     .replace("\n", r"\n"))
        for k, v in labels)
    return "{%s}" % body


class _Metric:
    """Shared label handling + exposition plumbing for one metric family."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str, registry: "MetricsRegistry",
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help_text = help_text
        self.label_names = tuple(label_names)
        self._registry = registry
        self._lock = registry._lock
        self._children: Dict[Tuple[Tuple[str, str], ...], object] = {}

    def _labelkey(self, kv: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.label_names)}")
        return tuple((k, str(kv[k])) for k in self.label_names)

    def _child(self, key: Tuple[Tuple[str, str], ...]):
        raise NotImplementedError

    def labels(self, **kv):
        key = self._labelkey(kv)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._child(key)
        return child

    def _default(self):
        """The label-less child (only legal when no labels are declared)."""
        assert not self.label_names, \
            f"{self.name} declares labels {self.label_names}; use .labels()"
        return self.labels()

    def expose_lines(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help_text}",
                 f"# TYPE {self.name} {self.kind}"]
        for key, child in sorted(self._children.items()):
            lines.extend(child.expose(self.name, key))  # type: ignore
        return lines


class _CounterChild:
    def __init__(self, lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        assert amount >= 0, f"counter decrement: {amount}"
        with self._lock:
            self.value += amount

    def expose(self, name, key):
        return [f"{name}{_label_str(key)} {_fmt(self.value)}"]


class Counter(_Metric):
    kind = "counter"

    def _child(self, key):
        return _CounterChild(self._lock)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class _GaugeChild(_CounterChild):
    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Gauge(_Metric):
    kind = "gauge"

    def _child(self, key):
        return _GaugeChild(self._lock)

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class _HistogramChild:
    def __init__(self, lock, buckets: Tuple[float, ...], reservoir: int):
        self._lock = lock
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)   # +1 for +Inf
        self.total = 0.0
        self.n = 0
        self._recent: List[float] = []
        self._reservoir = reservoir

    def observe(self, value: float) -> None:
        with self._lock:
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    self.counts[i] += 1
                    break
            else:
                self.counts[-1] += 1
            self.total += value
            self.n += 1
            self._recent.append(float(value))
            if len(self._recent) > self._reservoir:
                del self._recent[:len(self._recent) - self._reservoir]

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 100] over the bounded reservoir of raw observations
        (exact over the last ``reservoir`` points, not bucket-interpolated)."""
        with self._lock:
            if not self._recent:
                return None
            data = sorted(self._recent)
        return nearest_rank(data, q)

    def expose(self, name, key):
        lines = []
        cum = 0
        for ub, c in zip(tuple(self.buckets) + (float("inf"),), self.counts):
            cum += c
            lk = key + (("le", _fmt(ub)),)
            lines.append(f"{name}_bucket{_label_str(lk)} {cum}")
        lines.append(f"{name}_sum{_label_str(key)} {_fmt(self.total)}")
        lines.append(f"{name}_count{_label_str(key)} {self.n}")
        return lines


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_text, registry, label_names=(),
                 buckets: Iterable[float] = DEFAULT_BUCKETS,
                 reservoir: int = 512):
        super().__init__(name, help_text, registry, label_names)
        self._buckets = tuple(sorted(buckets))
        assert self._buckets, "histogram needs at least one bucket"
        self._reservoir = reservoir

    def _child(self, key):
        return _HistogramChild(self._lock, self._buckets, self._reservoir)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def percentile(self, q: float) -> Optional[float]:
        return self._default().percentile(q)


class MetricsRegistry:
    """Namespace of metrics with one exposition endpoint.

    Metric creation is idempotent per name -- asking for an existing name
    returns the existing metric (and asserts the kind matches), so engine
    and scheduler can both say ``registry.counter("x", ...)`` safely.
    """

    CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_make(self, cls, name, help_text, label_names, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                assert isinstance(m, cls), \
                    f"{name} already registered as {m.kind}"
                return m
            m = cls(name, help_text, self, label_names, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_text: str = "",
                label_names: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help_text, label_names)

    def gauge(self, name: str, help_text: str = "",
              label_names: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help_text, label_names)

    def histogram(self, name: str, help_text: str = "",
                  label_names: Sequence[str] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(Histogram, name, help_text, label_names,
                                 buckets=buckets)

    def expose(self) -> str:
        """The whole registry in Prometheus text format (sorted by name,
        trailing newline included -- some scrapers insist)."""
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
            lines: List[str] = []
            for m in metrics:
                lines.extend(m.expose_lines())
        return "\n".join(lines) + "\n"


def _inject_label(sample_line: str, key: str, value: str) -> str:
    """Prepend ``key="value"`` to one exposition sample line."""
    body, sep, val = sample_line.rpartition(" ")
    assert sep, f"malformed sample line: {sample_line!r}"
    escaped = value.replace("\\", r"\\").replace('"', r"\"")
    if "{" in body:
        name, rest = body.split("{", 1)
        return f'{name}{{{key}="{escaped}",{rest} {val}'
    return f'{body}{{{key}="{escaped}"}} {val}'


def merge_labeled_expositions(named: Dict[str, str]) -> str:
    """Merge several registries' expositions into one scrape payload,
    tagging every sample with an ``engine="<name>"`` label.

    This is the multi-engine aggregation path: one ``/metrics`` endpoint
    fronting several engines (``TelemetryHTTPServer(engines={...})``)
    renders each engine's ``registry.expose()`` text and merges here.
    The format requires every sample of a metric family to sit in one
    contiguous block under its ``# HELP``/``# TYPE`` headers, so the
    merge regroups by family (headers taken from the first engine that
    exposes it) with every series' labels gaining a leading
    ``engine="<name>"`` -- identical series from different engines never
    collide.
    """
    headers: Dict[str, List[str]] = {}
    samples: Dict[str, List[str]] = {}
    for name in sorted(named):
        family = None
        for line in named[name].splitlines():
            if not line.strip():
                continue
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                family = line.split()[2]
                fam_headers = headers.setdefault(family, [])
                samples.setdefault(family, [])
                if line not in fam_headers:
                    fam_headers.append(line)
                continue
            assert family is not None, f"sample before headers: {line!r}"
            samples[family].append(_inject_label(line, "engine", name))
    out: List[str] = []
    for family in sorted(headers):
        out.extend(headers[family])
        out.extend(samples[family])
    return "\n".join(out) + "\n"
