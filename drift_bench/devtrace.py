"""Reduction of a ``torch.profiler`` CUDA trace to what the per-layer
metrics read: the device operations with their start and end, the busy
time (the union of their intervals), the top operations by device time,
and the longest idle gaps named by the host span they fall in and the
operation they follow.

Times are microseconds from the profiler's start, the host spans' too:
both clocks are the wall clock in nanoseconds. The operations are read
from the profiler's raw results, not its parsed event list, whose
parsing takes minutes for the ~200,000 launches of one batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

Op = Tuple[str, float, float]            # name, start_us, end_us
Span = Tuple[str, float, float]          # name, start_us, end_us

NAME_CHARS = 100


@dataclasses.dataclass
class Trace:
    ops: List[Op]
    window_s: float
    spans: List[Span]
    # the traced batch's counts: launches by kernel, evaluations, results
    launches: Dict[str, int]
    drift_evals: int
    clean_evals: int
    corrected: int

    def busy_s(self) -> float:
        return sum(e - s for s, e in _union(self.ops)) / 1e6

    def time_s(self, *needles: str) -> float:
        return sum(e - s for n, s, e in self.ops
                   if any(k in n for k in needles)) / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.ops:
            by[name[:NAME_CHARS]] = by.get(name[:NAME_CHARS], 0.0) + e - s
        rows = sorted(by.items(), key=lambda r: -r[1])[:n]
        return [[k, v / 1e6] for k, v in rows]

    def idle_gaps(self, n: int = 10) -> List[list]:
        gaps = []
        last_end, last_name = 0.0, "start"
        for name, s, e in sorted(self.ops, key=lambda r: r[1]):
            if s > last_end:
                gaps.append((s - last_end, last_end, last_name))
            if e >= last_end:
                last_end, last_name = e, name
        tail = self.window_s * 1e6 - last_end
        if tail > 0:
            gaps.append((tail, last_end, last_name))
        gaps.sort(key=lambda g: -g[0])
        return [[f"{self._span_at(t0 + g / 2)} after "
                 f"{prev[:NAME_CHARS - 40]}", g / 1e6]
                for g, t0, prev in gaps[:n]]

    def _span_at(self, t_us: float) -> str:
        for name, s, e in self.spans:
            if s <= t_us <= e:
                return name
        return "harness"


def _union(ops: Sequence[Op]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for _, s, e in sorted(ops, key=lambda r: r[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def device_ops(prof) -> Tuple[int, List[Op]]:
    """(the trace's start in wall-clock ns, every device operation) of a
    finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    ops = [(e.name(), (e.start_ns() - t0) / 1e3,
            (e.start_ns() + e.duration_ns() - t0) / 1e3)
           for e in res.events() if e.device_type() == DeviceType.CUDA]
    ops.sort(key=lambda r: r[1])
    return t0, ops
