"""Per-request tracing and fault forensics for the serving stack.

Counterpart of ``repro.serving.trace``. See :mod:`.recorder` for the
span taxonomy and the zero-perturbation contract, :mod:`.export` for the
Chrome/Perfetto writer, and ``docs/tracing.md`` (the reference's) for
the operator view.
"""
from .recorder import SPAN_KINDS, FlightRecorder, Span
from .export import (request_tree, span_to_event, to_chrome_trace,
                     write_chrome_trace)
from .heatmap import N_STEP_BINS, bin_heatmap, site_labels, summarize

__all__ = ["SPAN_KINDS", "FlightRecorder", "Span", "request_tree",
           "span_to_event", "to_chrome_trace", "write_chrome_trace",
           "N_STEP_BINS", "bin_heatmap", "site_labels", "summarize"]
