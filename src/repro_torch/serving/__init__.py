"""DRIFT serving on PyTorch: request queue, micro-batcher, sampler cache,
the batched engine, checkpoint offload, the deadline scheduler and the
Pareto frontier, telemetry with its HTTP front end, and the flight
recorder (counterpart of ``repro.serving``, without the sharded engine)."""
from repro_torch.serving.cache import CompiledSamplerCache, SamplerKey
from repro_torch.serving.engine import DriftServeEngine, EngineStats
from repro_torch.serving.frontier import (FRONTIER_OPS, FrontierBuilder,
                                          FrontierPoint, dominates,
                                          pareto_front, quality_proxy)
from repro_torch.serving.offload import (OffloadConfig, OffloadPlanner,
                                         OffloadStore)
from repro_torch.serving.request import (PRIORITY_RANK, REQUEST_OPS,
                                         REQUEST_PRIORITIES,
                                         GenerationRequest, PreviewEvent,
                                         RequestQueue, RequestResult)
from repro_torch.serving.scheduler import (Admission, DeadlineScheduler,
                                           PriorityMicroBatcher,
                                           SchedulerConfig, SchedulerStats)
from repro_torch.serving.telemetry import (EngineTelemetry, GuardbandConfig,
                                           GuardbandController,
                                           LatencyEstimator, MetricsRegistry,
                                           TelemetryHTTPServer,
                                           aggregate_metrics, serve_telemetry)
from repro_torch.serving.trace import FlightRecorder

__all__ = ["Admission", "CompiledSamplerCache", "DeadlineScheduler",
           "DriftServeEngine", "EngineStats", "EngineTelemetry",
           "FRONTIER_OPS", "FlightRecorder", "FrontierBuilder",
           "FrontierPoint", "GenerationRequest", "GuardbandConfig",
           "GuardbandController", "LatencyEstimator", "MetricsRegistry",
           "OffloadConfig", "OffloadPlanner", "OffloadStore",
           "PRIORITY_RANK", "PreviewEvent", "PriorityMicroBatcher",
           "REQUEST_OPS", "REQUEST_PRIORITIES", "RequestQueue",
           "RequestResult", "SamplerKey", "SchedulerConfig",
           "SchedulerStats", "TelemetryHTTPServer", "aggregate_metrics",
           "dominates", "pareto_front", "quality_proxy", "serve_telemetry"]
