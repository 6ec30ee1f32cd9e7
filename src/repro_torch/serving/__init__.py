"""DRIFT serving on PyTorch: request queue, micro-batcher, sampler cache,
the batched engine and checkpoint offload (counterpart of
``repro.serving``, main path only)."""
from repro_torch.serving.cache import CompiledSamplerCache, SamplerKey
from repro_torch.serving.engine import DriftServeEngine
from repro_torch.serving.offload import (OffloadConfig, OffloadPlanner,
                                         OffloadStore)
from repro_torch.serving.request import (GenerationRequest, PreviewEvent,
                                         RequestQueue, RequestResult)

__all__ = ["CompiledSamplerCache", "DriftServeEngine", "GenerationRequest",
           "OffloadConfig", "OffloadPlanner", "OffloadStore", "PreviewEvent",
           "RequestQueue", "RequestResult", "SamplerKey"]
