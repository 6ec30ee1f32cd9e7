"""DRIFT serving on PyTorch: request queue, micro-batcher, sampler cache and
the batched engine (counterpart of ``repro.serving``, main path only)."""
from repro_torch.serving.cache import CompiledSamplerCache, SamplerKey
from repro_torch.serving.engine import DriftServeEngine
from repro_torch.serving.request import (GenerationRequest, RequestQueue,
                                         RequestResult)

__all__ = ["CompiledSamplerCache", "DriftServeEngine", "GenerationRequest",
           "RequestQueue", "RequestResult", "SamplerKey"]
