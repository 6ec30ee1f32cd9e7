"""Micro-batcher: groups pending requests into fixed-size same-config
buckets.

Counterpart of ``repro.serving.batcher``. Requests share a batch only when
they resolve to the same ``SamplerKey``; a batch takes the queue head's key
and sweeps the queue for up to ``bucket`` matches in FIFO order; a short
final group is padded up to the bucket size (the last live request's seed
repeats) so every sampler sees one batch shape. One bucket is formed per
call, so ``op="auto"`` reads the live BER-monitor state between batches.
``key_extra`` (the sharded engine's mesh placement) is stamped into every
key the batcher forms.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.serving.cache import SamplerKey
from repro_torch.serving.request import GenerationRequest, RequestQueue


@dataclasses.dataclass(frozen=True)
class MicroBatch:
    """One bucket of same-config requests ready to run."""
    key: SamplerKey
    requests: List[GenerationRequest]   # live requests, FIFO order

    @property
    def n_pad(self) -> int:
        return self.key.bucket - len(self.requests)


def request_key(req: GenerationRequest, bucket: int, resolved_op: str,
                extra: Optional[Dict[str, object]] = None,
                resolved_interval: Optional[int] = None) -> SamplerKey:
    """SamplerKey for a request whose operating point is resolved. Clean
    mode runs no DVFS schedule, so its op normalises to "".
    ``extra`` sets further key fields (the sharded engine's
    ``mesh_shape`` and ``batch_spec``). ``resolved_interval`` is the
    concrete refresh interval of a ``rollback_interval="auto"`` request;
    a key never carries "auto"."""
    interval = (resolved_interval if resolved_interval is not None
                else req.rollback_interval)
    if isinstance(interval, str):
        raise ValueError("resolve rollback_interval='auto' before building "
                         "a SamplerKey")
    key = SamplerKey(arch=req.arch, smoke=req.smoke, steps=req.steps,
                     mode=req.mode,
                     op="" if req.mode == "clean" else resolved_op,
                     bucket=bucket, taylorseer=req.taylorseer,
                     precision=req.precision,
                     rollback_interval=int(interval))
    return dataclasses.replace(key, **extra) if extra else key


class MicroBatcher:
    """Forms one bucket at a time."""

    def __init__(self, bucket: int,
                 key_extra: Optional[Dict[str, object]] = None) -> None:
        if bucket < 1:
            raise ValueError(f"bucket must be >= 1, got {bucket}")
        self.bucket = bucket
        self.key_extra = dict(key_extra or {})

    def next_batch(self, queue: RequestQueue,
                   resolve_op: Callable[[GenerationRequest], str],
                   resolve_interval: Optional[
                       Callable[[GenerationRequest], int]] = None
                   ) -> MicroBatch:
        """Pop the next bucket. ``resolve_op`` and ``resolve_interval``
        map a request to its concrete operating point and refresh
        interval ("auto" through the monitor ladder and the offload
        planner), per request, so two "auto" requests share a bucket only
        if they resolve alike."""
        head = queue.peek()
        if head is None:
            raise ValueError("next_batch on an empty queue")

        def key_of(r):
            return request_key(
                r, self.bucket, resolve_op(r), self.key_extra,
                resolve_interval(r) if resolve_interval is not None
                else None)
        key = key_of(head)
        return MicroBatch(key=key,
                          requests=queue.take_matching(key, key_of,
                                                       self.bucket))
