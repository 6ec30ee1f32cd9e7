"""Seeds and the inputs made from them.

``mix64`` is splitmix64 over a list of fields, a frozen copy of the law
the port's servable uses (``repro_torch.core.fault.mix64``). Each request
of a run gets its own 31-bit seed; the port derives a request's initial
latents, its class id and PixArt's text stand-in from that seed
(``serving/servable.py``), and ``request_inputs`` works them out again
by the same law for the reference.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

#: stream tags of a request seed: initial latents, text stand-in
LATENT_TAG = 7
TEXT_TAG = 8
#: stream tags of a run seed
REQUEST_TAG = 1
WARM_TAG = 2
WEIGHT_TAG = 3
POOL_TAG = 4
SAMPLE_TAG = 5
TRACE_TAG = 6
CLEAN_STEP_TAG = 9
GEMM_TAG = 10

_MASK64 = (1 << 64) - 1


def mix64(*fields: int) -> int:
    """splitmix64 over the fields: a stable seed below 2^63."""
    h = 0x9E3779B97F4A7C15
    for f in fields:
        h = (h ^ (int(f) & _MASK64)) & _MASK64
        h = (h + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h & ((1 << 63) - 1)


def request_seed(run_seed: int, stream: int, index: int) -> int:
    """The seed of request ``index`` of a stream (``REQUEST_TAG`` for the
    measured window, ``WARM_TAG`` for set-up): 31 bits, never negative."""
    return mix64(run_seed, stream, index) & 0x7FFFFFFF


def _randn(seeds: Sequence[int], tag: int, shape, device) -> torch.Tensor:
    out = []
    for s in seeds:
        g = torch.Generator(device=device)
        g.manual_seed(mix64(int(s), tag))
        out.append(torch.randn(shape, generator=g, device=device))
    return torch.stack(out)


def request_inputs(cfg: dict, seeds: List[int], device
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                              Optional[torch.Tensor]]:
    """(latents (B, H, W, C) f32, class ids (B,) or None, text (B, Tt,
    cond_dim) f32 or None) of a batch of request seeds: one generator per
    seed on ``device``; the text stand-in is ``0.1 * N(0, 1)``."""
    size, ch = cfg["latent_size"], cfg["latent_channels"]
    lat = _randn(seeds, LATENT_TAG, (size, size, ch), device)
    if cfg["cond_tokens"]:
        text = 0.1 * _randn(seeds, TEXT_TAG,
                            (cfg["cond_tokens"], cfg["cond_dim"]), device)
        return lat, None, text
    cond = torch.tensor([s % max(cfg["num_classes"], 1) for s in seeds],
                        dtype=torch.int64, device=device)
    return lat, cond, None
