"""Resilience classification policies (which work gets protected).

Counterpart of ``repro.core.policies``. Sec 4 findings -> Sec 5.2 policy:
the timestep/conditioning embeddings and the first transformer block are
error-*sensitive*; everything else is error-*resilient*. A policy maps a
block's position in the network to a resilience class of
``core.dvfs``. The serving path hard-codes ``PAPER_DEFAULT``'s classes
(``models.dit``), as the reference does; the policies serve studies.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import dvfs


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Maps (block kind, depth index) -> dvfs resilience class."""

    protect_embeddings: bool = True
    protect_first_blocks: int = 1   # how many leading blocks stay nominal

    def classify(self, kind: str, layer_index: int) -> int:
        if kind in ("embed", "cond", "time_embed", "patch_embed",
                    "text_embed", "final", "head"):
            # Embedding layers have global, every-step influence (Sec 4.3);
            # the final projection maps straight to pixels/logits.
            return (dvfs.CLASS_EMBED if self.protect_embeddings
                    else dvfs.CLASS_BODY)
        if layer_index < self.protect_first_blocks:
            return dvfs.CLASS_FIRST_BLOCK
        return dvfs.CLASS_BODY

    def class_vector(self, kinds: Sequence[str]) -> torch.Tensor:
        """int32 vector of classes for a stack of blocks (index = depth)."""
        return torch.tensor([self.classify("block", i)
                             for i, _ in enumerate(kinds)],
                            dtype=torch.int32)


PAPER_DEFAULT = ResiliencePolicy(protect_embeddings=True,
                                 protect_first_blocks=1)
UNPROTECTED = ResiliencePolicy(protect_embeddings=False,
                               protect_first_blocks=0)


def sensitivity_score(lpips_deltas: np.ndarray) -> np.ndarray:
    """Measured per-site quality deltas normalised into [0, 1]."""
    d = np.maximum(lpips_deltas, 0.0)
    return d / (d.max() + 1e-12)


def derive_policy(block_scores: np.ndarray, embed_score: float,
                  quantile: float = 0.8) -> ResiliencePolicy:
    """Data-driven policy: protect the leading blocks at or above the
    score quantile, and the embeddings when they reach it."""
    thr = float(np.quantile(block_scores, quantile))
    n_lead = 0
    for s in block_scores:
        if s >= thr:
            n_lead += 1
        else:
            break
    return ResiliencePolicy(protect_embeddings=embed_score >= thr,
                            protect_first_blocks=max(n_lead, 1))
