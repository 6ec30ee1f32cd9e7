"""Attention, reduced to what the DiT path runs.

Counterpart of ``repro.models.attention``: ``full_attention``, the plain
einsum path with scores and softmax in f32. It is the plain version of the
attention kernel (``kernels.flash_attention``), which the DiT block calls.
The chunked and decode paths wait for the autoregressive slice.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, H, D)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    scale = d ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if causal:
        pos_q = torch.arange(sq, device=q.device)
        pos_k = torch.arange(sk, device=q.device)
        m = pos_q[:, None] >= pos_k[None, :]
        scores = torch.where(m, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)

