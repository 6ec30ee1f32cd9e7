"""Attention, reduced to what the DiT and the dense LM paths run.

Counterpart of ``repro.models.attention``:

* ``full_attention``, the plain einsum path with scores and softmax in f32.
  It is the plain version of the attention kernel
  (``kernels.flash_attention``), which the DiT block and the LM prefill
  call.
* ``decode_attention``, one query token against a KV cache. The reference
  computes it as an einsum, not in a Pallas kernel (``attention.py:119``),
  and so does the port, in plain PyTorch.

The chunked and ring-buffer paths wait for the other families.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import softcap

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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, pos: int,
                     attn_softcap: float = 0.0) -> torch.Tensor:
    """One query token against the cache.

    q: (B, 1, H, D); k_cache, v_cache: (B, S, Hkv, D); ``pos`` is the slot
    the current token occupies (a host int). Products run on the cache's
    dtype with f32 accumulation, as the reference's
    ``preferred_element_type=f32`` einsums do.

    Only slots ``0..pos`` are read. The reference reads all S and masks the
    rest to probability 0; the port writes its cache in place, so slots
    past ``pos`` may still hold a rolled-back window's values, Inf or NaN
    among them, and ``0 * NaN`` in ``p @ v`` would leak them. Dropping
    zero-probability terms changes no value.
    """
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    g = h // hkv
    k = k_cache[:, :pos + 1]
    v = v_cache[:, :pos + 1]
    qg = q.reshape(b, hkv, g, d).to(k.dtype)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) \
        * (d ** -0.5)
    scores = softcap(scores, attn_softcap)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)
