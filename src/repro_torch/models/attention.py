"""Attention: GQA, sliding windows and softcaps, for the DiT and the dense
LM paths.

Counterpart of ``repro.models.attention``:

* ``full_attention``, the plain einsum path with scores and softmax in f32.
  It is the plain version of the attention kernel
  (``kernels.flash_attention``), which the DiT block and the LM prefill
  call.
* ``decode_attention``, one query token against a KV cache. The reference
  computes it as an einsum, not in a Pallas kernel (``attention.py:119``),
  and so does the port, in plain PyTorch.

GQA never repeats KV heads: queries are reshaped to (B, S, Hkv, G, D) and
contracted group-wise, as in the reference. The chunked and ring-buffer
paths wait for the other families (ROADMAP Queue A item 12).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import softcap

NEG_INF = -2.0e38


def _mask(pos_q: torch.Tensor, pos_k: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    """(Sq, Sk) boolean validity mask. window <= 0: unbounded."""
    m = torch.ones((pos_q.shape[0], pos_k.shape[0]), dtype=torch.bool,
                   device=pos_q.device)
    if causal:
        m &= pos_q[:, None] >= pos_k[None, :]
    if window > 0:
        m &= pos_q[:, None] - pos_k[None, :] < window
    return m


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   attn_softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D) with H % Hkv == 0 ->
    (B, Sq, H, D). Scores ``q k^T * D^-0.5`` in f32, then the softcap, then
    the causal and window mask with ``NEG_INF``, then softmax in f32."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    scale = d ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    scores = softcap(scores, attn_softcap)
    if causal or window > 0:
        m = _mask(torch.arange(sq, device=q.device),
                  torch.arange(sk, device=q.device), causal, window)
        scores = torch.where(m, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, pos: int,
                     window: int = 0,
                     attn_softcap: float = 0.0) -> torch.Tensor:
    """One query token against the cache.

    q: (B, 1, H, D); k_cache, v_cache: (B, S, Hkv, D); ``pos`` is the slot
    the current token occupies (a host int). Products run on the cache's
    dtype with f32 accumulation, as the reference's
    ``preferred_element_type=f32`` einsums do.

    Only slots ``0..pos`` are read, and with ``window > 0`` only those
    with ``pos - slot < window``. The reference reads all S and masks the
    rest to probability 0; the port writes its cache in place, so slots
    past ``pos`` may still hold a rolled-back window's values, Inf or NaN
    among them, and ``0 * NaN`` in ``p @ v`` would leak them. Dropping
    zero-probability terms changes no value.
    """
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    g = h // hkv
    lo = max(pos - window + 1, 0) if window > 0 else 0
    k = k_cache[:, lo:pos + 1]
    v = v_cache[:, lo:pos + 1]
    qg = q.reshape(b, hkv, g, d).to(k.dtype)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) \
        * (d ** -0.5)
    scores = softcap(scores, attn_softcap)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)
