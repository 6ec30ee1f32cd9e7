"""Attention: GQA, sliding windows and softcaps, for the DiT and the dense
LM paths.

Counterpart of ``repro.models.attention``:

* ``full_attention``, the plain einsum path with scores and softmax in f32.
  It is the plain version of the attention kernel
  (``kernels.flash_attention``), which the DiT block and the LM prefill
  call.
* ``chunked_attention``, the reference's online-softmax recurrence over
  query and KV chunks in plain tensor ops, and ``attention_any``, which
  takes it for sequences longer than ``CHUNK_THRESHOLD`` and
  ``full_attention`` otherwise, as the reference dispatches. The LM
  prefill calls ``attention_any`` on the CPU only (so it chunks past the
  threshold there); on the card every prefill runs the attention kernel.
* ``decode_attention``, one query token against a KV cache, and
  ``decode_attention_ring``, one query token against a window-sized ring
  buffer (the local layers of ``transformer.decode_step_mixed``). The
  reference computes both as einsums, not in a Pallas kernel
  (``attention.py:119`` and ``:151``), and so does the port, in plain
  PyTorch.

GQA never repeats KV heads: queries are reshaped to (B, S, Hkv, G, D) and
contracted group-wise, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import softcap

NEG_INF = -2.0e38

#: ``attention_any`` chunks past this length, in chunks of these sizes.
CHUNK_THRESHOLD = 4096
Q_CHUNK = 512
KV_CHUNK = 1024


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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      attn_softcap: float = 0.0, q_chunk: int = Q_CHUNK,
                      kv_chunk: int = KV_CHUNK) -> torch.Tensor:
    """``full_attention``'s function by the reference's blockwise online
    softmax: for each query chunk, a running max, normaliser and f32
    accumulator over every KV chunk (none skipped), the normaliser clamped
    at 1e-37. S must be a multiple of both chunks."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    if sq % q_chunk or sk % kv_chunk:
        raise ValueError(f"lengths {sq}, {sk} not multiples of the chunks "
                         f"{q_chunk}, {kv_chunk}")
    nq, nk = sq // q_chunk, sk // kv_chunk
    scale = d ** -0.5
    qg = q.reshape(b, nq, q_chunk, hkv, g, d)
    kc = k.reshape(b, nk, kv_chunk, hkv, d)
    vc = v.reshape(b, nk, kv_chunk, hkv, d)
    dev = q.device
    outs = []
    for qi in range(nq):
        qb = qg[:, qi].float()                   # (b, q_chunk, hkv, g, d)
        pos_q = qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b, hkv, g, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, g, q_chunk), device=dev)
        acc = torch.zeros((b, hkv, g, q_chunk, d), device=dev)
        for kj in range(nk):
            pos_k = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqkgd,bskd->bkgqs", qb,
                             kc[:, kj].float()) * scale
            s = softcap(s, attn_softcap)
            s = torch.where(_mask(pos_q, pos_k, causal, window), s,
                            torch.full_like(s, NEG_INF))
            m_cur = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_cur)
            p = torch.exp(s - m_cur[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vc[:, kj].float())
            m = m_cur
        out = acc / torch.clamp(l, min=1e-37)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))  # (b, q_chunk, hkv, g, d)
    return torch.stack(outs, dim=1).reshape(b, sq, h, d).to(q.dtype)


def attention_any(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  attn_softcap: float = 0.0,
                  chunk_threshold: int = CHUNK_THRESHOLD,
                  q_chunk: int = Q_CHUNK,
                  kv_chunk: int = KV_CHUNK) -> torch.Tensor:
    """The reference's dispatch: ``full_attention`` up to
    ``chunk_threshold`` tokens or when a length is not a multiple of its
    chunk, ``chunked_attention`` past it."""
    sq, sk = q.shape[1], k.shape[1]
    if max(sq, sk) <= chunk_threshold or sq % q_chunk or sk % kv_chunk:
        return full_attention(q, k, v, causal=causal, window=window,
                              attn_softcap=attn_softcap)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             attn_softcap=attn_softcap, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)


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


def decode_attention_ring(q: torch.Tensor, k_ring: torch.Tensor,
                          v_ring: torch.Tensor, *, pos: int,
                          attn_softcap: float = 0.0) -> torch.Tensor:
    """One query token against a window-sized ring buffer.

    q: (B, 1, H, D); k_ring, v_ring: (B, W, Hkv, D), where slot ``s``
    holds the KV of the latest position ``p`` with ``p % W == s``; ``pos``
    is the position of the current token (a host int). Every resident
    entry lies inside the window, so the only mask is the fill level:
    slots ``> pos`` are empty until the ring first wraps (``pos >= W``).
    The softcap comes before that mask, as in the reference.

    The empty slots are not read (the reference masks them to
    probability 0). The slots are read oldest first (the reference reads
    them in slot order) into a contiguous window that ``decode_attention``
    takes whole, so the windowed decode gives ``decode_step``'s logits
    bit for bit.
    """
    w = k_ring.shape[1]
    if pos < w:
        k, v = k_ring[:, :pos + 1], v_ring[:, :pos + 1]
    else:               # slot (pos + 1) % W holds the oldest position
        s = (pos + 1) % w
        k = torch.cat([k_ring[:, s:], k_ring[:, :s]], dim=1)
        v = torch.cat([v_ring[:, s:], v_ring[:, :s]], dim=1)
    return decode_attention(q, k, v, pos=k.shape[1] - 1,
                            attn_softcap=attn_softcap)
