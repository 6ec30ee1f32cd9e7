"""Analytical FLOPs/bytes accounting per (architecture x shape).

Counterpart of ``repro.perfmodel.flops``, copied with every expression's
association unchanged. MODEL_FLOPS definitions:
  train:  6 * N_active * D        (fwd 2ND + bwd 4ND)
  prefill: 2 * N_active * D  + attention term
  decode: 2 * N_active * B   + attention-read term
plus explicit attention FLOPs (2 * 2 * S^2 * d per layer at train/prefill,
window-clipped for local layers), which the 6ND rule ignores.

The port has the DiT (PixArt's cross-attention term included), the UNet
and the dense, MoE, SSM and hybrid LM families (the SSD scan's term).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import shapes as shapes_lib
from repro_torch.models import dit as dit_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.common import ModelConfig


def active_params(cfg: ModelConfig) -> float:
    """Parameters touched per token (MoE: top-k + shared experts only)."""
    if cfg.family != "moe":
        n = tf_lib.param_count(cfg) if cfg.family not in ("dit", "unet") \
            else dit_lib.param_count(cfg)
        return float(n)
    d, f = cfg.d_model, cfg.d_ff
    per_layer = (d * cfg.n_heads * cfg.hd + 2 * d * cfg.kv_heads * cfg.hd
                 + cfg.n_heads * cfg.hd * d)
    per_layer += (3 * d * f * (cfg.top_k + cfg.n_shared_experts)
                  + d * cfg.n_experts)
    n = cfg.n_layers * per_layer + cfg.vocab * d
    if not cfg.tie_embeddings:
        n += cfg.vocab * d
    return float(n)


def _attn_flops_full(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Score + mix FLOPs over all layers, window-aware (causal halves it)."""
    total = 0.0
    if cfg.family != "ssm":
        for w in cfg.layer_windows():
            eff = seq if w == 0 else min(w, seq)
            # sum over query positions of attended length (causal avg)
            attended = seq * eff * (0.5 if w == 0 else 1.0)
            total += 2 * 2 * attended * cfg.n_heads * cfg.hd * batch
    if cfg.family in ("ssm", "hybrid"):
        total += cfg.n_layers * _ssd_flops(cfg, batch, seq)
    return total


def _ssd_flops(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Chunked SSD per layer: intra-chunk quadratic form + state recurrence.

    Per chunk of length Q: CB scores 2*Q^2*G*N, y_intra 2*Q^2*H*P,
    chunk state 2*Q*N*H*P, y_inter 2*Q*N*H*P. Decode (seq==1): one
    recurrence update 4*N*H*P.
    """
    ng, ns = cfg.ssm_groups, cfg.ssm_state
    nh, hp = cfg.ssm_heads, cfg.ssm_head_dim
    if seq <= 1:
        return batch * 4.0 * ns * nh * hp
    q = min(cfg.ssm_chunk, seq)
    nc = -(-seq // q)
    per_chunk = (2.0 * q * q * ng * ns + 2.0 * q * q * nh * hp
                 + 4.0 * q * ns * nh * hp)
    return batch * nc * per_chunk


def cell_flops(cfg: ModelConfig, shape: shapes_lib.ShapeSpec
               ) -> Dict[str, float]:
    """MODEL_FLOPS for one (arch, shape) cell."""
    n_act = active_params(cfg)
    if shape.kind == "train":
        d_tokens = shape.global_batch * shape.seq_len
        return {"model_flops": 6.0 * n_act * d_tokens
                + 3.0 * _attn_flops_full(cfg, shape.global_batch,
                                         shape.seq_len),
                "tokens": float(d_tokens)}
    if shape.kind == "prefill":
        d_tokens = shape.global_batch * shape.seq_len
        return {"model_flops": 2.0 * n_act * d_tokens
                + _attn_flops_full(cfg, shape.global_batch, shape.seq_len),
                "tokens": float(d_tokens)}
    if shape.kind == "decode":
        b = shape.global_batch
        attn = 0.0
        if cfg.family != "ssm":
            for w in cfg.layer_windows():
                eff = shape.seq_len if w == 0 else min(w, shape.seq_len)
                attn += 2 * 2 * eff * cfg.n_heads * cfg.hd * b
        if cfg.family in ("ssm", "hybrid"):
            attn += cfg.n_layers * _ssd_flops(cfg, b, 1)
        return {"model_flops": 2.0 * n_act * b + attn, "tokens": float(b)}
    if shape.kind in ("denoise_train", "sample"):
        t = (cfg.latent_size // cfg.patch_size) ** 2 if cfg.family == "dit" \
            else (cfg.latent_size ** 2)   # unet ~ per-pixel proxy
        d_tokens = shape.global_batch * t
        mult = 6.0 if shape.kind == "denoise_train" else 2.0
        extra = (_attn_flops_full(cfg, shape.global_batch, t)
                 if cfg.family == "dit" else 0.0)
        return {"model_flops": mult * active_params(cfg) * d_tokens
                + (mult / 2) * extra,
                "tokens": float(d_tokens)}
    raise ValueError(shape.kind)


def mac_bit_energy_scale(bits: int, base_bits: int = 8) -> float:
    """On-die energy per MAC at a narrowed operand width, relative to the
    INT8 baseline: multiplier area/energy grows with the product of operand
    widths, so e_mac ~ (bits/8)^2. Exactly 1.0 at the baseline width --
    the degenerate precision plan prices (and computes) identically to the
    pre-plan path."""
    return (bits / base_bits) ** 2


def mac_bit_time_scale(bits: int, base_bits: int = 8) -> float:
    """MAC time at a narrowed operand width relative to INT8: a
    weight-stationary systolic array streams ``bits``-wide operands, so
    throughput scales ~ 1/bits (int4 packs two ops where int8 packs one).
    Exactly 1.0 at the baseline width."""
    return bits / base_bits


#: nominal decode context length the per-token serving cost is quoted at
#: (KV reads grow with position; the engine charges a fixed mid-stream
#: context so batch cost stays affine in step count like diffusion).
DECODE_CONTEXT = 1024


def gemm_macs_per_model_eval(cfg: ModelConfig, batch: int = 1) -> float:
    """INT8 MACs for one model evaluation (the perf/energy model unit).

    For the DiT one eval is a denoiser pass over the latent grid; for LM
    families one eval is ONE DECODE STEP (a token per sequence): weight
    MACs ~= active params, plus window-clipped KV attention reads at
    ``DECODE_CONTEXT``.
    """
    if cfg.family not in ("dit", "unet"):
        macs = active_params(cfg)
        attn = 0.0
        if cfg.family != "ssm":
            for w in cfg.layer_windows():
                eff = DECODE_CONTEXT if w == 0 else min(w, DECODE_CONTEXT)
                attn += 2.0 * eff * cfg.n_heads * cfg.hd
        if cfg.family in ("ssm", "hybrid"):
            attn += cfg.n_layers * _ssd_flops(cfg, 1, 1) / 2.0
        return batch * (macs + attn)
    if cfg.family == "dit":
        t = (cfg.latent_size // cfg.patch_size) ** 2
        d = cfg.d_model
        per_block = t * (4 * d * d + 2 * d * cfg.d_ff + 6 * d * d / t
                         + (4 * d * d if cfg.cond_tokens else 0))
        attn = 2 * t * t * d
        pdim = cfg.patch_size ** 2 * cfg.latent_channels
        embed = t * pdim * d * 2 + 256 * d + d * d
        return batch * (cfg.n_layers * (per_block + attn) + embed)
    if cfg.family == "unet":
        # conv-dominated; approximate via param sweep at latent res
        c = cfg.unet_channels
        s = cfg.latent_size
        total = 0.0
        res = s
        for i, ch in enumerate(c):
            cin = c[max(i - 1, 0)]
            total += res * res * (9 * cin * ch + 9 * ch * ch) * 2
            if i >= 1:
                total += res * res * ch * ch * 4 + res ** 4 * ch
            res //= 2
        return batch * 2.3 * total    # down+mid+up
    raise ValueError(cfg.family)
