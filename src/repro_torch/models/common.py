"""Shared model machinery: the model config, norms, RoPE, activations, inits.

Counterpart of ``repro.models.common``, reduced to what the DiT, PixArt,
UNet, the decoder LMs (dense, MoE, SSM, hybrid, VLM) and the enc-dec model
use. Parameters are plain nested dicts of tensors, as in the reference.
The reference's ``remat`` and ``scan_layers`` fields are left out: the
port runs its layers in a Python loop and keeps every activation for the
backward pass (no per-layer recompute).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_leaves

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str      # dit | unet | dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- attention pattern (LM) ---
    attn_pattern: Tuple[str, ...] = ("global",)   # cycled over layers
    global_layer_indices: Tuple[int, ...] = ()    # force-global layers (hymba)
    window: int = 1024               # sliding-window size for 'local' layers
    logit_softcap: float = 0.0       # gemma2-style final-logit softcap
    attn_softcap: float = 0.0        # gemma2-style attention-logit softcap
    norm: str = "rmsnorm"            # rmsnorm | layernorm | nonparam_ln
    act: str = "silu"                # silu | gelu
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_groups: int = 1
    # --- enc-dec (whisper) ---
    n_encoder_layers: int = 0
    encoder_seq: int = 0             # stub frame count (whisper: 1500)
    cross_attention: bool = False
    # --- VLM ---
    vis_tokens: int = 0              # stub patch-embedding count
    # --- DiT / UNet (diffusion) ---
    latent_size: int = 0             # spatial latent (e.g. 64 for 512px f8)
    latent_channels: int = 4
    patch_size: int = 2
    cond_dim: int = 0                # text-conditioning width (0 = class-cond)
    cond_tokens: int = 0             # text tokens for cross-attn (PixArt/SD)
    unet_channels: Tuple[int, ...] = ()
    num_classes: int = 0
    # --- execution ---
    dtype: torch.dtype = torch.bfloat16      # activation/compute dtype
    param_dtype: torch.dtype = torch.float32

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def tokens(self) -> int:
        return (self.latent_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size ** 2 * self.latent_channels

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer attention kind, cycling ``attn_pattern`` over depth;
        the layers of ``global_layer_indices`` are global."""
        p = self.attn_pattern
        kinds = [p[i % len(p)] for i in range(self.n_layers)]
        for i in self.global_layer_indices:
            kinds[i % self.n_layers] = "global"
        return tuple(kinds)

    def layer_windows(self) -> Tuple[int, ...]:
        """Per-layer window (0 = unbounded/global)."""
        return tuple(0 if k == "global" else self.window
                     for k in self.layer_kinds())

    @property
    def ssm_heads(self) -> int:
        return (self.d_model * self.ssm_expand) // self.ssm_head_dim

    @property
    def d_inner(self) -> int:
        return self.d_model * self.ssm_expand


# ----------------------------------------------------------------- inits
def trunc_normal(shape, std: float, dtype: torch.dtype, device,
                 generator: torch.Generator) -> torch.Tensor:
    """``std`` times a standard normal truncated to [-2, 2], as
    ``jax.random.truncated_normal(key, -2, 2)`` draws it."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2.0 * std,
                                b=2.0 * std, generator=generator)
    return t.to(dtype)


def dense_init(d_in: int, d_out: int, dtype: torch.dtype, device,
               generator: torch.Generator) -> torch.Tensor:
    return trunc_normal((d_in, d_out), 1.0 / math.sqrt(d_in), dtype, device,
                        generator)


def embed_init(vocab: int, d: int, dtype: torch.dtype, device,
               generator: torch.Generator) -> torch.Tensor:
    return trunc_normal((vocab, d), 1.0, dtype, device, generator)


# ----------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(dt)


def layernorm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in f32, cast back to ``x.dtype``. The
    variance is the population variance (``jnp.var``), hence
    ``unbiased=False``."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def apply_norm(cfg: ModelConfig, p: Optional[Params],
               x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, None if p is None else p.get("scale"))
    if cfg.norm == "layernorm":
        return layernorm(x, None if p is None else p.get("scale"),
                         None if p is None else p.get("bias"))
    if cfg.norm == "nonparam_ln":   # OLMo: non-parametric LayerNorm
        return layernorm(x)
    raise ValueError(f"norm {cfg.norm!r}")


def norm_params(cfg: ModelConfig, device="cpu") -> Params:
    if cfg.norm == "rmsnorm":
        return {"scale": torch.zeros((cfg.d_model,), dtype=cfg.param_dtype,
                                     device=device)}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((cfg.d_model,), dtype=cfg.param_dtype,
                                    device=device),
                "bias": torch.zeros((cfg.d_model,), dtype=cfg.param_dtype,
                                    device=device)}
    return {}  # nonparam_ln


# ------------------------------------------------------------------ RoPE
def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D), positions: (B, S) or (S,). Each head splits in
    halves (not interleaved pairs), as in the reference."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)               # (D/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs           # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def activation(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "silu":
        return F.silu(x)
    if cfg.act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation.
        return F.gelu(x, approximate="tanh")
    raise ValueError(cfg.act)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


def count_params(params) -> int:
    """Elements over the tensors of a param tree (meta tensors too)."""
    return sum(p.numel() for p in tree_leaves(params)
               if isinstance(p, torch.Tensor))
