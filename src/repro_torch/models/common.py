"""Shared model machinery: the model config, layernorm and inits.

Counterpart of ``repro.models.common``, reduced to what the DiT path uses.
Parameters are plain nested dicts of tensors, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dit (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- DiT (diffusion) ---
    latent_size: int = 0             # spatial latent (e.g. 64 for 512px f8)
    latent_channels: int = 4
    patch_size: int = 2
    num_classes: int = 0
    # --- execution ---
    dtype: torch.dtype = torch.bfloat16      # activation/compute dtype
    param_dtype: torch.dtype = torch.float32

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def tokens(self) -> int:
        return (self.latent_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size ** 2 * self.latent_channels


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


# ----------------------------------------------------------------- norms
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
