"""pixart-alpha -- PixArt-alpha-512: DiT backbone 28L d=1152 16H d_ff=4608
plus cross-attention to T5-XXL text tokens (stub: (B, 120, 4096)
embeddings). [arXiv:2310.00426]"""
import torch

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="pixart-alpha", family="dit",
    n_layers=28, d_model=1152, n_heads=16, n_kv_heads=16, d_ff=4608,
    latent_size=64, latent_channels=4, patch_size=2,
    cond_dim=4096, cond_tokens=120,
)

SMOKE = ModelConfig(
    name="pixart-smoke", family="dit",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256,
    latent_size=8, latent_channels=4, patch_size=2,
    cond_dim=32, cond_tokens=8, dtype=torch.float32,
)
