"""dit-xl-512 -- DiT-XL/2 at 512x512: 28L d=1152 16H d_ff=4608, latent
64x64x4, patch 2 (1024 tokens), 1000 ImageNet classes.
[arXiv:2212.09748 (Peebles & Xie)]"""
import torch

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="dit-xl-512", family="dit",
    n_layers=28, d_model=1152, n_heads=16, d_ff=4608,
    latent_size=64, latent_channels=4, patch_size=2, num_classes=1000,
)

SMOKE = ModelConfig(
    name="dit-smoke", family="dit",
    n_layers=3, d_model=64, n_heads=4, d_ff=256,
    latent_size=8, latent_channels=4, patch_size=2, num_classes=10,
    dtype=torch.float32,
)

# ~100M-parameter trainable variant for the end-to-end training example
TRAIN_100M = ModelConfig(
    name="dit-s-train", family="dit",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    latent_size=16, latent_channels=4, patch_size=2, num_classes=10,
    norm="layernorm", dtype=torch.float32,
)
