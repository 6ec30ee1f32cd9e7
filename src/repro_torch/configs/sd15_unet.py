"""sd15-unet -- Stable Diffusion v1.5 conditional UNet backbone: channels
(320, 640, 1280), latent 64x64x4, CLIP text conditioning (stub: 77 x 768
embeddings). [arXiv:2112.10752]"""
import torch

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="sd15-unet", family="unet",
    n_layers=0, d_model=1280, unet_channels=(320, 640, 1280),
    latent_size=64, latent_channels=4,
    cond_dim=768, cond_tokens=77,
)

SMOKE = ModelConfig(
    name="sd15-smoke", family="unet",
    n_layers=0, d_model=128, unet_channels=(32, 64, 96),
    latent_size=16, latent_channels=4,
    cond_dim=32, cond_tokens=8, dtype=torch.float32,
)
