"""mamba2-370m [ssm] -- 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060; unverified]"""
import torch

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    norm="rmsnorm", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-370m-smoke", family="ssm",
    n_layers=3, d_model=64, vocab=512,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=8,
    norm="rmsnorm", dtype=torch.float32,
)
