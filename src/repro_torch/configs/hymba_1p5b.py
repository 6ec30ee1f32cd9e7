"""hymba-1.5b [hybrid] -- 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16: parallel attention + mamba heads per layer,
SWA everywhere except 3 global layers (first/middle/last).
[arXiv:2411.13676; hf]"""
import torch

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab=32001, head_dim=64,
    attn_pattern=("local",), global_layer_indices=(0, 15, 31), window=1024,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    norm="rmsnorm", act="silu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="hymba-smoke", family="hybrid",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16, attn_pattern=("local",), global_layer_indices=(0, 2),
    window=8, ssm_state=8, ssm_expand=2, ssm_head_dim=16, ssm_chunk=8,
    norm="rmsnorm", act="silu", dtype=torch.float32,
)
