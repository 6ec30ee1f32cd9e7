"""deepseek-moe-16b [moe] -- 28L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=102400, 2 shared + 64 routed top-6, fine-grained experts.
[arXiv:2401.06066; hf]"""
import torch

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=102400,
    n_experts=64, n_shared_experts=2, top_k=6, capacity_factor=1.25,
    attn_pattern=("global",), norm="rmsnorm", act="silu",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32, vocab=512,
    n_experts=8, n_shared_experts=2, top_k=3, capacity_factor=8.0,
    attn_pattern=("global",), norm="rmsnorm", act="silu",
    tie_embeddings=False, dtype=torch.float32,
)
