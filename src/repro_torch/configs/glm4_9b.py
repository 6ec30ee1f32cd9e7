"""glm4-9b [dense] -- 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552, RoPE, GQA. [hf:THUDM/glm-4-9b]"""
import torch

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=151552, attn_pattern=("global",),
    norm="rmsnorm", act="silu", tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="glm4-9b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128, vocab=512,
    attn_pattern=("global",), norm="rmsnorm", act="silu",
    tie_embeddings=False, dtype=torch.float32,
)
