"""gemma3-27b [dense] -- 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local:global interleave, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
import torch

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21504,
    vocab=262144, head_dim=168,
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024, norm="rmsnorm", act="gelu", tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="gemma3-27b-smoke", family="dense",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16,
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    window=8, norm="rmsnorm", act="gelu", tie_embeddings=True,
    dtype=torch.float32,
)
