"""olmo-1b [dense] -- 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304,
non-parametric LayerNorm. [arXiv:2402.00838; hf]"""
import torch

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=50304, attn_pattern=("global",),
    norm="nonparam_ln", act="silu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="olmo-1b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    attn_pattern=("global",), norm="nonparam_ln", act="silu",
    dtype=torch.float32,
)
