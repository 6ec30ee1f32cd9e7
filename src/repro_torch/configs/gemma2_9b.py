"""gemma2-9b [dense] -- 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000, local+global alternating, logit softcap. [arXiv:2408.00118; hf]"""
import torch

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_ff=14336,
    vocab=256000, head_dim=256,
    attn_pattern=("local", "global"), window=4096,
    logit_softcap=30.0, attn_softcap=50.0,
    norm="rmsnorm", act="gelu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma2-9b-smoke", family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16, attn_pattern=("local", "global"), window=8,
    logit_softcap=30.0, attn_softcap=50.0,
    norm="rmsnorm", act="gelu", dtype=torch.float32,
)
