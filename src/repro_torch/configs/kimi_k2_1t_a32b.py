"""kimi-k2-1t-a32b [moe] -- 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, MoE 384 routed experts top-8 (+1 shared, per the K2 report).
Trillion-parameter MoE (paper-table entry). [arXiv:2501.kimi2; unverified]

~1.04e12 parameters: 2.1 TB in bf16, so FULL fits no single card in any
dtype; one card serves SMOKE only.
"""
import torch

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163840, head_dim=112,
    n_experts=384, n_shared_experts=1, top_k=8, capacity_factor=1.25,
    attn_pattern=("global",), norm="rmsnorm", act="silu",
    tie_embeddings=False,
    param_dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=32, vocab=512,
    head_dim=8, n_experts=8, n_shared_experts=1, top_k=2,
    capacity_factor=8.0, attn_pattern=("global",), norm="rmsnorm",
    act="silu", tie_embeddings=False, dtype=torch.float32,
)
