"""internvl2-76b [vlm] -- 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256: InternViT frontend STUB (input_specs provides 256 precomputed
patch embeddings) + InternLM2/Llama3-70B-class backbone.
[arXiv:2404.16821; unverified]"""
import torch

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab=128256, vis_tokens=256,
    attn_pattern=("global",), norm="rmsnorm", act="silu",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    vis_tokens=8, attn_pattern=("global",), norm="rmsnorm", act="silu",
    tie_embeddings=False, dtype=torch.float32,
)
