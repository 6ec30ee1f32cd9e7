"""whisper-base [audio] -- 6L d_model=512 8H d_ff=2048 vocab=51865,
enc-dec with conv frontend STUB (input_specs provides precomputed 1500-frame
embeddings). [arXiv:2212.04356; unverified]"""
import torch

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab=51865, n_encoder_layers=6, encoder_seq=1500, cross_attention=True,
    norm="layernorm", act="gelu",
)

SMOKE = ModelConfig(
    name="whisper-base-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    n_encoder_layers=2, encoder_seq=20, cross_attention=True,
    norm="layernorm", act="gelu", dtype=torch.float32,
)
