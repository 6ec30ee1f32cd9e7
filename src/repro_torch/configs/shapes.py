"""Assigned input-shape sets and per-arch cell applicability.

Counterpart of ``repro.configs.shapes``, copied: pure Python, so the
perfmodel's ``cell_flops`` can read a cell without the JAX package.

LM shapes (seq_len x global_batch):
  train_4k     4,096 x 256   -- training step
  prefill_32k  32,768 x 32   -- inference prefill
  decode_32k   32,768 x 128  -- one new token, 32k KV cache (serve_step)
  long_500k    524,288 x 1   -- long-context decode (sub-quadratic archs)

Diffusion (paper) shapes:
  denoise_train  latents 64x64x4, batch 256  -- DiT/UNet training step
  sample_512     latents 64x64x4, batch 64   -- one denoising serve step

Skips:
  long_500k  : skipped for pure full-attention archs (olmo, glm4, kimi-k2,
               deepseek-moe, internvl2) -- every layer would carry the full
               524288-entry KV cache; run for SSM/hybrid (mamba2, hymba) and
               the local-attention gemma family (gemma3 5:1, gemma2 1:1
               local:global).
  long_500k  : skipped for whisper (decoder context is 448 by design).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                 # train | prefill | decode | denoise_train | sample
    seq_len: int = 0
    global_batch: int = 0


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

DIFFUSION_SHAPES = {
    "denoise_train": ShapeSpec("denoise_train", "denoise_train", 0, 256),
    "sample_512": ShapeSpec("sample_512", "sample", 0, 64),
}

# archs allowed to run the 500k-decode cell (sub-quadratic / local-attention)
LONG_CONTEXT_OK = {"mamba2-370m", "hymba-1.5b", "gemma3-27b", "gemma2-9b"}

LM_ARCHS = ("gemma3-27b", "gemma2-9b", "olmo-1b", "glm4-9b", "whisper-base",
            "kimi-k2-1t-a32b", "deepseek-moe-16b", "mamba2-370m",
            "hymba-1.5b", "internvl2-76b")
DIFFUSION_ARCHS = ("dit-xl-512", "pixart-alpha", "sd15-unet")


def cells_for(arch: str) -> Tuple[str, ...]:
    """Shape cells applicable to an arch (the dry-run/roofline matrix)."""
    if arch in DIFFUSION_ARCHS:
        return tuple(DIFFUSION_SHAPES)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_OK:
        cells.append("long_500k")
    return tuple(cells)


def skipped_cells(arch: str) -> Dict[str, str]:
    if arch in DIFFUSION_ARCHS:
        return {}
    out = {}
    if arch not in LONG_CONTEXT_OK:
        reason = ("decoder max context 448; backbone decode_32k still run"
                  if arch == "whisper-base"
                  else "pure full attention: 500k KV on every layer")
        out["long_500k"] = reason
    return out


def get_shape(name: str) -> ShapeSpec:
    return {**LM_SHAPES, **DIFFUSION_SHAPES}[name]
