"""Architecture registry of the port: ``get_config(arch, smoke=False)``.

Every arch of the JAX registry: ``dit-xl-512``, ``pixart-alpha`` and
``sd15-unet`` (diffusion), ``olmo-1b``, ``gemma2-9b``, ``gemma3-27b`` and
``glm4-9b`` (dense), ``deepseek-moe-16b`` and ``kimi-k2-1t-a32b`` (MoE),
``mamba2-370m`` (SSM), ``hymba-1.5b`` (hybrid), ``whisper-base``
(enc-dec) and ``internvl2-76b`` (VLM). The last two are reached through
training (``train.steps``), as in the reference, which serves neither.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import ModelConfig

_MODULES: Dict[str, str] = {
    "dit-xl-512": "dit_xl_512",
    "pixart-alpha": "pixart_alpha",
    "sd15-unet": "sd15_unet",
    "olmo-1b": "olmo_1b",
    "gemma2-9b": "gemma2_9b",
    "gemma3-27b": "gemma3_27b",
    "glm4-9b": "glm4_9b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "mamba2-370m": "mamba2_370m",
    "hymba-1.5b": "hymba_1p5b",
    "whisper-base": "whisper_base",
    "internvl2-76b": "internvl2_76b",
}


#: every arch, in the reference registry's order (the order of its
#: ``list_archs``, its dry-run and its CLI help)
ALL_ARCHS = ("gemma3-27b", "gemma2-9b", "olmo-1b", "glm4-9b", "whisper-base",
             "kimi-k2-1t-a32b", "deepseek-moe-16b", "mamba2-370m",
             "hymba-1.5b", "internvl2-76b", "dit-xl-512", "pixart-alpha",
             "sd15-unet")


def list_archs() -> List[str]:
    return list(ALL_ARCHS)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    name = arch.replace("_", "-")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.FULL

