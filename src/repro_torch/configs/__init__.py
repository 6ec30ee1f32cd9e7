"""Architecture registry of the port: ``get_config(arch, smoke=False)``.

``dit-xl-512``, ``pixart-alpha`` and ``sd15-unet`` (diffusion),
``olmo-1b``, ``gemma2-9b``, ``gemma3-27b`` and ``glm4-9b``
(autoregressive, dense), ``deepseek-moe-16b`` and ``kimi-k2-1t-a32b``
(autoregressive, MoE), ``mamba2-370m`` (SSM) and ``hymba-1.5b``
(hybrid) are ported; any other arch the JAX registry
knows raises, naming the ROADMAP queue item that ports it.
"""
from __future__ import annotations

import importlib
from typing import Dict

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
}

# Archs of the JAX registry that a later slice ports (ROADMAP Queue A).
_NOT_YET_PORTED: Dict[str, str] = {
    "whisper-base": "Queue A item 12.4 (enc-dec and VLM)",
    "internvl2-76b": "Queue A item 12.4 (enc-dec and VLM)",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    name = arch.replace("_", "-")
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not yet ported to repro_torch; see ROADMAP "
            f"{_NOT_YET_PORTED[name]}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.FULL

