"""TaylorSeer-style cache-based acceleration (paper Sec 6.6, Table 2).

Counterpart of ``repro.diffusion.taylorseer``. The denoiser runs every
``interval`` steps; a skipped step's output is *forecast* by a Taylor
expansion in step index built from finite differences of the cached
outputs (order <= 2). Forecast steps run no GEMM, so they cannot fault.

The table's count ``n_computed`` is a host int, so choosing between the
first differences and zeros needs no device sync. The forecast's
coefficients ``u = k / interval`` and ``0.5 * u * (u - 1)`` are f32, as
the reference computes them, so forecasts are bit-equal to its own.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TaylorSeerConfig:
    interval: int = 3
    order: int = 2
    enabled: bool = True


class TaylorState(NamedTuple):
    y: torch.Tensor      # last computed output
    dy: torch.Tensor     # first finite difference (per computed step)
    d2y: torch.Tensor    # second finite difference
    n_computed: int


def init_state(shape, dtype=torch.float32, device="cpu") -> TaylorState:
    z = torch.zeros(shape, dtype=dtype, device=device)
    return TaylorState(z, z, z, 0)


def update_on_compute(state: TaylorState, y_new: torch.Tensor
                      ) -> TaylorState:
    """Refresh the Taylor table after a real model evaluation."""
    dy_new = y_new - state.y
    d2y_new = dy_new - state.dy
    n = state.n_computed
    if n < 1:
        dy_new = torch.zeros_like(dy_new)
    if n < 2:
        d2y_new = torch.zeros_like(d2y_new)
    return TaylorState(y_new, dy_new, d2y_new, n + 1)


def forecast(state: TaylorState, k: int, interval: int,
             order: int = 2) -> torch.Tensor:
    """Predict the output k steps after the last computed one.

    Differences are per computed step (spacing = interval), so the local
    coordinate is u = k / interval."""
    u = np.float32(k) / np.float32(interval)
    y = state.y + float(u) * state.dy
    if order >= 2:
        c2 = np.float32(0.5) * u * (u - np.float32(1.0))
        y = y + float(c2) * state.d2y
    return y


def should_compute(step: int, cfg: TaylorSeerConfig) -> bool:
    if not cfg.enabled:
        return True
    return step % cfg.interval == 0


def speedup(num_steps: int, cfg: TaylorSeerConfig) -> float:
    """Analytical network-eval speedup (skipped steps are free)."""
    if not cfg.enabled:
        return 1.0
    computed = (num_steps + cfg.interval - 1) // cfg.interval
    return num_steps / computed
