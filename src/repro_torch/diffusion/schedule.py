"""Diffusion noise schedules: DDPM forward process and DDIM steps.

Counterpart of ``repro.diffusion.schedule``. The cumulative alphas stay a
host numpy f32 array: the sampler's timesteps are host ints, so each DDIM
step reads its coefficients without touching the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DdpmSchedule:
    betas: np.ndarray           # (T,) f32
    alphas_cum: np.ndarray      # (T,) f32, cumulative prod of (1 - beta)
    num_steps: int

    @staticmethod
    def default(num_steps: int = 1000, beta_start: float = 1e-4,
                beta_end: float = 2e-2) -> "DdpmSchedule":
        betas = np.linspace(beta_start, beta_end, num_steps, dtype=np.float32)
        alphas_cum = np.cumprod(1.0 - betas)
        return DdpmSchedule(betas, alphas_cum, num_steps)

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor,
                 eps: torch.Tensor) -> torch.Tensor:
        """Forward noising: x_t = sqrt(a_t) x0 + sqrt(1 - a_t) eps, in f32.
        t: (B,) integer timesteps on any device."""
        a = torch.from_numpy(self.alphas_cum).to(x0.device)[t.long()]
        sh = (-1,) + (1,) * (x0.ndim - 1)
        return (torch.sqrt(a).reshape(sh) * x0
                + torch.sqrt(1.0 - a).reshape(sh) * eps)

    def ddim_step(self, x_t: torch.Tensor, eps_pred: torch.Tensor, t: int,
                  t_prev: int) -> torch.Tensor:
        """Deterministic DDIM update from step t to t_prev (eta=0), in f32,
        with x0 clipped to [-4, 4]."""
        a_t = np.float32(self.alphas_cum[max(int(t), 0)])
        a_p = (np.float32(self.alphas_cum[max(int(t_prev), 0)])
               if t_prev >= 0 else np.float32(1.0))
        x0 = (x_t - float(np.sqrt(np.float32(1.0) - a_t)) * eps_pred) \
            / float(np.sqrt(a_t))
        x0 = torch.clamp(x0, -4.0, 4.0)
        return float(np.sqrt(a_p)) * x0 \
            + float(np.sqrt(np.float32(1.0) - a_p)) * eps_pred


def ddim_timesteps(num_train_steps: int, num_sample_steps: int) -> np.ndarray:
    """Evenly spaced sampling timesteps, descending (e.g. 1000 -> 50)."""
    return np.linspace(num_train_steps - 1, 0, num_sample_steps
                       ).round().astype(np.int32)
