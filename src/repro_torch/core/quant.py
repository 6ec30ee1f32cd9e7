"""Symmetric INT8 quantization with INT32 accumulation, and the
resilience-aware precision plans.

Counterpart of ``repro.core.quant``. ``quantize`` runs in the dtype of its
input: the DiT casts each f32 weight to the activation dtype before the
protected GEMM, so at full width ``amax``, ``max(amax, 1e-8) / 127`` and
``x / scale`` are all bf16 arithmetic, and only the finished scale becomes
f32 -- exactly as in the reference. ``torch.round`` rounds half to even,
like ``jnp.round``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

INT8_MAX = 127.0
BASE_BITS = 8


@dataclasses.dataclass(frozen=True)
class QTensor:
    """An int8 tensor plus its (broadcastable) float32 scale."""

    q: torch.Tensor      # int8
    scale: torch.Tensor  # f32, broadcastable against q


def quantize(x: torch.Tensor, axis: Optional[int] = None,
             amax: Optional[torch.Tensor] = None) -> QTensor:
    """Symmetric int8 quantization.

    axis=None  -> per-tensor scale (0-d); ``amax`` overrides the tensor's
                  own max |x| (a data-parallel rank passes the batch's).
    axis=k     -> per-channel scales along ``k`` (scale keeps dim k).
    """
    if axis is None:
        if amax is None:
            amax = x.abs().amax()
    else:
        reduce_dims = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
        amax = x.abs().amax(dim=reduce_dims, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / INT8_MAX
    q = torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX)
    return QTensor(q=q.to(torch.int8), scale=scale.float())


def dequantize_matmul(acc: torch.Tensor, a_scale: torch.Tensor,
                      b_scale: torch.Tensor) -> torch.Tensor:
    """De-scale an int32 accumulator back to f32: ``(acc * a) * b``."""
    return acc.float() * a_scale * b_scale


# ---------------------------------------------------------------------------
# Resilience-aware precision plans (the serving frontier's precision knob)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PrecisionPlan:
    """Per-block-class / per-timestep bit-width assignment.

    ``body_bits`` applies to the resilient body blocks on resilient
    timesteps (``step >= protect_steps``). Everything the resilience
    policy protects -- embeddings, the first block, and the first
    ``protect_steps`` timesteps -- stays at ``BASE_BITS``.
    """
    name: str
    body_bits: int = BASE_BITS
    # Leading timesteps that never narrow; mirrors the DVFS schedule's
    # ``nominal_steps`` protection window. Rebind per engine via
    # :meth:`with_protect_steps` so both protections share one constant.
    protect_steps: int = 2

    def __post_init__(self):
        if not 2 <= self.body_bits <= BASE_BITS:
            raise ValueError(
                f"body_bits must be in [2, {BASE_BITS}], got {self.body_bits}")

    @property
    def narrowed(self) -> bool:
        """True when this plan narrows anything (the default ``"int8"``
        plan is a no-op: the sampler adds no op for it)."""
        return self.body_bits < BASE_BITS

    def with_protect_steps(self, n: int) -> "PrecisionPlan":
        return dataclasses.replace(self, protect_steps=int(n))


#: The plan ladder, widest first. "int8" is the degenerate plan; the
#: narrowed plans keep the sensitive sites at INT8 and drop only the
#: resilient body.
PRECISION_PLANS: Dict[str, PrecisionPlan] = {
    "int8": PrecisionPlan("int8", body_bits=8),
    "int8-body6": PrecisionPlan("int8-body6", body_bits=6),
    "int8-body4": PrecisionPlan("int8-body4", body_bits=4),
}

DEFAULT_PLAN = PRECISION_PLANS["int8"]


def quant_error_bound(k_dim: int) -> float:
    """Worst-case |accumulator| of an int8 GEMM contracting ``k_dim``:
    127^2 * K, which must stay below 2^31 for the int32 accumulator not
    to saturate."""
    return INT8_MAX * INT8_MAX * k_dim


def get_plan(name: str) -> PrecisionPlan:
    """Plan registry lookup with a reasoned error for unknown names."""
    plan = PRECISION_PLANS.get(name)
    if plan is None:
        raise ValueError(f"unknown precision plan {name!r}; one of "
                         f"{tuple(PRECISION_PLANS)}")
    return plan


def fake_quant(x: torch.Tensor, bits: int,
               amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric fake quantization to ``bits`` (quantize-dequantize) on a
    ``2**(bits-1) - 1``-level grid with a per-tensor scale, in ``x``'s
    dtype, by the same ops as :func:`quantize` (an all-zero ``x`` takes
    the 1e-8 floor); ``amax`` overrides the tensor's own max |x|."""
    levels = float(2 ** (int(bits) - 1) - 1)
    if amax is None:
        amax = x.abs().amax()
    scale = torch.clamp_min(amax, 1e-8) / levels
    return torch.clamp(torch.round(x / scale), -levels, levels) * scale


def quant_noise(bits: int) -> float:
    """Relative quantization step size of a ``bits``-wide symmetric grid:
    ``2**-(bits-1)``; exactly the INT8 baseline's for the default plan."""
    return 2.0 ** (-(int(bits) - 1))
