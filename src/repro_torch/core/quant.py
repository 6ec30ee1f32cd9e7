"""Symmetric INT8 quantization with INT32 accumulation.

Counterpart of ``repro.core.quant``. ``quantize`` runs in the dtype of its
input: the DiT casts each f32 weight to the activation dtype before the
protected GEMM, so at full width ``amax``, ``max(amax, 1e-8) / 127`` and
``x / scale`` are all bf16 arithmetic, and only the finished scale becomes
f32 -- exactly as in the reference. ``torch.round`` rounds half to even,
like ``jnp.round``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

INT8_MAX = 127.0


@dataclasses.dataclass(frozen=True)
class QTensor:
    """An int8 tensor plus its (broadcastable) float32 scale."""

    q: torch.Tensor      # int8
    scale: torch.Tensor  # f32, broadcastable against q


def quantize(x: torch.Tensor, axis: Optional[int] = None) -> QTensor:
    """Symmetric int8 quantization.

    axis=None  -> per-tensor scale (0-d).
    axis=k     -> per-channel scales along ``k`` (scale keeps dim k).
    """
    if axis is None:
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

