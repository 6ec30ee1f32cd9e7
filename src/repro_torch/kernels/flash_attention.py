"""Online-softmax (flash) attention (wrapper, plain version, (B,S,H,D) fold).

Replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (``pl.pallas_call`` at line 83, body ``_kernel`` at
line 30) and its ``mha_flash`` fold wrapper (line 105). ``q, k, v`` are
``(BH, S, D)`` f32 or bf16 with D <= 128; the output has the input dtype.
The constants are the TPU kernel's: masked scores ``NEG_INF = -2e38``, the
normaliser clamped at ``1e-37``, scale ``D ** -0.5``; causal or not.

The CUDA kernel (``csrc/flash_attention.cu``) computes in f32 on CUDA cores
(the DiT's head dim 72 is no multiple of 16, and the reference softmax is
f32), so the f32 rate bounds it on an H100: 4*BH*S*S*D flops over
67 TFLOP/s, ~0.15 ms at BH=32, S=1024, D=72.

The plain version is ``models.attention.full_attention`` on the folded
heads. ``flash_attention`` takes it for CPU tensors only; a CUDA tensor
launches the kernel or raises. ``launches`` counts kernel launches,
those made through ``mha_flash`` (the wrapper the DiT block and the LM
prefill call) included.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.models.attention import full_attention

MAX_D = 128
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """(BH, S, D) attention through ``full_attention``."""
    bh, s, d = q.shape
    o = full_attention(q.reshape(bh, s, 1, d), k.reshape(bh, s, 1, d),
                       v.reshape(bh, s, 1, d), causal=causal)
    return o.reshape(bh, s, d)


def _check(q, k, v):
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes f32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (BH, S, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[2] > MAX_D:
        raise ValueError(f"head dim {q.shape[2]} > {MAX_D}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention operands on different devices")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """q, k, v: (BH, S, D) -> (BH, S, D) in the input dtype."""
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bh, s, d = q.shape
    o = torch.empty_like(q)
    fn = _lib.function("flash_attention", "flash_attention_launch",
                       _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh,
                 s, d, d ** -0.5, int(bool(causal)), _DTYPES[q.dtype],
                 _lib.stream_of(q.device))
    _lib.check(err, "flash_attention")
    launches += 1
    return o


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False) -> torch.Tensor:
    """(B, S, H, D) wrapper: folds heads into the kernel's (BH, S, D)."""
    b, s, h, d = q.shape

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, s, d)
    o = flash_attention(fold(q), fold(k), fold(v), causal=causal)
    return o.reshape(b, h, s, d).transpose(1, 2)
