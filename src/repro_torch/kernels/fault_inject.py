"""Bit-flip injection on 32-bit words (wrapper, plain version).

Replaces the TPU kernel ``repro/kernels/fault_inject.py::fault_inject``
(``pl.pallas_call`` at line 30, body ``_kernel`` at line 17). For ``x``
int32 or f32 (its raw bits) and an int32 xor mask of the same shape it
returns ``x ^ mask`` in ``x``'s dtype; bit 31 of the mask is
``INT32_MIN``. Any shape: the Pallas kernel's (bm, bn) blocks are not
carried over.

The CUDA kernel (``csrc/fault_inject.cu``) gives each thread one 16-byte
vector of four words where the pointers allow (else one word), with the
grid sized to the work and 32-bit indices. Bytes bound it on an H100 (12
bytes per word over 3.35 TB/s); at the decode path's shapes (16 to 64 KB
per call) launch latency does. One launch covers up to ``CHUNK`` words;
larger inputs take one launch per ``CHUNK``.

``fault_inject`` takes the plain version for CPU tensors only; a CUDA
tensor launches the kernel or raises. ``launches`` counts kernel launches.
``work`` is the kernel's own work (``abft_matmul``'s docstring says who
reads it).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _count, _lib

CHUNK = 1 << 30                  # words per launch (csrc's CHUNK)
launches = 0

_DTYPES = (torch.int32, torch.float32)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p]


def work(words: int) -> Dict[str, int]:
    """The kernel's work on ``words`` 32-bit words: x and the mask read,
    the output written (12 bytes a word); the xor is not counted."""
    return {"flops": 0, "int8_ops": 0, "bytes": 12 * words}


def fault_inject_plain(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: xor on the int32 view, viewed back."""
    return (x.view(torch.int32) ^ mask).view(x.dtype)


def _check(x, mask):
    if x.dtype not in _DTYPES:
        raise TypeError(f"fault_inject takes int32 or float32 words, got "
                        f"{x.dtype}")
    if mask.dtype != torch.int32:
        raise TypeError(f"the flip mask must be int32 bit patterns, got "
                        f"{mask.dtype}")
    if x.shape != mask.shape:
        raise ValueError(f"mask {tuple(mask.shape)} != x {tuple(x.shape)}")
    if x.device != mask.device:
        raise ValueError("fault_inject operands on different devices")


def fault_inject(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``x ^ mask`` on the raw 32-bit words, in ``x``'s dtype."""
    _check(x, mask)
    with _count.kernel("fault_inject", work, x.numel()):
        return _fault_inject(x, mask)


def _fault_inject(x, mask):
    global launches
    if _count.meta_call(x.device):
        return torch.empty_like(x)
    if x.device.type == "cpu":
        return fault_inject_plain(x, mask)
    if x.device.type != "cuda":
        raise ValueError(f"fault_inject: unsupported device {x.device}")
    x, mask = x.contiguous(), mask.contiguous()
    out = torch.empty_like(x)
    fn = _lib.function("fault_inject", "fault_inject_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), mask.data_ptr(), out.data_ptr(), x.numel(),
                 _lib.stream_of(x.device))
    _lib.check(err, "fault_inject")
    launches += -(-x.numel() // CHUNK)
    return out
