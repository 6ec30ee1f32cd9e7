"""Fused faulty INT8 GEMM with ABFT checksums (wrapper, plain version).

Replaces the TPU kernel ``repro/kernels/abft_matmul.py::abft_matmul``
(``pl.pallas_call`` at line 118, body ``_kernel`` at line 32). For
``aq (M, K) int8``, ``bq (K, N) int8`` and ``flips (M, N) int32`` bit
patterns it returns, all in wraparound int32:

    c       (M, Nt)  -> (M, N): (aq @ bq) ^ flips
    act_row (M, Nt)  per (row, N-tile) sums of c
    exp_row (M, Nt)  aq @ blocksum(bq), the expected row sums
    act_col (Mt, N)  per (M-tile, column) sums of c
    exp_col (Mt, N)  blocksum(aq) @ bq, the expected column sums

The CUDA kernel (``csrc/abft_matmul.cu``) runs the product on the int8
tensor cores (``mma.sync`` m16n8k32), one block of 8 warps per 128x128
output tile and one warp per two 32x32 checksum tiles (``AbftConfig``'s
tile), and takes the expected sums from the clean accumulator in the
epilogue (exact mod 2^32; see the source). On an H100 it is bound by
bytes: the int32 flips and C dominate (~83 MB at 2048x1152x4608, ~25 us
at 3.35 TB/s, against ~11 us for the int8 product at the tensor-core
peak). ``launch_args`` picks its vector loads (``K % 16 == 0`` and
aligned operands) or its byte-wise staging for any other K.

``abft_matmul`` takes the plain version for CPU tensors only; a CUDA
tensor launches the kernel or raises. ``launches`` counts kernel launches.
``work`` is the kernel's own work, which ``launch.op_analysis`` counts for
each call (meta tensors too, under its counter) and the card check's bound
reads.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.core.abft import wrap_i32
from repro_torch.kernels import _count, _lib

TILE = 32
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_void_p] * 6)


def work(m: int, k: int, n: int) -> Dict[str, int]:
    """The kernel's work on ``(M, K) @ (K, N)``: int8 operations of the
    product and of both expected checksums; bytes with each input read
    once (A, B int8, flips int32) and each output written once (c and the
    four checksum arrays, int32)."""
    mt, nt = m // TILE, n // TILE
    return {"flops": 0,
            "int8_ops": 2 * m * n * k + 2 * m * k * nt + 2 * mt * k * n,
            "bytes": (m * k + k * n + 4 * m * n + 4 * m * n + 8 * m * nt
                      + 8 * mt * n)}


def abft_matmul_plain(aq: torch.Tensor, bq: torch.Tensor, flips: torch.Tensor,
                      bm: int = TILE, bn: int = TILE
                      ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version (``ref.abft_matmul_ref``). torch has no integer
    matmul on CUDA, so products run in float64 -- exact here, since every
    |value| stays below 2^53 -- and wrap to int32 through int64."""
    m, k = aq.shape
    n = bq.shape[1]
    mt, nt = m // bm, n // bn
    a = aq.double()
    b = bq.double()
    c = wrap_i32((a @ b).long()) ^ flips
    c64 = c.long()
    act_row = wrap_i32(c64.reshape(m, nt, bn).sum(2))
    exp_row = wrap_i32((a @ b.reshape(k, nt, bn).sum(2)).long())
    act_col = wrap_i32(c64.reshape(mt, bm, n).sum(1))
    exp_col = wrap_i32((a.reshape(mt, bm, k).sum(1) @ b).long())
    return c, act_row, exp_row, act_col, exp_col


def _check(aq, bq, flips, bm, bn):
    if aq.dtype != torch.int8 or bq.dtype != torch.int8:
        raise TypeError(f"abft_matmul takes int8 operands, got {aq.dtype}, "
                        f"{bq.dtype}")
    if flips.dtype != torch.int32:
        raise TypeError(f"flips must be int32 bit patterns, got "
                        f"{flips.dtype}")
    if aq.ndim != 2 or bq.ndim != 2 or aq.shape[1] != bq.shape[0]:
        raise ValueError(f"bad GEMM shapes {tuple(aq.shape)} @ "
                         f"{tuple(bq.shape)}")
    m, n = aq.shape[0], bq.shape[1]
    if tuple(flips.shape) != (m, n):
        raise ValueError(f"flips {tuple(flips.shape)} != C {(m, n)}")
    if m % bm or n % bn:
        raise ValueError(f"M={m}, N={n} must be multiples of the tile "
                         f"({bm}, {bn}); the caller pads")
    if not (aq.device == bq.device == flips.device):
        raise ValueError("abft_matmul operands on different devices")


def launch_args(aq: torch.Tensor, bq: torch.Tensor) -> Tuple[int, ...]:
    """(M, N, K, vec) for the CUDA launcher: ``vec`` takes the 16-byte
    ``cp.async`` loads of A and 4-byte loads of B, which need K % 16 == 0,
    A 16-byte and B 4-byte aligned; otherwise the kernel stages both byte
    by byte."""
    m, k = aq.shape
    n = bq.shape[1]
    vec = k % 16 == 0 and aq.data_ptr() % 16 == 0 and bq.data_ptr() % 4 == 0
    return m, n, k, vec


def abft_matmul(aq: torch.Tensor, bq: torch.Tensor, flips: torch.Tensor,
                bm: int = TILE, bn: int = TILE) -> Tuple[torch.Tensor, ...]:
    """(c, act_row, exp_row, act_col, exp_col); see the module docstring."""
    _check(aq, bq, flips, bm, bn)
    with _count.kernel("abft_matmul", work, aq.shape[0], aq.shape[1],
                       bq.shape[1]):
        return _abft_matmul(aq, bq, flips, bm, bn)


def _abft_matmul(aq, bq, flips, bm, bn):
    global launches
    if _count.meta_call(aq.device):
        m, n = aq.shape[0], bq.shape[1]
        return tuple(torch.empty(shape, dtype=torch.int32, device="meta")
                     for shape in ((m, n), (m, n // bn), (m, n // bn),
                                   (m // bm, n), (m // bm, n)))
    if aq.device.type == "cpu":
        return abft_matmul_plain(aq, bq, flips, bm, bn)
    if aq.device.type != "cuda":
        raise ValueError(f"abft_matmul: unsupported device {aq.device}")
    if (bm, bn) != (TILE, TILE):
        raise ValueError(f"the CUDA kernel's checksum tile is {TILE}x{TILE}, "
                         f"got ({bm}, {bn})")
    aq, bq, flips = aq.contiguous(), bq.contiguous(), flips.contiguous()
    m, n, k, vec = launch_args(aq, bq)
    mt, nt = m // TILE, n // TILE
    dev = aq.device
    c = torch.empty((m, n), dtype=torch.int32, device=dev)
    act_row = torch.empty((m, nt), dtype=torch.int32, device=dev)
    exp_row = torch.empty((m, nt), dtype=torch.int32, device=dev)
    act_col = torch.empty((mt, n), dtype=torch.int32, device=dev)
    exp_col = torch.empty((mt, n), dtype=torch.int32, device=dev)
    fn = _lib.function("abft_matmul", "abft_matmul_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(aq.data_ptr(), bq.data_ptr(), flips.data_ptr(), m, n, k,
                 int(vec), c.data_ptr(), act_row.data_ptr(),
                 exp_row.data_ptr(), act_col.data_ptr(), exp_col.data_ptr(),
                 _lib.stream_of(dev))
    _lib.check(err, "abft_matmul")
    launches += 1
    return c, act_row, exp_row, act_col, exp_col
