"""Rollback correction, the recovery scheduler's splice (wrapper, plain
version).

Replaces the TPU kernel ``repro/kernels/rollback_correct.py::
rollback_correct`` (``pl.pallas_call`` at line 49, body ``_kernel`` at
line 21), with the same inputs. For ``c, ckpt (M, N) f32``, the per-tile
checksum differences ``row_diff (M, Nt)`` and ``col_diff (Mt, N)`` (int32)
and ``threshold``, it flags each row and column with
``core.abft._exceeds`` (not ``abs``: it must survive an INT32_MIN
difference), masks each tile by the union (or cross) of its flagged rows
and columns, and returns ``where(mask, ckpt, c)``. In place of the Pallas
kernel's per-tile any-flag it returns the per-tile count of masked elements
inside ``valid`` (the caller's unpadded rows and columns; the whole array
by default), so ``tile_count > 0`` is that flag and ``tile_count.sum()``
the corrected-element count.

The CUDA kernel (``csrc/rollback_correct.cu``) runs one block per 32x32
tile and sums the count with ``__syncthreads_count``, no atomics. It is
elementwise, so bytes bound it on an H100: per element one f32 read (ckpt
where masked, else c) and one f32 write, ~75 MB at 2048x4608, ~23 us at
3.35 TB/s.

``rollback_correct`` takes the plain version for CPU tensors only; a CUDA
tensor launches the kernel or raises. ``launches`` counts kernel launches.
``work`` is the kernel's own work (``abft_matmul``'s docstring says who
reads it).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.abft import _exceeds
from repro_torch.kernels import _count, _lib

TILE = 32
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_void_p] * 3)

Valid = Optional[Tuple[int, int]]


def work(m: int, n: int) -> Dict[str, int]:
    """The kernel's work on an (M, N) output: per element one f32 read
    (ckpt where masked, else c) and one f32 write; the row and column
    differences read; the per-tile count written. No arithmetic counted."""
    mt, nt = m // TILE, n // TILE
    return {"flops": 0, "int8_ops": 0,
            "bytes": 8 * m * n + 4 * m * nt + 4 * mt * n + 4 * mt * nt}


def rollback_correct_plain(c: torch.Tensor, ckpt: torch.Tensor,
                           row_diff: torch.Tensor, col_diff: torch.Tensor,
                           threshold: int, bm: int = TILE, bn: int = TILE,
                           union: bool = True, valid: Valid = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (``ref.rollback_correct_ref``, with the tile
    count in place of the tile flag)."""
    m, n = c.shape
    mt, nt = m // bm, n // bn
    vm, vn = (m, n) if valid is None else valid
    r_elem = _exceeds(row_diff, threshold).repeat_interleave(bn, dim=1)
    c_elem = _exceeds(col_diff, threshold).repeat_interleave(bm, dim=0)
    mask = (r_elem | c_elem) if union else (r_elem & c_elem)
    out = torch.where(mask, ckpt, c)
    inside = ((torch.arange(m, device=c.device) < vm)[:, None]
              & (torch.arange(n, device=c.device) < vn)[None, :])
    tile_count = (mask & inside).reshape(mt, bm, nt, bn).sum(dim=(1, 3))
    return out, tile_count.to(torch.int32)


def _check(c, ckpt, row_diff, col_diff, bm, bn, valid):
    if c.dtype != torch.float32 or ckpt.dtype != torch.float32:
        raise TypeError(f"rollback_correct takes f32 c/ckpt, got {c.dtype}, "
                        f"{ckpt.dtype}")
    if row_diff.dtype != torch.int32 or col_diff.dtype != torch.int32:
        raise TypeError("row_diff/col_diff must be int32")
    m, n = c.shape
    if m % bm or n % bn:
        raise ValueError(f"M={m}, N={n} must be multiples of ({bm}, {bn})")
    mt, nt = m // bm, n // bn
    if (tuple(ckpt.shape) != (m, n) or tuple(row_diff.shape) != (m, nt)
            or tuple(col_diff.shape) != (mt, n)):
        raise ValueError(
            f"shapes c {tuple(c.shape)}, ckpt {tuple(ckpt.shape)}, row_diff "
            f"{tuple(row_diff.shape)}, col_diff {tuple(col_diff.shape)}")
    if not (c.device == ckpt.device == row_diff.device == col_diff.device):
        raise ValueError("rollback_correct operands on different devices")
    if valid is not None and not (0 <= valid[0] <= m and 0 <= valid[1] <= n):
        raise ValueError(f"valid region {valid} outside ({m}, {n})")


def rollback_correct(c: torch.Tensor, ckpt: torch.Tensor,
                     row_diff: torch.Tensor, col_diff: torch.Tensor,
                     threshold: int, bm: int = TILE, bn: int = TILE,
                     union: bool = True, valid: Valid = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(corrected (M, N) f32, tile_count (Mt, Nt) int32)."""
    _check(c, ckpt, row_diff, col_diff, bm, bn, valid)
    with _count.kernel("rollback_correct", work, *c.shape):
        return _rollback_correct(c, ckpt, row_diff, col_diff, threshold,
                                 bm, bn, union, valid)


def _rollback_correct(c, ckpt, row_diff, col_diff, threshold, bm, bn,
                      union, valid):
    global launches
    if _count.meta_call(c.device):
        m, n = c.shape
        return (torch.empty_like(c),
                torch.empty((m // bm, n // bn), dtype=torch.int32,
                            device="meta"))
    if c.device.type == "cpu":
        return rollback_correct_plain(c, ckpt, row_diff, col_diff, threshold,
                                      bm, bn, union, valid)
    if c.device.type != "cuda":
        raise ValueError(f"rollback_correct: unsupported device {c.device}")
    if (bm, bn) != (TILE, TILE):
        raise ValueError(f"the CUDA kernel's tile is {TILE}x{TILE}, got "
                         f"({bm}, {bn})")
    c, ckpt = c.contiguous(), ckpt.contiguous()
    row_diff, col_diff = row_diff.contiguous(), col_diff.contiguous()
    m, n = c.shape
    vm, vn = (m, n) if valid is None else valid
    dev = c.device
    out = torch.empty_like(c)
    tile_count = torch.empty((m // TILE, n // TILE), dtype=torch.int32,
                             device=dev)
    fn = _lib.function("rollback_correct", "rollback_correct_launch",
                       _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(c.data_ptr(), ckpt.data_ptr(), row_diff.data_ptr(),
                 col_diff.data_ptr(), int(threshold), int(bool(union)), m, n,
                 int(vm), int(vn), out.data_ptr(), tile_count.data_ptr(),
                 _lib.stream_of(dev))
    _lib.check(err, "rollback_correct")
    launches += 1
    return out, tile_count
