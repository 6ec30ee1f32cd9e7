"""Statistical ABFT for float GEMMs (ReaLM-style) and its quantized backend.

Counterpart of ``repro.kernels.stat_abft``. A float GEMM's checksum
residual

    r_i = sum_j y[i, j]  -  x_i . (W @ 1)

is nonzero even without a fault (rounding), so detection fires only when
``|r_i|`` exceeds the per-row envelope
``tau_i = ALPHA * eps * K * (|x_i| . rowsum|W|) + TAU_FLOOR``, with
``eps`` the unit roundoff of the coarser operand dtype. All checksum math
runs in float32. ``threshold``, ``residuals`` and ``detect`` take the
weight's per-row sums either from ``w`` itself, as the reference does on
every call, or precomputed once from the same weight (``w_sum``,
``w_abs_sum``; see ``weight_sums``): the decode path keeps them beside its
bf16 weight copy, which is bit-identical and saves a pass over every
weight per GEMM.

``stat_abft_matmul`` is the quantized backend: it flags (row, N-tile)
pairs whose INT32 row-checksum residual magnitude exceeds
``threshold_mag``. ``|act - exp|`` is taken in wrapping int32, as
``jnp.abs`` takes it, so a residual of ``INT32_MIN`` stays negative and is
never flagged. On a CUDA tensor it is one launch of its own kernel
(``csrc/stat_abft.cu``: TMA loads into swizzled shared memory, ``wgmma``
on the int8 tensor cores, the row-checksum differences and the threshold
in the epilogue), which replaces the TPU function
``repro/kernels/stat_abft.py::stat_abft_matmul``. The kernel takes B
K-major, so the wrapper first launches the library's transpose of
``bq`` (``k_major_plain`` is its plain version), and K zero-padded to a
multiple of 16 (``a_operand``). Row tiles of ``bn`` in ``BN_TAKEN``
run an instance of their own; any other multiple of 32 runs the 32-wide
instance's residuals, then the library's sum of each ``bn // 32`` of them
mod 2^32 and its threshold (``row_tile_plan``). On the CPU it runs
``stat_abft_matmul_plain``, the composite over the port's int8 ABFT
kernel's plain version (32x32 checksum tiles): row tiles wider than 32
sum their 32-column checksums mod 2^32, which is exact. ``launches``
counts kernel launches. It is not on the decode path: (batch, 1, d)
decode GEMMs never tile-align, and the decode loop uses the float
``detect``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.abft import wrap_i32
from repro_torch.kernels import _count, _lib
from repro_torch.kernels import abft_matmul as _abft

#: safety factor on the rounding envelope (the reference's constant).
ALPHA = 4.0

#: absolute floor so all-zero rows don't flag their own rounding dust.
TAU_FLOOR = 1e-6

#: the row-tile widths with a CUDA kernel instance of their own; any other
#: multiple of 32 runs the 32-wide instance's residuals through a sum of
#: each ``bn // 32`` of them (``row_tile_plan``)
BN_TAKEN = (32, 64, 128)

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] + [ctypes.c_void_p] * 4)
_T_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


def unit_roundoff(dtype: torch.dtype) -> float:
    """``finfo(dtype).eps / 2``: 2^-8 for bf16, 2^-24 for f32."""
    return float(torch.finfo(dtype).eps) / 2.0


def _eps_for(x: torch.Tensor, w_dtype: torch.dtype) -> float:
    return max(unit_roundoff(x.dtype), unit_roundoff(w_dtype))


def weight_sums(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_j w[k, j], sum_j |w[k, j]|), both (K,) f32, by the reference's
    ops on ``w`` cast to f32."""
    wf = w.float()
    return wf.sum(dim=-1), wf.abs().sum(dim=-1)


def threshold(x: torch.Tensor, w: torch.Tensor,
              w_abs_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row detection threshold tau, shape ``x.shape[:-1]``.

    x: (..., K) activations, w: (K, N) weights."""
    k = x.shape[-1]
    eps = _eps_for(x, w.dtype)
    if w_abs_sum is None:
        w_abs_sum = w.float().abs().sum(dim=-1)                  # (K,)
    envelope = x.float().abs() @ w_abs_sum                       # (...,)
    return ALPHA * eps * float(k) * envelope + TAU_FLOOR


def residuals(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
              w_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Checksum residual ``r_i = sum_j y_ij - x_i . (W @ 1)``, shape
    ``x.shape[:-1]``."""
    if w_sum is None:
        w_sum = w.float().sum(dim=-1)                            # (K,)
    expected = x.float() @ w_sum
    actual = y.float().sum(dim=-1)
    return actual - expected


def detect(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
           w_sum: Optional[torch.Tensor] = None,
           w_abs_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row fault flags: ``|residual|`` above the statistical
    threshold."""
    return detect_and_nan(x, w, y, w_sum, w_abs_sum)[0]


def detect_and_nan(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                   w_sum: Optional[torch.Tensor] = None,
                   w_abs_sum: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``detect``'s flags and, apart, the rows whose residual is NaN: a
    flip that turns a word into a NaN makes ``|r| > tau`` false, so
    ``detect`` (as the reference's) never flags it (ROADMAP Queue C item
    6)."""
    r = residuals(x, w, y, w_sum).abs()
    return r > threshold(x, w, w_abs_sum), torch.isnan(r)


def min_detectable_magnitude(x: torch.Tensor, w: torch.Tensor
                             ) -> torch.Tensor:
    """Smallest per-row |delta| a single corrupted element must carry to be
    detected wherever the clean residual sits inside the envelope:
    ``2 * tau``."""
    return 2.0 * threshold(x, w)


def work(m: int, k: int, n: int, bn: int = 128) -> Dict[str, int]:
    """The kernel's work, its bound on the card: the product in int8
    operations (the expected row sums come from the clean accumulator, at
    no product of their own); A, B and flips read, c written, one flag
    byte a (row, N-tile)."""
    return {"flops": 0, "int8_ops": 2 * m * n * k,
            "bytes": m * k + k * n + 8 * m * n + m * (n // bn)}


def _check_tiles(m, n, threshold_mag, bm, bn):
    if bm % _abft.TILE or bn % _abft.TILE:
        raise ValueError(f"tiles ({bm}, {bn}) must be multiples of the "
                         f"ABFT kernel's {_abft.TILE}-wide checksum tile")
    if m % bm or n % bn:
        raise ValueError(f"M={m}, N={n} must be multiples of ({bm}, {bn})")
    if not -2 ** 31 <= int(threshold_mag) < 2 ** 31:
        raise ValueError(f"threshold_mag {threshold_mag} is not an int32 "
                         "(the reference takes jnp.int32(threshold_mag))")


def _stat_abft(mm, aq, bq, flips, threshold_mag, bm, bn):
    m, n = aq.shape[0], bq.shape[1]
    _check_tiles(m, n, threshold_mag, bm, bn)
    c, act_row, exp_row, _, _ = mm(aq, bq, flips)
    diff = act_row.long() - exp_row.long()                 # (M, N/32)
    group = bn // _abft.TILE
    resid = wrap_i32(diff.reshape(m, n // bn, group).sum(dim=2))
    # |resid| in wrapping int32: abs(INT32_MIN) wraps back to INT32_MIN.
    resid_abs = wrap_i32(resid.long().abs())
    return c, resid_abs > int(threshold_mag)


def stat_abft_matmul_plain(aq: torch.Tensor, bq: torch.Tensor,
                           flips: torch.Tensor, threshold_mag: int,
                           bm: int = 128, bn: int = 128
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The composite over the ABFT kernel's plain version; the function
    the CUDA kernel is held to."""
    return _stat_abft(_abft.abft_matmul_plain, aq, bq, flips, threshold_mag,
                      bm, bn)


def launch_args(aq: torch.Tensor, bq: torch.Tensor,
                bn: int) -> Tuple[int, int, int, int]:
    """(M, N, Kp, bn) for the CUDA launcher: K zero-padded to Kp, a
    multiple of 16 (a tensor map's row stride). Raises for a ``bn`` that
    is not a multiple of 32 dividing N."""
    m, k = aq.shape
    n = bq.shape[1]
    if bn <= 0 or bn % _abft.TILE or n % bn:
        raise ValueError(f"row tile {bn} is not a multiple of "
                         f"{_abft.TILE} that divides N = {n}")
    return m, n, max(16, -(-k // 16) * 16), bn


def row_tile_plan(bn: int) -> Tuple[int, int]:
    """(instance, group): the kernel instance a row tile ``bn`` runs and
    how many of its row-tile residuals each flag sums (1: the instance's
    own flags, one launch; more: the 32-wide instance's residuals, then
    the library's sum-and-threshold launch)."""
    return (bn, 1) if bn in BN_TAKEN else (_abft.TILE, bn // _abft.TILE)


def a_operand(aq: torch.Tensor, kp: int) -> torch.Tensor:
    """``aq`` as the kernel reads it: (M, Kp) contiguous, 16-byte aligned,
    zero-padded from K to ``kp``."""
    k = aq.shape[1]
    if kp != k:
        return F.pad(aq, (0, kp - k))
    if not aq.is_contiguous() or aq.data_ptr() % 16:
        return aq.clone(memory_format=torch.contiguous_format)
    return aq


def k_major_plain(bq: torch.Tensor, kp: int) -> torch.Tensor:
    """The plain version of the kernel's transpose: ``bq.t()`` (N, Kp),
    contiguous, zero-padded from K to ``kp``."""
    return F.pad(bq.t(), (0, kp - bq.shape[0])).contiguous()


def _k_major(bq: torch.Tensor, kp: int) -> torch.Tensor:
    """``k_major_plain`` by the library's transpose kernel (16-byte
    accesses through a 64x64 shared tile), on the card."""
    k, n = bq.shape
    if not bq.is_contiguous() or bq.data_ptr() % 16:
        bq = bq.clone(memory_format=torch.contiguous_format)
    bt = torch.empty((n, kp), dtype=torch.int8, device=bq.device)
    fn = _lib.function("stat_abft", "stat_abft_transpose_launch",
                       _T_ARGTYPES)
    _lib.check(fn(bq.data_ptr(), k, n, kp, bt.data_ptr(),
                  _lib.stream_of(bq.device)), "stat_abft transpose")
    return bt


def stat_abft_matmul(aq: torch.Tensor, bq: torch.Tensor, flips: torch.Tensor,
                     threshold_mag: int, bm: int = 128, bn: int = 128
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized statistical ABFT: ``(c_faulty (M, N) int32,
    detected (M, N / bn) bool)``. ``aq (M, K)``, ``bq (K, N)`` int8,
    ``flips (M, N)`` int32; M and N multiples of (bm, bn), K any.
    ``threshold_mag == 0`` is exact ABFT. One kernel launch on the card,
    counted as ``stat_abft_matmul``."""
    _abft._check(aq, bq, flips, bm, bn)
    m, k = aq.shape
    n = bq.shape[1]
    _check_tiles(m, n, threshold_mag, bm, bn)
    with _count.kernel("stat_abft_matmul", work, m, k, n, bn):
        return _stat_abft_matmul(aq, bq, flips, threshold_mag, bm, bn)


def _stat_abft_matmul(aq, bq, flips, threshold_mag, bm, bn):
    global launches
    if _count.meta_call(aq.device):
        m, n = aq.shape[0], bq.shape[1]
        return (torch.empty((m, n), dtype=torch.int32, device="meta"),
                torch.empty((m, n // bn), dtype=torch.bool, device="meta"))
    if aq.device.type == "cpu":
        return stat_abft_matmul_plain(aq, bq, flips, threshold_mag, bm, bn)
    if aq.device.type != "cuda":
        raise ValueError(f"stat_abft_matmul: unsupported device {aq.device}")
    m, n, kp, bn = launch_args(aq, bq, bn)
    group = row_tile_plan(bn)[1]
    dev = aq.device
    flips = flips.contiguous()
    if flips.data_ptr() % 16:
        flips = flips.clone()
    c = torch.empty((m, n), dtype=torch.int32, device=dev)
    detected = torch.empty((m, n // bn), dtype=torch.bool, device=dev)
    resid = (None if group == 1 else
             torch.empty((m, n // _abft.TILE), dtype=torch.int32, device=dev))
    fn = _lib.function("stat_abft", "stat_abft_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        a, bt = a_operand(aq, kp), _k_major(bq, kp)
        err = fn(a.data_ptr(), bt.data_ptr(), flips.data_ptr(), m, n, kp, bn,
                 int(threshold_mag), c.data_ptr(), detected.data_ptr(),
                 None if resid is None else resid.data_ptr(),
                 _lib.stream_of(dev))
    _lib.check(err, "stat_abft_matmul")
    launches += 1
    return c, detected
