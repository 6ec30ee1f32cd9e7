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

``stat_abft_matmul`` is the quantized backend, a composite over the port's
int8 ABFT kernel (``kernels.abft_matmul``, 32x32 checksum tiles): it flags
(row, N-tile) pairs whose INT32 row-checksum residual magnitude exceeds
``threshold_mag``. Row tiles wider than 32 sum their 32-column checksums
mod 2^32, which is exact. ``|act - exp|`` is taken in wrapping int32, as
``jnp.abs`` takes it, so a residual of ``INT32_MIN`` stays negative and is
never flagged. It is not on the decode path: (batch, 1, d) decode GEMMs
never tile-align, and the decode loop uses the float ``detect``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.abft import wrap_i32
from repro_torch.kernels import abft_matmul as _abft

#: safety factor on the rounding envelope (the reference's constant).
ALPHA = 4.0

#: absolute floor so all-zero rows don't flag their own rounding dust.
TAU_FLOOR = 1e-6


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
    """The composite's work, its bound on the card: the product and the
    row checksums at ``bn`` in int8 operations; A, B and flips read, c
    written, one flag byte a (row, N-tile)."""
    return {"flops": 0, "int8_ops": 2 * m * n * k + 2 * m * k * (n // bn),
            "bytes": m * k + k * n + 8 * m * n + m * (n // bn)}


def _stat_abft(mm, aq, bq, flips, threshold_mag, bm, bn):
    m, n = aq.shape[0], bq.shape[1]
    if bm % _abft.TILE or bn % _abft.TILE:
        raise ValueError(f"tiles ({bm}, {bn}) must be multiples of the "
                         f"ABFT kernel's {_abft.TILE}-wide checksum tile")
    if m % bm or n % bn:
        raise ValueError(f"M={m}, N={n} must be multiples of ({bm}, {bn})")
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
    """The same composite over the ABFT kernel's plain version."""
    return _stat_abft(_abft.abft_matmul_plain, aq, bq, flips, threshold_mag,
                      bm, bn)


def stat_abft_matmul(aq: torch.Tensor, bq: torch.Tensor, flips: torch.Tensor,
                     threshold_mag: int, bm: int = 128, bn: int = 128
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized statistical ABFT: ``(c_faulty (M, N) int32,
    detected (M, N / bn) bool)``. ``aq (M, K)``, ``bq (K, N)`` int8,
    ``flips (M, N)`` int32; M and N multiples of (bm, bn), K any.
    ``threshold_mag == 0`` is exact ABFT. Its one kernel launch is counted
    by ``abft_matmul``."""
    return _stat_abft(_abft.abft_matmul, aq, bq, flips, threshold_mag, bm,
                      bn)
