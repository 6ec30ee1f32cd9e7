"""Algorithm-based fault tolerance (ABFT) for the INT8 GEMM.

Counterpart of ``repro.core.abft``: the config, the overflow-safe
threshold test and the full-matrix detector (``detect_int``,
``detect_f32``, ``correction_mask``). The per-tile checksums and the tile
mask are computed by ``kernels.abft_matmul`` and
``kernels.rollback_correct``, whose plain versions are the PyTorch
reference; ``ExecContext`` takes the full-row and full-column differences
from the kernel's per-tile ones (sums over the N and over the M tiles,
mod 2^32; padded rows and columns hold zeros and add nothing), so
``detect_int`` stays as the plain version the tests hold them against. All checksum arithmetic
wraps mod 2^32, like int32 in XLA: ``wrap_i32`` reduces int64 explicitly,
since signed overflow is not something to lean on.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch


def _exceeds(diff: torch.Tensor, thr) -> torch.Tensor:
    """|diff| >= thr robust to int32 overflow: abs(INT32_MIN) wraps negative,
    so a bit-31 flip (delta = -2^31) would escape an abs()-based check."""
    return (diff >= thr) | (diff <= -thr)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Reduce an int64 tensor mod 2^32 into int32 two's complement."""
    return (torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class AbftConfig:
    threshold_bit: int = 10        # errors >= 2**threshold_bit are "large"
    tile_m: int = 32               # systolic-array tile (paper default 32)
    tile_n: int = 32
    # 'cross' = flagged rows x flagged cols within a tile (paper Fig 10a);
    # 'union' = whole flagged rows AND whole flagged cols of a tile.
    mask_policy: str = "union"

    @property
    def threshold(self) -> int:
        return 1 << self.threshold_bit


class AbftReport(NamedTuple):
    """Detection output for one GEMM."""

    row_diff: torch.Tensor   # (M,) signed error sum per row (int32 or f32)
    col_diff: torch.Tensor   # (N,) signed error sum per column
    row_flag: torch.Tensor   # (M,) bool, |row_diff| >= threshold
    col_flag: torch.Tensor   # (N,) bool
    n_row_err: torch.Tensor  # 0-d int64
    n_col_err: torch.Tensor  # 0-d int64


def _report(row_diff, col_diff, row_flag, col_flag) -> AbftReport:
    return AbftReport(row_diff, col_diff, row_flag, col_flag,
                      row_flag.sum(), col_flag.sum())


def expected_checksums_int(aq: torch.Tensor, bq: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A @ B1, 1T A @ B) in wraparound int32. aq (M, K), bq (K, N) int8.
    torch has no integer matmul on CUDA, so the products run in float64,
    exact while K * 127^2 * max(M, N) stays below 2^53, and wrap once."""
    a, b = aq.double(), bq.double()
    return (wrap_i32((a @ b.sum(1)).long()),
            wrap_i32((a.sum(0) @ b).long()))


def checksum_diff_int(acc: torch.Tensor, exp_row: torch.Tensor,
                      exp_col: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed per-row / per-column error sums, exact mod 2^32."""
    a = acc.long()
    return (wrap_i32(a.sum(1) - exp_row.long()),
            wrap_i32(a.sum(0) - exp_col.long()))


def detect_int(acc: torch.Tensor, aq: torch.Tensor, bq: torch.Tensor,
               cfg: AbftConfig) -> AbftReport:
    """Detect large errors in an int32 accumulator C = (A @ B)."""
    row_diff, col_diff = checksum_diff_int(acc,
                                           *expected_checksums_int(aq, bq))
    return _report(row_diff, col_diff, _exceeds(row_diff, cfg.threshold),
                   _exceeds(col_diff, cfg.threshold))


def report_from_diffs(row_diff: torch.Tensor, col_diff: torch.Tensor,
                      cfg: AbftConfig) -> AbftReport:
    """An ``AbftReport`` from full-row and full-column differences."""
    return _report(row_diff, col_diff, _exceeds(row_diff, cfg.threshold),
                   _exceeds(col_diff, cfg.threshold))


def detect_f32(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               cfg: AbftConfig, rel_floor: float = 1e-3) -> AbftReport:
    """Float-path detection with a rounding-noise floor: the threshold is
    ``max(2**threshold_bit, rel_floor * mean|C| * N)``."""
    row_diff = c.sum(1) - a @ b.sum(1)
    col_diff = c.sum(0) - a.sum(0) @ b
    thr = torch.clamp_min(rel_floor * c.abs().mean() * c.shape[1],
                          float(cfg.threshold))
    return _report(row_diff, col_diff, row_diff.abs() >= thr,
                   col_diff.abs() >= thr)


def correction_mask(report: AbftReport) -> torch.Tensor:
    """Flagged rows x flagged columns (Fig 10a): the full-matrix cross
    mask, a superset of the true error sites."""
    return report.row_flag[:, None] & report.col_flag[None, :]


def tile_flags(row_diff_t: torch.Tensor, col_diff_t: torch.Tensor,
               cfg: AbftConfig) -> torch.Tensor:
    """``tile_error_mask``'s per-tile flag (Mt, Nt) from the kernel's
    per-tile differences: a tile is flagged when its union (or cross)
    mask has any element, i.e. when any of its rows or (and) any of its
    columns is flagged."""
    tm, tn = cfg.tile_m, cfg.tile_n
    mp, nt = row_diff_t.shape
    mt, np_ = col_diff_t.shape
    rows = _exceeds(row_diff_t, cfg.threshold).reshape(mt, tm, nt).any(1)
    cols = _exceeds(col_diff_t, cfg.threshold).reshape(mt, nt, tn).any(2)
    return (rows & cols) if cfg.mask_policy == "cross" else (rows | cols)
