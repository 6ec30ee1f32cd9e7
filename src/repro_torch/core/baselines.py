"""Prior-work error-mitigation baselines the paper compares against (Fig 12).

Counterpart of ``repro.core.baselines``. Each strategy takes the ABFT
detection report (or its own detection semantics) and returns
``(corrected_output, RecoveryCost)``; ``ExecContext`` sums the costs into
its ``extra_compute_flops`` / ``extra_dram_bytes`` statistics.

  ThUnderVolt -- faulty MAC results dropped: every flagged-row x
                 flagged-column element zeroed.
  ApproxABFT  -- ABFT detection, anomalies zeroed: whole flagged rows and
                 columns.
  DMR         -- everything computed twice; the output is the clean
                 result, and a detected mismatch costs a third pass.
  StatABFT    -- flagged tiles recomputed (clean values spliced in), at
                 the cost of recomputing them.
  DRIFT       -- rollback to the checkpoint; cost = sparse DRAM reads.

The reference computes these in ``jnp`` outside any Pallas kernel, and
the port in plain PyTorch: no kernel of its own. Costs are float32, with
the reference's order of operations, so they compare with ``==``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import abft as abft_lib
from repro_torch.core import rollback


class RecoveryCost(NamedTuple):
    """Per-GEMM recovery accounting (relative units the perfmodel reads)."""

    extra_compute_flops: object   # 0-d f32 (or 0.0): recompute/redundancy
    extra_dram_bytes: object      # 0-d f32 (or 0.0): checkpoint reads etc.
    corrected_elems: torch.Tensor  # 0-d int64: outputs touched


def _f32(x: float, device) -> torch.Tensor:
    """``x`` rounded to f32 as ``jnp.float32(x)``, filled on ``device``
    (no host-to-device copy)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def _zero_cost(corrected: torch.Tensor) -> RecoveryCost:
    return RecoveryCost(0.0, 0.0, corrected)


def thundervolt(y: torch.Tensor, report: abft_lib.AbftReport
                ) -> Tuple[torch.Tensor, RecoveryCost]:
    """Zero every flagged-row x flagged-column element."""
    mask = abft_lib.correction_mask(report)
    return torch.where(mask, 0.0, y), _zero_cost(mask.sum())


def approx_abft(y: torch.Tensor, report: abft_lib.AbftReport
                ) -> Tuple[torch.Tensor, RecoveryCost]:
    """Zero detected anomalies: whole flagged rows and columns."""
    mask = report.row_flag[:, None] | report.col_flag[None, :]
    return torch.where(mask, 0.0, y), _zero_cost(mask.sum())


def dmr(y_clean: torch.Tensor, n_detected: torch.Tensor, gemm_flops: float
        ) -> Tuple[torch.Tensor, RecoveryCost]:
    """DMR: the output is the clean result by definition. The duplicate
    pass always runs (+1x FLOPs); a detected mismatch triggers a third
    (arbitration) pass over the whole GEMM."""
    dev = y_clean.device
    recompute = (torch.as_tensor(n_detected, device=dev) > 0).float()
    cost = RecoveryCost(_f32(gemm_flops, dev) * (1.0 + recompute), 0.0,
                        torch.zeros((), dtype=torch.int64, device=dev))
    return y_clean, cost


def stat_abft(y_clean: torch.Tensor, y_faulty: torch.Tensor,
              tile_flag: torch.Tensor, tile_elems: int, k_dim: int
              ) -> Tuple[torch.Tensor, RecoveryCost]:
    """Recompute flagged tiles (REALM): clean values spliced in, at the
    cost of the flagged tiles' products. As in the reference, the tile
    flags are stretched over ``ceil(m / mt)`` x ``ceil(n / nt)`` elements,
    which is the checksum tile only when the GEMM is a whole number of
    tiles (ROADMAP Queue C 12)."""
    mt, nt = tile_flag.shape
    m, n = y_faulty.shape
    tm, tn = -(-m // mt), -(-n // nt)
    elem = tile_flag.repeat_interleave(tm, 0).repeat_interleave(tn, 1)
    elem = elem[:m, :n]
    n_tiles = tile_flag.float().sum()
    cost = RecoveryCost(n_tiles * tile_elems * 2.0 * k_dim, 0.0, elem.sum())
    return torch.where(elem, y_clean, y_faulty), cost


def drift_rollback(y: torch.Tensor, report: abft_lib.AbftReport,
                   checkpoint: Optional[torch.Tensor], have_ckpt: bool,
                   bytes_per_elem: int = 4
                   ) -> Tuple[torch.Tensor, RecoveryCost]:
    """DRIFT over the full-matrix cross mask: masked elements take the
    checkpoint (zeros without one); cost = sparse DRAM reads. ``ExecContext``
    runs the tile-granular form through the rollback kernel instead."""
    mask = abft_lib.correction_mask(report)
    ckpt = rollback.effective_checkpoint(y, checkpoint, have_ckpt)
    n = mask.sum()
    return torch.where(mask, ckpt, y), RecoveryCost(
        0.0, n.float() * bytes_per_elem, n)
