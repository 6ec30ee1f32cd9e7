"""The kernel-backed DRIFT GEMM pipeline as one function.

Counterpart of ``repro.kernels.ops.drift_gemm``: quantize -> fused faulty
ABFT GEMM (``kernels.abft_matmul``) -> dequantize -> rollback correction
(``kernels.rollback_correct``). A composite over the port's two kernels,
with no kernel of its own. It is not on the serving path (``ExecContext``
composes the two kernels itself); it is the unit sweeps and tests call.

The reference draws its flips inside, over the padded grid, from a key and
a BER (2-way split, ``ops.py:64-68``); the port takes that mask as an
argument, ``flips (Mp, Np)`` int32 over the padded grid, so a test can hand
in the reference's mask. The checksum tile is the kernels' 32: other tiles
raise. ``n_flagged_tiles`` counts the tiles with any masked element over
the whole padded grid, as the reference does (a flip that lands in the
padding can flag a tile).

``drift_gemm_plain`` is the same composite over the kernels' plain
versions. ``drift_gemm`` keeps no count of its own: each call launches
both kernels once, and their wrappers count those launches.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.abft import wrap_i32
from repro_torch.kernels import abft_matmul as _abft
from repro_torch.kernels import rollback_correct as _rc

TILE = 32


class DriftGemmOut(NamedTuple):
    y: torch.Tensor                # (M, N) f32 corrected output
    n_flagged_tiles: torch.Tensor  # 0-d int64
    row_diff: torch.Tensor         # (Mp, Np/32) int32 (padded grid)
    col_diff: torch.Tensor         # (Mp/32, Np) int32


def _pad2(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))


def padded_shape(m: int, n: int) -> tuple:
    """The (Mp, Np) grid ``flips`` must cover."""
    return -(-m // TILE) * TILE, -(-n // TILE) * TILE


def work(m: int, k: int, n: int) -> Dict[str, int]:
    """The composite's work, its bound on the card: the ABFT product and
    checksums in int8 operations; x, w (f32) and flips read, y written,
    the checkpoint read, the row and column differences written."""
    nt, mt = n // TILE, m // TILE
    return {"flops": 0,
            "int8_ops": 2 * m * n * k + 2 * m * k * nt + 2 * mt * k * n,
            "bytes": (4 * m * k + 4 * k * n + 12 * m * n + 4 * m * nt
                      + 4 * mt * n)}


def _drift_gemm(mm, rb, x, w, ckpt, flips, threshold_bit, bm, bn, bk,
                union) -> DriftGemmOut:
    if (bm, bn, bk) != (TILE, TILE, TILE):
        raise ValueError(f"drift_gemm's checksum tile is {TILE}, got "
                         f"(bm, bn, bk) = ({bm}, {bn}, {bk})")
    m, n = x.shape[0], w.shape[1]
    mp, np_ = padded_shape(m, n)
    if tuple(flips.shape) != (mp, np_) or flips.dtype != torch.int32:
        raise ValueError(f"flips must be int32 over the padded grid "
                         f"{(mp, np_)}, got {flips.dtype} "
                         f"{tuple(flips.shape)}")
    xq = quant.quantize(x, axis=None)
    wq = quant.quantize(w, axis=1)
    # The ABFT kernel zero-fills a ragged K slab, so K needs no padding.
    c, act_row, exp_row, act_col, exp_col = mm(
        _pad2(xq.q, mp, x.shape[1]), _pad2(wq.q, w.shape[0], np_), flips)
    row_diff = wrap_i32(act_row.long() - exp_row.long())
    col_diff = wrap_i32(act_col.long() - exp_col.long())
    y = quant.dequantize_matmul(c[:m, :n], xq.scale, wq.scale.reshape(1, -1))
    ckpt_p = (_pad2(ckpt, mp, np_) if ckpt is not None
              else torch.zeros((mp, np_), dtype=torch.float32,
                               device=x.device))
    corrected, tile_count = rb(_pad2(y, mp, np_), ckpt_p, row_diff, col_diff,
                               1 << threshold_bit, union=union)
    return DriftGemmOut(corrected[:m, :n], (tile_count > 0).sum(),
                        row_diff, col_diff)


def drift_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                     ckpt: Optional[torch.Tensor], flips: torch.Tensor,
                     threshold_bit: int = 10, bm: int = TILE, bn: int = TILE,
                     bk: int = TILE, union: bool = True) -> DriftGemmOut:
    """``drift_gemm`` over the kernels' plain versions."""
    return _drift_gemm(_abft.abft_matmul_plain, _rc.rollback_correct_plain,
                       x, w, ckpt, flips, threshold_bit, bm, bn, bk, union)


def drift_gemm(x: torch.Tensor, w: torch.Tensor,
               ckpt: Optional[torch.Tensor], flips: torch.Tensor,
               threshold_bit: int = 10, bm: int = TILE, bn: int = TILE,
               bk: int = TILE, union: bool = True) -> DriftGemmOut:
    """Kernel-backed DRIFT-protected GEMM: ``x (M, K) f32 @ w (K, N) f32``
    with ``flips (Mp, Np)`` int32 xored into the int32 accumulators."""
    return _drift_gemm(_abft.abft_matmul, _rc.rollback_correct, x, w, ckpt,
                       flips, threshold_bit, bm, bn, bk, union)
