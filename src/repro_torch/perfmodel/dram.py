"""DRAM row-activation accounting: the Fig 10(b)/13(b) repacking study.

Counterpart of ``repro.perfmodel.dram``, copied.

HBM reads operate at row-buffer granularity; recovering a (tm x tn) tile
under a conventional row-major activation layout touches one DRAM row per
matrix row in the tile (tm activations), while the repacked tile-contiguous
layout packs the whole tile into ceil(tile_bytes / row_bytes) rows.
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.perfmodel.hw import PAPER_ACCEL, PaperAccel


def rows_per_tile_rowmajor(tm: int, tn: int, n_cols: int,
                           elem_bytes: int = 4,
                           row_bytes: int = PAPER_ACCEL.dram_row_bytes) -> int:
    """Distinct DRAM rows touched recovering one tile, row-major layout."""
    matrix_row_bytes = n_cols * elem_bytes
    if matrix_row_bytes >= row_bytes:
        # each matrix row of the tile lives in its own DRAM row (or more)
        return tm * max(1, math.ceil(tn * elem_bytes / row_bytes))
    rows_per_dram_row = row_bytes // matrix_row_bytes
    return max(1, math.ceil(tm / rows_per_dram_row))


def rows_per_tile_repacked(tm: int, tn: int, elem_bytes: int = 4,
                           row_bytes: int = PAPER_ACCEL.dram_row_bytes) -> int:
    return max(1, math.ceil(tm * tn * elem_bytes / row_bytes))


def repack_speedup(tm: int, tn: int, n_cols: int, elem_bytes: int = 4,
                   row_bytes: int = PAPER_ACCEL.dram_row_bytes) -> float:
    """Row-activation reduction factor (Fig 13b; 23.4x-class for q_proj)."""
    return (rows_per_tile_rowmajor(tm, tn, n_cols, elem_bytes, row_bytes)
            / rows_per_tile_repacked(tm, tn, elem_bytes, row_bytes))


def recovery_report(n_flagged_tiles: float, tm: int, tn: int, n_cols: int,
                    hw: PaperAccel = PAPER_ACCEL) -> Dict[str, float]:
    """Latency/energy of one step's recovery reads, both layouts.

    Used to reproduce Sec 6.4's '"computation ~15us, retrieval 714ns ->
    fully overlapped"' claim shape: retrieval time = rows x tRC + bytes/BW.
    """
    t_rc_ns = 45.0
    rows_rm = n_flagged_tiles * rows_per_tile_rowmajor(tm, tn, n_cols)
    rows_rp = n_flagged_tiles * rows_per_tile_repacked(tm, tn)
    bytes_needed = n_flagged_tiles * tm * tn * 4
    bw = hw.hbm_gbps * 1e9
    return {
        "rows_rowmajor": rows_rm,
        "rows_repacked": rows_rp,
        "reduction": rows_rm / max(rows_rp, 1.0),
        "t_retrieval_rowmajor_us": (rows_rm * t_rc_ns) * 1e-3
            + bytes_needed / bw * 1e6,
        "t_retrieval_repacked_us": (rows_rp * t_rc_ns) * 1e-3
            + bytes_needed / bw * 1e6,
    }
