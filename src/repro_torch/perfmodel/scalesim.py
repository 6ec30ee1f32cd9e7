"""SCALE-Sim-style analytical cycle model for tiled GEMM on systolic arrays.

Counterpart of ``repro.perfmodel.scalesim``, copied. A re-implementation
of the output-stationary first-order model the paper uses (SCALE-Sim
[60]): an (a x a) array computes one (a x a) output tile per
(K + 2a - 2) cycles (pipeline fill + drain); tiles distribute over the 64
arrays; SRAM/DRAM traffic from the tiling loop order with weight reuse
across the M dimension.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.perfmodel.hw import PaperAccel


@dataclasses.dataclass(frozen=True)
class GemmStats:
    cycles: int
    macs: int
    utilization: float
    dram_read_bytes: int
    dram_write_bytes: int


def gemm(m: int, k: int, n: int, hw: PaperAccel,
         a_bytes: int = 1, b_bytes: int = 1, c_bytes: int = 4) -> GemmStats:
    """Cycle/traffic model for C[m,n] = A[m,k] @ B[k,n]."""
    a = hw.array_dim
    mt, nt = math.ceil(m / a), math.ceil(n / a)
    tile_cycles = k + 2 * a - 2
    waves = math.ceil(mt * nt / hw.n_arrays)
    cycles = waves * tile_cycles
    macs = m * k * n
    peak = hw.n_arrays * a * a * cycles
    util = macs / max(peak, 1)
    # weights stream once per column block; activations reread per col block
    # unless they fit SRAM (simple capacity check)
    a_total = m * k * a_bytes
    fits = a_total <= hw.sram_bytes // 2
    dram_read = k * n * b_bytes + (a_total if fits else a_total * nt)
    dram_write = m * n * c_bytes
    return GemmStats(cycles, macs, util, int(dram_read), int(dram_write))


def gemm_seconds(m: int, k: int, n: int, hw: PaperAccel,
                 freq_ghz: float | None = None) -> float:
    f = (freq_ghz or hw.freq_ghz) * 1e9
    return gemm(m, k, n, hw).cycles / f


def abft_overhead_ratio(m: int, k: int, n: int, hw: PaperAccel) -> float:
    """Extra MACs for the checksum lanes: one extra row + column per tile.

    Classic ABFT on an (a x a) tile adds (2a+1)/a^2 of the tile's MACs --
    6.35% at a=32, matching the paper's measured ~6.3% ABFT-wrapper power
    (comparator/monitor logic is noise at synthesis, Sec 6.2).
    """
    a = hw.array_dim
    return (2 * a + 1) / (a * a)
