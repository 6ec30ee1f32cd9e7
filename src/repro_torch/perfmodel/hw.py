"""Hardware constants of the paper's accelerator.

Counterpart of ``repro.perfmodel.hw``. Paper accelerator (Sec 6.1): 64
systolic arrays (default 32x32, int8 multipliers + int32 accumulators),
nominal 0.9 V / 2 GHz, HBM2 off-chip, synthesized on a commercial 14nm
PDK. Peak int8 throughput: 64 arrays x 32x32 MACs x 2 GHz x 2 ops = 262
Tops.

The reference's ``TpuV5e`` roofline constants are left out: only its
dry-run and roofline tools read them, and their port (ROADMAP Queue A
item 14) measures the GPU instead.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperAccel:
    n_arrays: int = 64
    array_dim: int = 32
    freq_ghz: float = 2.0
    voltage: float = 0.9
    sram_bytes: int = 32 * 1024 * 1024
    dram_row_bytes: int = 2048          # HBM2 row buffer per pseudo-channel
    hbm_gbps: float = 450.0             # HBM2
    # energy constants (14nm-class, calibrated so DiT-XL-512 @50 DDIM steps
    # matches Table 1 baseline 6.02 J / 0.56 s -- see energy.calibrate())
    e_mac_pj: float = 0.45              # int8 MAC at nominal V (incl. SRAM)
    e_dram_pj_per_byte: float = 25.0
    static_w: float = 8.0

    @property
    def peak_macs_per_s(self) -> float:
        return (self.n_arrays * self.array_dim ** 2 * self.freq_ghz * 1e9)


PAPER_ACCEL = PaperAccel()
