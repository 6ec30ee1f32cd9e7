"""Hardware constants: the paper's accelerator and the H100 roofline.

Counterpart of ``repro.perfmodel.hw``. Paper accelerator (Sec 6.1): 64
systolic arrays (default 32x32, int8 multipliers + int32 accumulators),
nominal 0.9 V / 2 GHz, HBM2 off-chip, synthesized on a commercial 14nm
PDK. Peak int8 throughput: 64 arrays x 32x32 MACs x 2 GHz x 2 ops = 262
Tops.

NVIDIA H100 SXM (the port's dry-run and roofline target, in place of
the reference's TPU v5e): the published dense peaks of the 700 W part
from NVIDIA's data sheet, 989 TFLOP/s bf16 and 1979 TOP/s int8 on the
tensor cores, 67 TFLOP/s f32 outside them, 3.35 TB/s of HBM3 over 80 GB,
and NVLink 4's 900 GB/s per GPU, both directions together, so 450 GB/s
one way.
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


@dataclasses.dataclass(frozen=True)
class H100:
    peak_flops_bf16: float = 989e12     # dense, tensor cores
    peak_ops_int8: float = 1979e12      # dense, tensor cores
    peak_flops_f32: float = 67e12       # outside the tensor cores
    hbm_bytes_per_s: float = 3.35e12
    hbm_bytes: float = 80e9
    # NVLink 4: 900 GB/s per GPU counting both directions (data sheet),
    # so 450 GB/s each way
    link_bytes_per_s: float = 450e9


PAPER_ACCEL = PaperAccel()
H100_SXM = H100()
