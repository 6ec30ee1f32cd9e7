"""ExecContext: the execution layer every protected projection goes through.

Counterpart of ``repro.core.exec_ctx``. Models call
``ctx.matmul(x, w, name=..., rclass=...)``; the context picks, per call,
the float or the quantized INT8->INT32 path, the BER of the GEMM's
resilience class at this step, the flip mask, and the detection and
correction strategy: ``float_clean``, ``clean``, ``faulty``, ``drift``
and the Fig 12 baselines ``thundervolt``, ``approx_abft``, ``dmr`` and
``stat_abft`` (``core.baselines``).

``drift`` runs each quantized GEMM through one hand-written kernel,
``kernels.ops.drift_gemm_fused``, from the unpadded int8 operands to the
corrected f32 output: the faulty ABFT product, the checksum differences,
the dequantisation and the rollback splice, with the per-tile masked
counts the statistics read. Every other quantized mode runs the ABFT
kernel (``kernels.abft_matmul``), because it needs the int32 product
itself. Both take their plain versions on the CPU. The baselines need no
second pass: the full-row and full-column checksum
differences of ``detect_int`` are sums of the kernel's per-tile ones
(mod 2^32), the per-tile flag of ``tile_error_mask`` is the
any of its rows and columns (``abft.tile_flags``), and the clean
accumulator is ``c ^ flips``, bit for bit, so ``dmr`` and ``stat_abft``
dequantize the reference's clean product without a second GEMM (DMR's
doubled compute is a modeled cost, not a launch). Their masks are
full-matrix or whole-tile, in plain PyTorch as in the reference.
Flip masks come from the context's *flip source* (``core.fault``), keyed
by ``FaultSite(step, scope, name)``; a GEMM whose class runs at BER 0 gets
an all-zero mask without drawing.

Unlike the reference, the context is not rebuilt inside a trace: PyTorch
runs eagerly. ``state_in`` maps GEMM names to (rows, N) f32 checkpoints,
and ``drift`` refreshes them *in place* on refresh steps (the reference
returns a new store; writing into the existing buffer saves one
activation-sized copy per GEMM); the other modes write none. Statistics
stay on the device, so the step loop never waits for the card; the
recovery costs ``extra_compute_flops`` and ``extra_dram_bytes`` are
float32 sums in the reference's order.

Under the sharded engine's policy, when a batch's rows are spread over
the data group (``distributed.constraints``), a GEMM whose rows are whole
32-row tiles runs on this rank's rows with the whole batch's activation
scale (the data group's max |x|) and its rows of the whole batch's flip
mask, so each of its tiles is the single-device engine's. Any other GEMM
(the timestep GEMMs at M = batch, text GEMMs at M = batch x tokens, and
every GEMM of the two baselines that correct by whole-matrix column
sums) runs on the data group's gathered rows, each rank keeping its
own; its counts are the whole batch's, so the group's first rank alone
keeps them, and its checkpoint buffers hold the whole batch's rows
(``constraints.store_rows``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import abft as abft_lib
from repro_torch.core import baselines, fault, quant, rollback
from repro_torch.core.dvfs import CLASS_BODY, N_CLASSES
from repro_torch.distributed import constraints
from repro_torch.kernels.abft_matmul import TILE, abft_matmul
from repro_torch.kernels.ops import drift_gemm_fused

MODES = ("float_clean", "clean", "faulty", "drift",
         "thundervolt", "approx_abft", "dmr", "stat_abft")
# Baselines whose correction reads whole-matrix column sums: on a sharded
# batch they run on the data group's gathered rows.
WHOLE_COLUMN_MODES = ("thundervolt", "approx_abft")


@dataclasses.dataclass(frozen=True)
class DriftSystemConfig:
    mode: str = "float_clean"
    abft: abft_lib.AbftConfig = dataclasses.field(
        default_factory=abft_lib.AbftConfig)
    rollback: rollback.RollbackConfig = dataclasses.field(
        default_factory=rollback.RollbackConfig)
    protect_attention_gemms: bool = False   # also wrap bmm's slices
    double_flip: bool = False
    force_bit: int = -1                     # pin flipped bit (Sec 4.1)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown DRIFT mode {self.mode!r}; one of "
                             f"{MODES}")
        if (self.abft.tile_m, self.abft.tile_n) != (TILE, TILE):
            raise ValueError(
                f"the ABFT kernel's checksum tile is {TILE}x{TILE}, got "
                f"({self.abft.tile_m}, {self.abft.tile_n})")
        if not -1 <= self.force_bit <= 31:
            raise ValueError(f"force_bit must be -1 (off) or a bit 0..31, "
                             f"got {self.force_bit}")


def _pad2(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad a 2-D tensor at the end of each dim to (rows, cols)."""
    pr, pc = rows - x.shape[0], cols - x.shape[1]
    if pr == 0 and pc == 0:
        return x
    return F.pad(x, (0, pc, 0, pr))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class ExecContext:
    """Per-step (or per-layer) execution context."""

    def __init__(self, cfg: DriftSystemConfig,
                 flip_source: Optional[fault.FlipSource] = None,
                 step: int = 0, scope: int = 0,
                 ber_by_class: Optional[np.ndarray] = None,
                 state_in: Optional[rollback.CkptStore] = None,
                 have_ckpt: bool = False):
        self.cfg = cfg
        self.flip_source = flip_source
        self.step = int(step)
        self.scope = int(scope)
        # (N_CLASSES,) host BERs for this step; zeros = nominal point.
        self.ber_by_class = (np.zeros((N_CLASSES,), np.float32)
                             if ber_by_class is None
                             else np.asarray(ber_by_class, np.float32))
        self.state_in: rollback.CkptStore = (state_in if state_in is not None
                                             else {})
        self.have_ckpt = bool(have_ckpt)
        self.stats: Dict[str, object] = {
            "detected_row_errors": 0, "corrected_elems": 0,
            "extra_compute_flops": 0.0, "extra_dram_bytes": 0.0,
            "gemm_words": 0}

    # ------------------------------------------------------------------
    def _flips(self, name: str, shape, ber: float,
               device) -> Optional[torch.Tensor]:
        """The GEMM's flip mask, or None (nothing drawn) at BER 0."""
        if not ber > 0.0:
            return None
        if self.flip_source is None:
            raise ValueError(f"GEMM {name!r} runs at BER {ber} but the "
                             "context has no flip source")
        site = fault.FaultSite(self.step, self.scope, name)
        opts = {}
        if self.cfg.double_flip:
            opts["double_flip"] = True
        if self.cfg.force_bit >= 0:
            opts["force_bit"] = self.cfg.force_bit
        flips = self.flip_source(site, tuple(shape), ber, **opts)
        if flips.dtype != torch.int32 or tuple(flips.shape) != tuple(shape):
            raise ValueError(f"flip source gave {flips.dtype} "
                             f"{tuple(flips.shape)} for {tuple(shape)}")
        return flips.to(device)

    def matmul(self, x: torch.Tensor, w: torch.Tensor, *, name: str,
               rclass: int = CLASS_BODY) -> torch.Tensor:
        """Protected projection: x (..., K) @ w (K, N) -> (..., N)."""
        if self.cfg.mode == "float_clean":
            return x @ w

        lead = x.shape[:-1]
        n = w.shape[-1]
        x2 = x.reshape(-1, x.shape[-1])
        if constraints.batch_sharded() and (
                x2.shape[0] % TILE or self.cfg.mode in WHOLE_COLUMN_MODES):
            y = constraints.own_rows(self._matmul2d(
                constraints.gather_rows(x2), w, name, rclass,
                local=False, count=constraints.is_data_leader()))
        else:
            y = self._matmul2d(x2, w, name, rclass, local=True, count=True)
        return y.reshape(*lead, n).to(x.dtype)

    def _matmul2d(self, x2: torch.Tensor, w: torch.Tensor, name: str,
                  rclass: int, local: bool, count: bool) -> torch.Tensor:
        """``matmul`` on 2-D rows. ``local``: the rows are this rank's
        share of the batch (the activation scale and the flip mask are the
        whole batch's); ``count``: the statistics are bumped."""
        k, n = x2.shape[-1], w.shape[-1]
        m = x2.shape[0]
        mp, np_ = _round_up(m, TILE), _round_up(n, TILE)

        amax = None
        rows, lo = m, 0
        if local and constraints.batch_sharded():
            amax = constraints.data_amax(x2.abs().amax())
            rows, lo = constraints.global_rows(m)
        xq = quant.quantize(x2, axis=None, amax=amax)
        wq = quant.quantize(w, axis=1)
        ber = (float(self.ber_by_class[int(rclass)])
               if self.cfg.mode != "clean" else 0.0)
        flips = self._flips(name, (rows, n), ber, x2.device)
        if flips is not None and rows != m:
            flips = flips[lo:lo + m]
        if self.cfg.mode == "drift":
            return self._drift(name, xq, wq, flips, count)
        flips = (torch.zeros((mp, np_), dtype=torch.int32, device=x2.device)
                 if flips is None else _pad2(flips, mp, np_))
        # The kernel zero-fills a ragged last K slab, so K needs no padding.
        c, act_row, exp_row, act_col, exp_col = abft_matmul(
            _pad2(xq.q, mp, k), _pad2(wq.q, k, np_), flips)
        w_scale = wq.scale.reshape(1, -1)
        y = quant.dequantize_matmul(c[:m, :n], xq.scale, w_scale)
        if self.cfg.mode in ("clean", "faulty"):
            return y

        # ABFT detection on the kernel's per-tile checksums: summed over
        # the N tiles, the per-tile row differences are the full-row
        # differences of detect_int, exactly (mod 2^32).
        abft_cfg = self.cfg.abft
        row_diff = abft_lib.wrap_i32(act_row.long() - exp_row.long())
        col_diff = abft_lib.wrap_i32(act_col.long() - exp_col.long())
        full_row = abft_lib.wrap_i32(row_diff.long().sum(1))[:m]
        if count:
            self._bump("detected_row_errors",
                       abft_lib._exceeds(full_row, abft_cfg.threshold).sum())
            self._bump("gemm_words", m * n)

        mode = self.cfg.mode
        if mode in ("thundervolt", "approx_abft"):
            # detect_int's report: the column differences summed over the
            # M tiles as the rows' over the N tiles.
            report = abft_lib.report_from_diffs(
                full_row, abft_lib.wrap_i32(col_diff.long().sum(0))[:n],
                abft_cfg)
            strategy = (baselines.thundervolt if mode == "thundervolt"
                        else baselines.approx_abft)
            y, cost = strategy(y, report)
        else:
            # c ^ flips is the clean accumulator, bit for bit.
            y_clean = quant.dequantize_matmul((c ^ flips)[:m, :n],
                                              xq.scale, w_scale)
            if mode == "dmr":
                y, cost = baselines.dmr(
                    y_clean, abft_lib._exceeds(full_row,
                                               abft_cfg.threshold).sum(),
                    gemm_flops=2.0 * m * k * n)
            else:  # stat_abft
                y, cost = baselines.stat_abft(
                    y_clean, y, abft_lib.tile_flags(row_diff, col_diff,
                                                    abft_cfg),
                    tile_elems=abft_cfg.tile_m * abft_cfg.tile_n, k_dim=k)
        if count:
            self._bump_cost(cost)
        return y

    def _drift(self, name: str, xq: quant.QTensor, wq: quant.QTensor,
               flips: Optional[torch.Tensor], count: bool) -> torch.Tensor:
        """``drift`` in one kernel launch: the unpadded operands, the mask
        as drawn (None at BER 0) and the effective checkpoint (None for
        zeros) in; the corrected output, its checksum differences and the
        masked elements of each tile inside the unpadded region out (a
        tile is flagged exactly where its count is positive)."""
        m, n = xq.q.shape[0], wq.q.shape[1]
        abft_cfg = self.cfg.abft
        ckpt = self.state_in.get(name) if self.have_ckpt else None
        y, row_diff, _, tile_count = drift_gemm_fused(
            xq.q, wq.q, None if flips is None else flips.contiguous(),
            xq.scale, wq.scale.reshape(-1),
            None if ckpt is None else ckpt.contiguous(), abft_cfg.threshold,
            union=abft_cfg.mask_policy != "cross", valid=(m, n))
        if count:
            full_row = abft_lib.wrap_i32(row_diff.long().sum(1))[:m]
            self._bump("detected_row_errors",
                       abft_lib._exceeds(full_row, abft_cfg.threshold).sum())
            self._bump("gemm_words", m * n)
            # DRAM cost: one repacked-tile read per flagged tile.
            tile_bytes = abft_cfg.tile_m * abft_cfg.tile_n * 4
            self._bump_cost(baselines.RecoveryCost(
                0.0, (tile_count > 0).float().sum() * tile_bytes,
                tile_count.sum()))
        self._write_ckpt(name, y)
        return y

    def bmm(self, a: torch.Tensor, b: torch.Tensor, *, name: str,
            rclass: int = CLASS_BODY) -> torch.Tensor:
        """Batched GEMM (attention scores / mixing), ``a (..., M, K) @
        b (..., K, N)``. Protected only with ``protect_attention_gemms``:
        then one protected ``matmul`` per leading slice ``i``, named
        ``f"{name}.{i}"``. No model calls it by default, as in the
        reference."""
        if (self.cfg.mode == "float_clean"
                or not self.cfg.protect_attention_gemms):
            return a @ b
        lead = a.shape[:-2]
        a2 = a.reshape((-1,) + tuple(a.shape[-2:]))
        b2 = b.reshape((-1,) + tuple(b.shape[-2:]))
        y = torch.stack([self.matmul(a2[i], b2[i], name=f"{name}.{i}",
                                     rclass=rclass)
                         for i in range(a2.shape[0])])
        return y.reshape(*lead, *y.shape[-2:])

    # ------------------------------------------------------------------
    def _write_ckpt(self, name: str, y: torch.Tensor) -> None:
        """Refresh the checkpoint on steps 0, n, 2n, ... -- in place when
        the store already holds a buffer for ``name``."""
        if not rollback.should_checkpoint(self.step,
                                          self.cfg.rollback.interval):
            return
        buf = self.state_in.get(name)
        if buf is None:
            self.state_in[name] = y.clone()
        else:
            buf.copy_(y)

    def _bump(self, stat: str, v) -> None:
        self.stats[stat] = self.stats[stat] + v

    def _bump_cost(self, cost: baselines.RecoveryCost) -> None:
        self._bump("corrected_elems", cost.corrected_elems)
        self._bump("extra_compute_flops", cost.extra_compute_flops)
        self._bump("extra_dram_bytes", cost.extra_dram_bytes)
