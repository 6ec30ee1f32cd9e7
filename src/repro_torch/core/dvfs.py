"""DVFS operating points, the BER(V, f) surface, fine-grained schedules and
the runtime BER monitor.

Counterpart of ``repro.core.dvfs``; the fit is a copy of the reference's
pure-numpy code. The per-(step, class) BER table stays a host numpy array,
so a denoising step knows without a device sync whether a class runs at
BER 0 and needs no flip mask. The monitor's EMA and ladder index live on
the device, so updating them never waits for the card either.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

V_NOMINAL = 0.90
F_NOMINAL_GHZ = 2.0
V_TH = 0.30          # threshold voltage, alpha-power law
ALPHA = 1.30         # velocity-saturation exponent (14nm-class)
NOMINAL_SLACK = 0.10  # nominal point closes timing with 10% slack


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    voltage: float      # V
    freq_ghz: float     # GHz
    name: str = ""

    @property
    def energy_factor(self) -> float:
        return (self.voltage / V_NOMINAL) ** 2

    @property
    def speed_factor(self) -> float:
        return self.freq_ghz / F_NOMINAL_GHZ


NOMINAL = OperatingPoint(0.90, 2.0, "nominal")
UNDERVOLT = OperatingPoint(0.68, 2.0, "undervolt")   # energy mode
OVERCLOCK = OperatingPoint(0.88, 3.5, "overclock")   # speed mode

# The ladder the BER monitor walks: index 0 is the most aggressive point.
OP_LADDER: Tuple[OperatingPoint, ...] = (
    UNDERVOLT,
    OperatingPoint(0.73, 2.0, "uv-mild"),
    OperatingPoint(0.78, 2.0, "uv-safe"),
    OperatingPoint(0.84, 2.0, "near-nominal"),
    NOMINAL,
)

OP_BY_NAME = {p.name: p for p in (NOMINAL, UNDERVOLT, OVERCLOCK) + OP_LADDER}


def ladder_op(index: int) -> OperatingPoint:
    return OP_LADDER[max(0, min(int(index), len(OP_LADDER) - 1))]


def _delay_ns(v: float) -> float:
    """Critical-path delay, alpha-power law, calibrated at the nominal point."""
    t_nom = 1.0 / F_NOMINAL_GHZ
    c = (1.0 - NOMINAL_SLACK) * t_nom * (V_NOMINAL - V_TH) ** ALPHA / V_NOMINAL
    return c * v / (v - V_TH) ** ALPHA


def slack_ratio(op: OperatingPoint) -> float:
    t = 1.0 / op.freq_ghz
    return (t - _delay_ns(op.voltage)) / t


def _fit_ber_coeffs() -> np.ndarray:
    """Exact quadratic fit of log10(BER) in slack ratio through the anchors."""
    anchors = [(NOMINAL, -12.0), (UNDERVOLT, np.log10(3e-3)),
               (OVERCLOCK, np.log10(3e-3))]
    s = np.array([slack_ratio(op) for op, _ in anchors])
    y = np.array([v for _, v in anchors])
    feats = np.stack([np.ones_like(s), s, s * s], axis=1)
    return np.linalg.solve(feats, y)


_BER_COEFFS = _fit_ber_coeffs()


def ber_of(op: OperatingPoint) -> float:
    s = slack_ratio(op)
    log10b = float(_BER_COEFFS[0] + _BER_COEFFS[1] * s + _BER_COEFFS[2] * s * s)
    return float(np.clip(10.0 ** log10b, 1e-15, 0.5))


# Block resilience classes.
CLASS_EMBED = 0        # conditioning / timestep / patch embeddings
CLASS_FIRST_BLOCK = 1  # first transformer block
CLASS_BODY = 2         # middle + deep blocks
N_CLASSES = 3


@dataclasses.dataclass(frozen=True)
class DvfsSchedule:
    """Per-(timestep, block-class) BER table, host numpy f32 (T, N_CLASSES);
    0.0 entries are the nominal (error-free) point."""

    ber_table: np.ndarray
    aggressive: OperatingPoint
    nominal_steps: int


def fine_grained_schedule(num_steps: int,
                          aggressive: OperatingPoint = UNDERVOLT,
                          nominal_steps: int = 2,
                          protect_embed: bool = True,
                          protect_first_block: bool = True) -> DvfsSchedule:
    """Paper default: nominal for (embeddings, first 2 steps), aggressive else."""
    table = np.full((num_steps, N_CLASSES), ber_of(aggressive),
                    dtype=np.float32)
    table[:nominal_steps, :] = 0.0
    if protect_embed:
        table[:, CLASS_EMBED] = 0.0
    if protect_first_block:
        table[:, CLASS_FIRST_BLOCK] = 0.0
    return DvfsSchedule(table, aggressive, nominal_steps)


class BerMonitorState(NamedTuple):
    ema_ber: torch.Tensor   # 0-d f32 on the device
    op_index: torch.Tensor  # 0-d int32 on the device
    n_updates: int


def ber_monitor_init(device, initial_ber: float = 0.0) -> BerMonitorState:
    return BerMonitorState(
        torch.tensor(initial_ber, dtype=torch.float32, device=device),
        torch.tensor(0, dtype=torch.int32, device=device), 0)


def ber_monitor_update(state: BerMonitorState, detected_errors: torch.Tensor,
                       n_words: int, threshold_bit: int, target_ber: float,
                       n_ladder: int = 5,
                       decay: float = 0.9) -> BerMonitorState:
    """Fold one step's detected large-error count into the BER estimate and
    walk the ladder: +1 when the EMA runs hot (> 2x target), -1 when cold
    (< target / 2)."""
    visible_bits = max(32 - threshold_bit, 1)
    # a product with the reciprocal, as XLA and PyTorch's CUDA division by
    # a scalar compute it: the card and the CPU agree bit for bit
    est = detected_errors.float() * (1.0 / (n_words * visible_bits))
    if state.n_updates == 0:
        ema = est
    else:
        ema = decay * state.ema_ber + (1.0 - decay) * est
    hot = (ema > 2.0 * target_ber).to(torch.int32)
    cold = (ema < 0.5 * target_ber).to(torch.int32)
    op_index = torch.clamp(state.op_index + hot - cold, 0, n_ladder - 1)
    return BerMonitorState(ema, op_index.to(torch.int32),
                           state.n_updates + 1)
