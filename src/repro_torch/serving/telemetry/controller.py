"""Adaptive BER guardband controller: the DRIFT loop, closed online.

Counterpart of ``repro.serving.telemetry.controller``, the same state
machine and arithmetic. ``corrected_elems`` is the port's true int64
count, which the reference's int32 carry wraps at full width (ROADMAP
Queue C 7), so the rollback rate differs from the reference's there.

The engine already runs the paper's Sec 5.1 feedback *inside* the step
loop: ABFT detection counts drive ``core.dvfs.ber_monitor_update``,
which walks the ``OP_LADDER`` index carried across batches. That loop
reacts per *step* but has no memory beyond one EMA and no notion of
"this operating point keeps running hot" -- exactly the statistical
error-monitoring signal ReaLM argues a reliability controller should
consume.

``GuardbandController`` is the host-side outer loop layered on top:

* it **observes** every monitored batch -- the monitor's post-batch BER
  estimate, the batch's rollback-corrected element count, and which
  operating point actually ran -- and maintains a per-operating-point
  EWMA of *realized* BER plus a global rollback-rate estimate;
* it maintains a **guardband**: a floor on the ladder index that
  ``op="auto"`` resolution is clamped to
  (``engine.auto_op_index`` applies ``controller.clamp``). Index 0 is
  the most aggressive undervolt; a wider guardband means a higher floor,
  i.e. "auto" requests run closer to nominal;
* the **state machine** (one transition per adaptation window of
  ``window_batches`` monitored batches, full table in
  docs/telemetry.md):

  - window BER  > ``spike_ratio * target``  -> WIDEN: floor += 1, quiet
    streak reset;
  - window BER  < ``quiet_ratio * target``  -> QUIET: streak += 1, and
    after ``quiet_windows`` consecutive quiet windows the floor steps
    back down (re-tighten) and the streak restarts;
  - otherwise (in-band)                     -> HOLD: streak reset, floor
    unchanged.

Hysteresis is the point: widening is immediate (one window), tightening
needs ``quiet_windows`` consecutive quiet windows, so the floor cannot
flap batch-to-batch. Since the floor only selects among the fixed
``OP_LADDER`` names, the sampler cache stays bounded by the ladder
length no matter how long the controller runs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core import dvfs as dvfs_lib

# Adaptation-window outcomes (also the controller's observable state).
WIDEN, TIGHTEN, QUIET, HOLD = "widen", "tighten", "quiet", "hold"


@dataclasses.dataclass(frozen=True)
class GuardbandConfig:
    """Knobs for the guardband state machine."""
    # Monitored batches folded into one adaptation window.
    window_batches: int = 1
    # Window-mean BER above spike_ratio * target widens the guardband.
    spike_ratio: float = 2.0
    # Window-mean BER below quiet_ratio * target counts as a quiet window.
    quiet_ratio: float = 0.5
    # Consecutive quiet windows required before the guardband re-tightens.
    quiet_windows: int = 3
    # Highest floor the controller may set (None = ladder top, i.e. it may
    # pin "auto" all the way to nominal under a sustained detection storm).
    max_guard: Optional[int] = None
    # EWMA decay for the per-op realized-BER and rollback-rate estimates.
    decay: float = 0.8

    @property
    def guard_cap(self) -> int:
        top = len(dvfs_lib.OP_LADDER) - 1
        return top if self.max_guard is None else min(self.max_guard, top)


@dataclasses.dataclass
class GuardbandStats:
    windows: int = 0
    widenings: int = 0
    tightenings: int = 0
    quiet_streak: int = 0          # current consecutive quiet windows
    last_action: str = HOLD


class GuardbandController:
    """Online guardband adaptation over BER-monitor observations."""

    def __init__(self, target_ber: float,
                 config: Optional[GuardbandConfig] = None) -> None:
        assert target_ber > 0, target_ber
        self.target_ber = target_ber
        self.cfg = config or GuardbandConfig()
        self.guard_index = 0           # ladder floor; 0 = no guardband
        self.stats = GuardbandStats()
        # realized BER per operating-point name (EWMA of the monitor's
        # post-batch estimate attributed to the op that actually ran)
        self.realized_ber: Dict[str, float] = {}
        # rollback intensity: EWMA of corrected elements per latent word
        self.rollback_rate = 0.0
        self._window_sum = 0.0
        self._window_n = 0
        # Energy-SLO breach input (telemetry's SLOTracker sets it each
        # batch): while the fleet burns its energy budget, "auto" is
        # pinned to the guardband floor itself -- the cheapest operating
        # point the reliability state machine currently allows.
        self.energy_slo_breached = False

    # ----------------------------------------------------------- observe
    def observe_batch(self, ema_ber: float, op_name: str,
                      corrected_elems: int = 0, n_words: int = 1) -> str:
        """Fold one monitored batch in; returns the window action taken
        (``hold`` while a window is still filling)."""
        d = self.cfg.decay
        prev = self.realized_ber.get(op_name)
        self.realized_ber[op_name] = ema_ber if prev is None \
            else d * prev + (1 - d) * ema_ber
        rate = corrected_elems / max(n_words, 1)
        self.rollback_rate = d * self.rollback_rate + (1 - d) * rate
        self._window_sum += ema_ber
        self._window_n += 1
        if self._window_n < self.cfg.window_batches:
            return HOLD
        window_ber = self._window_sum / self._window_n
        self._window_sum, self._window_n = 0.0, 0
        return self._step_window(window_ber)

    def _step_window(self, window_ber: float) -> str:
        """One state-machine transition at an adaptation-window boundary."""
        st = self.stats
        st.windows += 1
        if window_ber > self.cfg.spike_ratio * self.target_ber:
            st.quiet_streak = 0
            if self.guard_index < self.cfg.guard_cap:
                self.guard_index += 1
                st.widenings += 1
                st.last_action = WIDEN
            else:
                st.last_action = HOLD
            return st.last_action
        if window_ber < self.cfg.quiet_ratio * self.target_ber:
            st.quiet_streak += 1
            if st.quiet_streak >= self.cfg.quiet_windows:
                st.quiet_streak = 0
                if self.guard_index > 0:
                    self.guard_index -= 1
                    st.tightenings += 1
                    st.last_action = TIGHTEN
                    return st.last_action
            st.last_action = QUIET
            return st.last_action
        st.quiet_streak = 0            # in-band: hysteresis restarts
        st.last_action = HOLD
        return st.last_action

    def set_energy_slo_breach(self, breached: bool) -> None:
        """Energy-SLO floor input (docs/slo.md): telemetry calls this
        after every batch with the tracker's energy-objective breach
        state; it only affects ``op="auto"`` resolution via clamp()."""
        self.energy_slo_breached = bool(breached)

    # ------------------------------------------------------------- apply
    def clamp(self, op_index: int) -> int:
        """Apply the guardband floor to a monitor ladder index. Under an
        energy-SLO breach the floor becomes the *ceiling* too: "auto"
        resolves to exactly the guardband index -- as aggressive (cheap)
        as the reliability guardband permits, no higher."""
        if self.energy_slo_breached:
            return self.guard_index
        return max(int(op_index), self.guard_index)

    def guard_op_name(self) -> str:
        """Ladder name of the current floor (for gauges / logs)."""
        return dvfs_lib.ladder_op(self.guard_index).name
