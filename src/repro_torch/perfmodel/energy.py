"""Energy/latency model for DRIFT runs: Table 1, Figs 11-14 arithmetic.

Counterpart of ``repro.perfmodel.energy``, copied with every expression's
association unchanged (the tests compare the two with ``==``). Every
joule and second it returns is the modeled paper accelerator's, never
the GPU's the port runs on.

Domain decomposition per generated sample (one voltage domain for the
accelerator die -- MACs, SRAM, memory controller/PHY all scale ~V^2; DRAM
*device* energy and leakage do not):

  E = MACs * e_mac * (V/V0)^2 * (1 + abft)        on-die compute + SRAM
    + DRAM_dev_bytes * e_dram * (1 + mem_ovh)     fixed (device) energy
    + P_static * T * (V/V0)                       leakage ~ V

  T = sum over computed steps of  t_nom * (emb + (1-emb) * f0/f)
      (compute-bound; checkpoint offload + recovery reads overlap, Sec 5.4)

Calibration (``calibrate()``): e_mac / e_dram / P_static / utilization are
fit once so the *nominal* DiT-XL-512 run reproduces Table 1's baseline
(6.02 J, 0.56 s) with the compute-dominant split of Fig 11(b)
(~92% die / 6% DRAM device / 2% leakage). Everything else -- the 36%
undervolt saving, the 1.7x overclock speedup, the <3% DRIFT memory
overhead, the DSE sweeps -- is then model OUTPUT, not fit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch import configs
from repro_torch.core import dvfs as dvfs_lib
from repro_torch.core.rollback import DEFAULT_INTERVAL
from repro_torch.models import dit as dit_lib
from repro_torch.models.common import ModelConfig
from repro_torch.perfmodel import flops as flops_lib
from repro_torch.perfmodel import scalesim
from repro_torch.perfmodel.hw import PAPER_ACCEL, PaperAccel


@dataclasses.dataclass(frozen=True)
class RunConfig:
    num_steps: int = 50
    nominal_steps: int = 2
    aggressive: dvfs_lib.OperatingPoint = dvfs_lib.UNDERVOLT
    abft_enabled: bool = True
    ckpt_interval: int = DEFAULT_INTERVAL
    embed_mac_fraction: float = 0.02     # embeds' share of per-step MACs
    taylorseer_interval: int = 0         # 0 = disabled
    # Operand width of the resilient body blocks on aggressive steps
    # (core.quant.PrecisionPlan.body_bits); 8 = the INT8 baseline, priced
    # (and computed) identically to the pre-precision-plan model. The
    # protected fraction (embeds/first block, first nominal_steps) always
    # runs at the baseline width, mirroring the DVFS schedule's protection.
    body_bits: int = 8
    recovery_tiles_per_step: float = 0.0  # from simulation stats
    repacked_layout: bool = True
    # Model evals of ``num_steps`` that were rollback replays (AR window
    # re-decodes). Replays run at the aggressive point like any resilient
    # step, so this splits the ledger's aggressive-compute charge into a
    # first-pass and a replay component without changing the total.
    replay_evals: int = 0


# The energy ledger: every joule run_cost prices lands in exactly one of
# these components, and ``ledger_total`` (a fixed left-to-right sum in this
# order) IS the canonical total -- ``energy_j`` and the legacy aggregate
# keys (e_die/e_dram/e_static/e_drift_mem) are derived from the components,
# never the other way around, so the ledger provably sums to the billed
# total bit for bit (run_cost and per_request_cost alike).
ENERGY_COMPONENTS = (
    "compute_nominal",     # protected steps at (V0, f0), ABFT included
    "compute_aggressive",  # resilient steps: V^2- and precision-scaled MACs
    "compute_replay",      # rollback-replay model evals (AR re-decodes)
    "dram_stream",         # weight/activation streaming per computed step
    "ckpt_refresh",        # rollback-checkpoint refresh writes (offload)
    "recovery",            # rollback recovery tile reads + row overhead
    "static",              # leakage over the run's latency, ~V
)


def ledger_total(breakdown: Dict[str, float]) -> float:
    """The canonical component sum: plain left-to-right addition in
    ``ENERGY_COMPONENTS`` order. Float addition is non-associative, so
    every place that turns a breakdown into a total MUST go through this
    one association -- that is what makes ``sum(components) == energy_j``
    an exact (bitwise) invariant rather than an approximate one."""
    total = 0.0
    for comp in ENERGY_COMPONENTS:
        total += breakdown[comp]
    return total


def _derive_totals(breakdown: Dict[str, float]) -> Dict[str, float]:
    """Aggregate keys recomputed from the (possibly scaled) components,
    each with its own fixed association."""
    return {
        "energy_j": ledger_total(breakdown),
        "e_die": (breakdown["compute_nominal"]
                  + breakdown["compute_aggressive"]
                  + breakdown["compute_replay"]),
        "e_dram": (breakdown["dram_stream"] + breakdown["ckpt_refresh"]
                   + breakdown["recovery"]),
        "e_static": breakdown["static"],
        "e_drift_mem": breakdown["ckpt_refresh"] + breakdown["recovery"],
    }


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    hw: PaperAccel = PAPER_ACCEL
    e_mac_pj: float = 0.12          # on-die energy per MAC (incl. SRAM)
    e_dram_pj_per_byte: float = 4.0  # DRAM device energy
    static_w: float = 0.2
    utilization: float = 0.25       # achieved/peak MACs (SCALE-Sim level)


def model_eval_macs(cfg: ModelConfig, batch: int = 1) -> float:
    return flops_lib.gemm_macs_per_model_eval(cfg, batch)


def dram_bytes_per_eval(cfg: ModelConfig, batch: int = 1) -> float:
    """Weights (int8) streamed once + activation spill traffic."""
    if cfg.family == "dit":
        n = dit_lib.param_count(cfg)
    else:
        n = model_eval_macs(cfg, 1) / max(cfg.latent_size ** 2, 1)
    return float(n) + 2.0 * activation_bytes(cfg, batch) * 0.25


def activation_bytes(cfg: ModelConfig, batch: int = 1) -> float:
    """Checkpointable GEMM-output volume per step (f32)."""
    if cfg.family == "dit":
        t = (cfg.latent_size // cfg.patch_size) ** 2
        d = cfg.d_model
        per_block = t * (4 * d + 2 * cfg.d_ff + d)
        return 4.0 * batch * cfg.n_layers * per_block
    if cfg.family == "unet":
        s, c = cfg.latent_size, cfg.unet_channels
        return 4.0 * batch * sum((s // 2 ** i) ** 2 * ch * 8
                                 for i, ch in enumerate(c))
    # LM decode step: the projection-GEMM outputs the statistical-ABFT
    # context checks (serving/ar.py) -- attn q/k/v/o plus the dense MLP.
    # SSM layers route no GEMMs through the protected path (0 bytes) and
    # MoE expert FFNs are unprotected.
    per_layer = 0.0
    if cfg.family != "ssm":
        per_layer += (cfg.n_heads * cfg.hd + 2 * cfg.kv_heads * cfg.hd
                      + cfg.d_model)
        if cfg.family != "moe":
            per_layer += 2.0 * cfg.d_ff + cfg.d_model
    return 4.0 * batch * cfg.n_layers * per_layer


def run_cost(cfg: ModelConfig, rc: RunConfig, batch: int = 1,
             em: EnergyModel = EnergyModel()) -> Dict[str, float]:
    """Energy (J) and latency (s) for one generated sample batch.

    Besides the aggregate keys, the result carries ``"breakdown"``: the
    per-component energy ledger (``ENERGY_COMPONENTS``). The components
    are the primary arithmetic -- ``energy_j`` is exactly
    ``ledger_total(breakdown)``, so component sums reconcile with the
    billed total bit for bit.
    """
    hw = em.hw
    macs_step = model_eval_macs(cfg, batch)
    act_bytes = activation_bytes(cfg, batch)
    dram_step = dram_bytes_per_eval(cfg, batch)

    steps = list(range(rc.num_steps))
    if rc.taylorseer_interval > 1:
        # Steps below nominal_steps bill as computed, although the
        # sampler forecasts every step off the interval grid (ROADMAP
        # Queue C item 9); kept, so the port bills what the reference does.
        computed = [s for s in steps if s % rc.taylorseer_interval == 0
                    or s < rc.nominal_steps]
    else:
        computed = steps
    n_nom = sum(1 for s in computed if s < rc.nominal_steps)
    n_agg = len(computed) - n_nom

    emb = rc.embed_mac_fraction
    abft = scalesim.abft_overhead_ratio(0, 0, 0, hw) if rc.abft_enabled else 0.0
    v0 = dvfs_lib.V_NOMINAL
    vf2 = (rc.aggressive.voltage / v0) ** 2
    e_mac = em.e_mac_pj * 1e-12

    # on-die energy (V^2-scaled for the aggressive fraction; narrowed
    # body operands additionally scale e_mac ~ (bits/8)^2 -- exactly 1.0
    # at the INT8 baseline, so a default precision plan prices identically)
    bscale_e = flops_lib.mac_bit_energy_scale(rc.body_bits)
    bscale_t = flops_lib.mac_bit_time_scale(rc.body_bits)
    e_die_nom = macs_step * e_mac * (1 + abft)
    e_die_agg = macs_step * e_mac * (1 + abft) \
        * (emb + (1 - emb) * vf2 * bscale_e)
    # replay evals are resilient-step re-runs: same aggressive pricing,
    # split out of the first-pass aggressive component for the ledger
    n_rep = min(max(int(rc.replay_evals), 0), n_agg)

    # DRAM device energy + DRIFT overheads (ckpt writes 1/n + recovery reads)
    ckpt_bytes = (len(computed) / max(rc.ckpt_interval, 1)) * act_bytes
    tiles = rc.recovery_tiles_per_step * len(computed)
    rows = tiles * (1.0 if rc.repacked_layout else hw.array_dim)
    recov_bytes = tiles * hw.array_dim ** 2 * 4 + rows * 64  # + row overhead
    e_byte = em.e_dram_pj_per_byte * 1e-12

    # latency: compute-bound, DVFS frequency scaling; narrowed body
    # operands stream faster through the systolic array (~ bits/8)
    t_nom = macs_step / (hw.peak_macs_per_s * em.utilization)
    f_ratio = hw.freq_ghz / rc.aggressive.freq_ghz
    t_agg = t_nom * (emb + (1 - emb) * f_ratio * bscale_t)
    latency = n_nom * t_nom + n_agg * t_agg

    breakdown = {
        "compute_nominal": n_nom * e_die_nom,
        "compute_aggressive": (n_agg - n_rep) * e_die_agg,
        "compute_replay": n_rep * e_die_agg,
        "dram_stream": len(computed) * dram_step * e_byte,
        "ckpt_refresh": ckpt_bytes * e_byte,
        "recovery": recov_bytes * e_byte,
        "static": em.static_w * latency * (rc.aggressive.voltage / v0),
    }
    out = _derive_totals(breakdown)
    out.update({
        "latency_s": latency,
        "abft_overhead": abft,
        "n_computed_steps": float(len(computed)),
        "breakdown": breakdown,
    })
    return out


def per_request_cost(cfg: ModelConfig, rc: RunConfig, batch: int,
                     n_live: int, em: EnergyModel = EnergyModel(),
                     cost: Optional[Dict[str, float]] = None
                     ) -> Dict[str, float]:
    """Attribute one batch-bucket run's cost evenly across its live requests.

    ``batch`` is the compiled bucket size, ``n_live`` the requests actually
    served by it. Padding slots burn real compute, so their energy lands on
    the live requests (the serving engine's bucketing overhead is visible in
    the per-request numbers instead of silently vanishing). Latency keys are
    returned unscaled. Pass ``cost`` (a prior ``run_cost`` result for the
    same configuration) to skip recomputing the model.

    Each ledger component is scaled by the per-request share and every
    energy aggregate -- ``energy_j`` included -- is re-derived from the
    scaled components with the same association as ``run_cost``, so the
    exact-sum invariant survives attribution: the per-request breakdown
    sums bitwise to the per-request ``energy_j``.
    """
    if cost is None:
        cost = run_cost(cfg, rc, batch=batch, em=em)
    share = 1.0 / max(n_live, 1)
    breakdown = {comp: cost["breakdown"][comp] * share
                 for comp in ENERGY_COMPONENTS}
    out = dict(cost)
    out.update(_derive_totals(breakdown))
    out["breakdown"] = breakdown
    return out


def baseline_rc(num_steps: int = 50) -> RunConfig:
    return RunConfig(num_steps=num_steps, nominal_steps=0,
                     aggressive=dvfs_lib.NOMINAL, abft_enabled=False,
                     ckpt_interval=10 ** 9, recovery_tiles_per_step=0.0)


def calibrate(target_e: float = 6.02, target_t: float = 0.56,
              die_frac: float = 0.92, dram_frac: float = 0.06,
              num_steps: int = 50) -> EnergyModel:
    """Fit the four constants to the Table 1 DiT-XL-512 nominal baseline."""
    cfg = configs.get_config("dit-xl-512")
    hw = PAPER_ACCEL
    macs = model_eval_macs(cfg, 1) * num_steps
    dram = dram_bytes_per_eval(cfg, 1) * num_steps
    util = macs / (hw.peak_macs_per_s * target_t)
    return EnergyModel(
        hw=hw,
        e_mac_pj=target_e * die_frac / macs * 1e12,
        e_dram_pj_per_byte=target_e * dram_frac / dram * 1e12,
        static_w=target_e * (1.0 - die_frac - dram_frac) / target_t,
        utilization=util,
    )
