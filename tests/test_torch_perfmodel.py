"""The port's perfmodel against the JAX package's, with ``==``.

The perfmodel is plain Python float arithmetic; the port copies every
expression with its association unchanged, so each number it returns must
equal the reference's bit for bit: ``run_cost`` and ``per_request_cost``
over the configuration matrix of the reference's ledger test (restricted
to the ported archs -- the DiT, PixArt's cross-attention term, the UNet's
conv sweep and per-pixel token proxy, olmo-1b -- plus replay evals), ``calibrate``, the per-config
functions, shapes, the cycle model and the DRAM report. Then the paper
ranges of the reference's perfmodel test that read only dit-xl-512.
"""
import dataclasses
import itertools

import pytest

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.core import dvfs as jdvfs
from repro.models import dit as jdit
from repro.models import transformer as jtf
from repro.models.common import ModelConfig as JModelConfig
from repro.perfmodel import dram as jdram
from repro.perfmodel import energy as jenergy
from repro.perfmodel import flops as jflops
from repro.perfmodel import scalesim as jscalesim
from repro.perfmodel.hw import PAPER_ACCEL as J_ACCEL
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.core import dvfs
from repro_torch.models import dit, transformer
from repro_torch.models.common import ModelConfig
from repro_torch.perfmodel import dram, energy, flops, scalesim
from repro_torch.perfmodel.hw import PAPER_ACCEL

ARCHS = ("dit-xl-512", "pixart-alpha", "sd15-unet", "olmo-1b")
OPS = ("nominal", "undervolt", "overclock")
JOPS = {"nominal": jdvfs.NOMINAL, "undervolt": jdvfs.UNDERVOLT,
        "overclock": jdvfs.OVERCLOCK}


@pytest.fixture(scope="module")
def models():
    return energy.calibrate(), jenergy.calibrate()


def assert_cost_equal(got, want):
    """Every key with ==, the breakdown key by key, and the ledger sum
    equal to energy_j bitwise."""
    assert set(got) == set(want)
    for k in want:
        if k != "breakdown":
            assert got[k] == want[k], k
    assert tuple(got["breakdown"]) == energy.ENERGY_COMPONENTS
    for comp in jenergy.ENERGY_COMPONENTS:
        assert got["breakdown"][comp] == want["breakdown"][comp], comp
    assert energy.ledger_total(got["breakdown"]) == got["energy_j"]


def _rc_pair(op, **kw):
    return (energy.RunConfig(aggressive=dvfs.OP_BY_NAME[op], **kw),
            jenergy.RunConfig(aggressive=JOPS[op], **kw))


@pytest.mark.parametrize("abft", [True, False])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_run_cost_matches_reference_over_matrix(models, arch, op, abft):
    """TaylorSeer 0/3 x body bits 8/4 x interval 4/1e9 x replay evals
    {0, 3, 20, -1} x batch 1/4 x n_live {1, 2, batch}."""
    em, jem = models
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    checked = 0
    for ts, bits, interval, replay in itertools.product(
            (0, 3), (8, 4), (4, 10 ** 9), (0, 3, 20, -1)):
        rc, jrc = _rc_pair(op, num_steps=12, nominal_steps=2,
                           abft_enabled=abft, taylorseer_interval=ts,
                           body_bits=bits, ckpt_interval=interval,
                           recovery_tiles_per_step=0.5, replay_evals=replay)
        for batch in (1, 4):
            cost = energy.run_cost(cfg, rc, batch=batch, em=em)
            assert_cost_equal(cost, jenergy.run_cost(jcfg, jrc, batch=batch,
                                                     em=jem))
            for n_live in (1, 2, batch):
                assert_cost_equal(
                    energy.per_request_cost(cfg, rc, batch=batch,
                                            n_live=n_live, em=em, cost=cost),
                    jenergy.per_request_cost(jcfg, jrc, batch=batch,
                                             n_live=n_live, em=jem))
            checked += 1
    assert checked == 2 * 2 * 2 * 4 * 2


@pytest.mark.parametrize("steps", [1, 3, 10, 50])
def test_baseline_and_default_model_match_reference(steps):
    """``baseline_rc`` priced with the uncalibrated default EnergyModel."""
    for arch in ARCHS:
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        rc, jrc = energy.baseline_rc(steps), jenergy.baseline_rc(steps)
        assert rc.aggressive.name == jrc.aggressive.name == "nominal"
        assert_cost_equal(energy.run_cost(cfg, rc, batch=2),
                          jenergy.run_cost(jcfg, jrc, batch=2))


def test_calibration_matches_reference(models):
    em, jem = models
    for f in ("e_mac_pj", "e_dram_pj_per_byte", "static_w", "utilization"):
        assert getattr(em, f) == getattr(jem, f), f
    assert dataclasses.asdict(em.hw) == dataclasses.asdict(jem.hw)
    assert dataclasses.asdict(PAPER_ACCEL) == dataclasses.asdict(J_ACCEL)
    assert PAPER_ACCEL.peak_macs_per_s == J_ACCEL.peak_macs_per_s
    assert energy.ENERGY_COMPONENTS == jenergy.ENERGY_COMPONENTS


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_per_config_functions_match_reference(arch, smoke):
    cfg = configs.get_config(arch, smoke=smoke)
    jcfg = jconfigs.get_config(arch, smoke=smoke)
    assert cfg.layer_windows() == jcfg.layer_windows()
    for batch in (1, 2):
        assert flops.gemm_macs_per_model_eval(cfg, batch) == \
            jflops.gemm_macs_per_model_eval(jcfg, batch)
        assert energy.activation_bytes(cfg, batch) == \
            jenergy.activation_bytes(jcfg, batch)
        assert energy.dram_bytes_per_eval(cfg, batch) == \
            jenergy.dram_bytes_per_eval(jcfg, batch)
    assert flops.active_params(cfg) == jflops.active_params(jcfg)
    if cfg.family in ("dit", "unet"):
        # the reference prices the UNet with the DiT's formula too
        assert dit.param_count(cfg) == jdit.param_count(jcfg)
    else:
        assert transformer.param_count(cfg) == jtf.param_count(jcfg)
    for cell in shapes.cells_for(arch):
        assert flops.cell_flops(cfg, shapes.get_shape(cell)) == \
            jflops.cell_flops(jcfg, jshapes.get_shape(cell)), cell
    for bits in range(2, 9):
        assert flops.mac_bit_energy_scale(bits) == \
            jflops.mac_bit_energy_scale(bits)
        assert flops.mac_bit_time_scale(bits) == \
            jflops.mac_bit_time_scale(bits)
    assert flops.DECODE_CONTEXT == jflops.DECODE_CONTEXT


def test_shapes_match_reference():
    for arch in jconfigs.list_archs():
        assert shapes.cells_for(arch) == jshapes.cells_for(arch), arch
        assert shapes.skipped_cells(arch) == jshapes.skipped_cells(arch)
    for name in list(jshapes.LM_SHAPES) + list(jshapes.DIFFUSION_SHAPES):
        assert dataclasses.asdict(shapes.get_shape(name)) == \
            dataclasses.asdict(jshapes.get_shape(name))
    assert shapes.LM_ARCHS == jshapes.LM_ARCHS
    assert shapes.DIFFUSION_ARCHS == jshapes.DIFFUSION_ARCHS
    assert shapes.LONG_CONTEXT_OK == jshapes.LONG_CONTEXT_OK


def test_scalesim_and_dram_match_reference():
    for m, k, n in itertools.product((1, 33, 1024, 2048), (64, 1152),
                                     (32, 1152, 4608)):
        assert dataclasses.asdict(scalesim.gemm(m, k, n, PAPER_ACCEL)) == \
            dataclasses.asdict(jscalesim.gemm(m, k, n, J_ACCEL))
        assert scalesim.gemm_seconds(m, k, n, PAPER_ACCEL, 3.5) == \
            jscalesim.gemm_seconds(m, k, n, J_ACCEL, 3.5)
    assert scalesim.abft_overhead_ratio(0, 0, 0, PAPER_ACCEL) == \
        jscalesim.abft_overhead_ratio(0, 0, 0, J_ACCEL)
    for tiles, tm, tn, cols in itertools.product(
            (0.0, 1.0, 37.5, 200.0), (16, 32), (32, 64), (8, 256, 1152)):
        assert dram.recovery_report(tiles, tm, tn, cols) == \
            jdram.recovery_report(tiles, tm, tn, cols)
        assert dram.repack_speedup(tm, tn, cols) == \
            jdram.repack_speedup(tm, tn, cols)


# --------------------------------------------------------- paper ranges
def test_calibration_hits_table1_baseline(models):
    em, _ = models
    cfg = configs.get_config("dit-xl-512")
    base = energy.run_cost(cfg, energy.baseline_rc(50), em=em)
    assert abs(base["energy_j"] - 6.02) < 0.05
    assert abs(base["latency_s"] - 0.56) < 0.01


def test_undervolt_saving_and_overclock_speedup_in_paper_range(models):
    """dit-xl-512 alone: the 36% undervolt saving (the reference averages
    three archs into 0.28-0.40) and the 1.7x overclock speedup."""
    em, _ = models
    cfg = configs.get_config("dit-xl-512")
    base = energy.run_cost(cfg, energy.baseline_rc(50), em=em)
    uv = energy.run_cost(cfg, energy.RunConfig(
        num_steps=50, aggressive=dvfs.UNDERVOLT,
        recovery_tiles_per_step=200), em=em)
    assert 0.28 < 1 - uv["energy_j"] / base["energy_j"] < 0.40
    oc = energy.run_cost(cfg, energy.RunConfig(
        num_steps=50, aggressive=dvfs.OVERCLOCK), em=em)
    assert 1.6 < base["latency_s"] / oc["latency_s"] < 1.75


def test_drift_memory_and_abft_overheads(models):
    em, _ = models
    cfg = configs.get_config("dit-xl-512")
    uv = energy.run_cost(cfg, energy.RunConfig(
        num_steps=50, aggressive=dvfs.UNDERVOLT,
        ckpt_interval=10, recovery_tiles_per_step=200), em=em)
    assert uv["e_drift_mem"] / uv["energy_j"] < 0.03       # Sec 6.2
    assert abs(scalesim.abft_overhead_ratio(0, 0, 0, PAPER_ACCEL)
               - 0.063) < 0.005
    costs = [energy.run_cost(cfg, energy.RunConfig(
        num_steps=50, aggressive=dvfs.UNDERVOLT, ckpt_interval=n), em=em)
        ["e_drift_mem"] for n in [1, 2, 5, 10]]
    assert costs[0] > costs[1] > costs[2] > costs[3]       # Fig 14b


def test_repack_and_recovery_overlap():
    assert dram.repack_speedup(32, 32, 1152) >= 8.0
    rep = dram.recovery_report(100, 32, 32, 1152)
    gemm_us = scalesim.gemm_seconds(1024, 1152, 1152, PAPER_ACCEL) * 1e6
    assert rep["t_retrieval_repacked_us"] < gemm_us        # Sec 6.4
    st = scalesim.gemm(1024, 1152, 1152, PAPER_ACCEL)
    assert 0.0 < st.utilization <= 1.0
    assert st.macs == 1024 * 1152 * 1152


def test_taylorseer_and_narrowed_plans_bill_less(models):
    """The knobs the port now serves: TaylorSeer bills fewer steps (5 of
    10, since steps below nominal_steps bill as computed: ROADMAP Queue C
    item 9), and a narrowed body less again."""
    em, _ = models
    cfg = configs.get_config("dit-xl-512")
    costs = [energy.run_cost(cfg, energy.RunConfig(
        num_steps=10, taylorseer_interval=ts, body_bits=bits), batch=2,
        em=em) for ts, bits in ((0, 8), (3, 8), (3, 4))]
    assert [c["n_computed_steps"] for c in costs] == [10.0, 5.0, 5.0]
    assert costs[0]["energy_j"] > costs[1]["energy_j"] > costs[2]["energy_j"]
    assert costs[1]["latency_s"] > costs[2]["latency_s"]


def test_unported_families_raise():
    """The enc-dec and VLM families get the reference's numbers (``==``),
    at full width, at SMOKE and on a small hand-made config: the
    reference prices both as dense LMs."""
    encdec = ModelConfig(name="m", family="encdec", n_layers=2, d_model=8,
                         n_heads=2, d_ff=16, vocab=32)
    jencdec = JModelConfig(name="m", family="encdec", n_layers=2, d_model=8,
                           n_heads=2, d_ff=16, vocab=32)
    pairs = [(encdec, jencdec),
             (dataclasses.replace(encdec, family="vlm"),
              dataclasses.replace(jencdec, family="vlm"))]
    for arch in ("whisper-base", "internvl2-76b"):
        for smoke in (False, True):
            pairs.append((configs.get_config(arch, smoke=smoke),
                          jconfigs.get_config(arch, smoke=smoke)))
    for cfg, jcfg in pairs:
        assert transformer.param_count(cfg) == jtf.param_count(jcfg)
        assert flops.active_params(cfg) == jflops.active_params(jcfg)
        for batch in (1, 2):
            assert flops.gemm_macs_per_model_eval(cfg, batch) == \
                jflops.gemm_macs_per_model_eval(jcfg, batch)
            assert energy.activation_bytes(cfg, batch) == \
                jenergy.activation_bytes(jcfg, batch)
            assert energy.dram_bytes_per_eval(cfg, batch) == \
                jenergy.dram_bytes_per_eval(jcfg, batch)
    for arch in ("whisper-base", "internvl2-76b"):
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        for cell in shapes.cells_for(arch):
            assert flops.cell_flops(cfg, shapes.get_shape(cell)) == \
                jflops.cell_flops(jcfg, jshapes.get_shape(cell)), cell
