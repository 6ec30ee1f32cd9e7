"""The port's sampler knobs against the JAX package's: the precision plans
(``fake_quant``), the TaylorSeer table, and the DRIFT sampling loop with
TaylorSeer and narrowed plans on the SMOKE DiT.

``fake_quant``, ``update_on_compute`` and ``forecast`` are compared bit
for bit with the reference's functions as written (eager ``jnp``). The
sampler runs the reference's ``sample`` and the port's on the same
params, latents and flip masks (``JaxReplayFlipSource``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import dvfs as jdvfs
from repro.core import quant as jquant
from repro.core.exec_ctx import DriftSystemConfig as JCfg
from repro.diffusion import sampler as jsampler
from repro.diffusion import taylorseer as jts
from repro_torch import configs
from repro_torch.core import dvfs, quant
from repro_torch.core.exec_ctx import DriftSystemConfig
from repro_torch.diffusion import sampler
from repro_torch.diffusion import taylorseer as ts
from repro_torch.models import dit

from test_torch_core import JaxReplayFlipSource
from test_torch_dit import perturbed_jax_params

ARCH = "dit-xl-512"


def _bits(x) -> np.ndarray:
    """Bit pattern of a float tensor or array, widened to f32 first."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy().view(np.int32)
    return np.asarray(x.astype(jnp.float32)).view(np.int32)


# ------------------------------------------------------------ precision
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", range(2, 9))
def test_fake_quant_bit_equal(bits, dtype):
    """Random values plus the half-way points of the grid (round half to
    even on both sides), and an all-zero tensor (the 1e-8 floor)."""
    rng = np.random.default_rng(bits)
    levels = 2 ** (bits - 1) - 1
    x = rng.standard_normal(200).astype(np.float32)
    x[:8] = (np.arange(8) - 3.5) * (np.abs(x).max() / levels)
    for arr in (x, np.zeros(16, np.float32)):
        jx = jnp.asarray(arr).astype(dtype)
        tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
            getattr(torch, dtype))
        got = quant.fake_quant(tx, bits)
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(_bits(got),
                                      _bits(jquant.fake_quant(jx, bits)))


def test_precision_plans_match_reference():
    assert quant.PRECISION_PLANS.keys() == jquant.PRECISION_PLANS.keys()
    for name, plan in quant.PRECISION_PLANS.items():
        want = jquant.get_plan(name)
        # the port pins the sensitive sites to BASE_BITS as a constant
        want_fields = dataclasses.asdict(want)
        assert want_fields.pop("sensitive_bits") == quant.BASE_BITS
        assert dataclasses.asdict(plan) == want_fields
        assert plan.narrowed == want.narrowed
        assert quant.quant_noise(plan.body_bits) == \
            jquant.quant_noise(want.body_bits)
    assert quant.get_plan("int8-body4").with_protect_steps(5) \
        .protect_steps == 5
    assert quant.DEFAULT_PLAN.name == "int8" and not quant.DEFAULT_PLAN \
        .narrowed
    with pytest.raises(ValueError, match="unknown precision plan"):
        quant.get_plan("int3")
    with pytest.raises(ValueError):
        quant.PrecisionPlan("bad", body_bits=1)


# ----------------------------------------------------------- TaylorSeer
def test_taylor_table_and_forecast_bit_equal():
    """update_on_compute after 0..3 earlier evaluations, and forecast at
    k = 0, 1, 2 from each table, equal bit for bit."""
    rng = np.random.default_rng(0)
    shape = (2, 8, 8, 4)
    jstate, state = jts.init_state(shape), ts.init_state(shape)
    for n in range(4):
        y = rng.standard_normal(shape).astype(np.float32)
        assert state.n_computed == int(jstate.n_computed) == n
        jstate = jts.update_on_compute(jstate, jnp.asarray(y))
        state = ts.update_on_compute(state, torch.from_numpy(y))
        for got, want in zip(state[:3], jstate[:3]):
            np.testing.assert_array_equal(_bits(got), _bits(want))
        for k in range(3):
            for order in (1, 2):
                np.testing.assert_array_equal(
                    _bits(ts.forecast(state, k, 3, order)),
                    _bits(jts.forecast(jstate, jnp.int32(k), 3, order)))


@pytest.mark.parametrize("steps,interval", [(7, 3), (10, 3), (10, 4)])
def test_should_compute_and_speedup_match_reference(steps, interval):
    on = ts.TaylorSeerConfig(interval=interval)
    jon = jts.TaylorSeerConfig(interval=interval)
    off = ts.TaylorSeerConfig(enabled=False)
    assert [ts.should_compute(i, on) for i in range(steps)] == \
        [bool(jts.should_compute(jnp.int32(i), jon)) for i in range(steps)]
    assert all(ts.should_compute(i, off) for i in range(steps))
    assert ts.speedup(steps, on) == jts.speedup(steps, jon)
    assert ts.speedup(steps, off) == 1.0


# -------------------------------------------------------------- sampler
@pytest.fixture(scope="module")
def smoke():
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    np_params = perturbed_jax_params(jcfg, seed=5)
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    cond = np.array([3, 8], np.int32)
    return jcfg, np_params, lat, cond


@pytest.mark.parametrize("taylorseer,plan", [(True, "int8-body4"),
                                             (False, "int8-body6")])
def test_sample_matches_jax(smoke, taylorseer, plan):
    """7 drift steps at undervolt (nominal_steps 2), the reference's masks:
    evaluations, corrected elements, the heatmap (zero rows on forecast
    steps) and the monitor's ladder index exact; latents within 1e-4
    (f32 SMOKE; XLA fuses the forecast and quantization where PyTorch runs
    op by op, and the rollback splices checkpoints that carry those
    differences)."""
    jcfg, np_params, lat, cond = smoke
    steps = 7
    run_key = jax.random.PRNGKey(11)
    jscfg = jsampler.SamplerConfig(
        num_sample_steps=steps, drift=JCfg(mode="drift"),
        schedule=jdvfs.fine_grained_schedule(steps, jdvfs.UNDERVOLT),
        taylorseer=jts.TaylorSeerConfig(enabled=taylorseer),
        precision=jquant.get_plan(plan).with_protect_steps(2))
    want = jsampler.sample(jcfg, jax.tree.map(jnp.asarray, np_params),
                           run_key, jnp.asarray(lat), jnp.asarray(cond),
                           None, jscfg)
    cfg = configs.get_config(ARCH, smoke=True)
    scfg = sampler.SamplerConfig(
        num_sample_steps=steps, drift=DriftSystemConfig(mode="drift"),
        schedule=dvfs.fine_grained_schedule(steps, dvfs.UNDERVOLT),
        taylorseer=ts.TaylorSeerConfig(enabled=taylorseer),
        precision=quant.get_plan(plan).with_protect_steps(2))
    src = JaxReplayFlipSource(run_key)
    got = sampler.sample(cfg, dit.params_from_jax(np_params), src,
                         torch.from_numpy(lat), torch.from_numpy(cond).long(),
                         scfg)
    computed = [i for i in range(steps) if not taylorseer or i % 3 == 0]
    assert got.n_model_evals == int(want.n_model_evals) == len(computed)
    assert {s.step for s in src.calls} == {i for i in computed if i >= 2}
    assert int(got.total_corrected) == int(want.total_corrected) > 0
    heat = got.heatmap.numpy()
    np.testing.assert_array_equal(heat, np.asarray(want.heatmap))
    skipped = [i for i in range(steps) if i not in computed]
    assert not heat[skipped].any() and heat[computed[-1]].any()
    assert int(got.monitor.op_index) == int(want.monitor.op_index)
    assert got.monitor.n_updates == steps
    np.testing.assert_allclose(got.monitor.ema_ber.numpy(),
                               np.asarray(want.monitor.ema_ber), rtol=1e-5)
    np.testing.assert_allclose(got.latents.numpy(), np.asarray(want.latents),
                               atol=1e-4, rtol=0)

