"""The port's Sec 4 resilience protocol and probes against the reference's.

``repro_torch.examples.resilience_study`` carries the reference's
``benchmarks/common.py`` protocol (``run_sampler``, ``clean_reference``,
``quality_vs_clean``, the two schedules) and the Fig 4-7 probes
(``benchmarks/fig4_bitlevel.py``, ``fig5_timestep.py``, ``fig6_block.py``,
``fig7_selfcorrection.py``). Each probe runs here on the reference's
``tiny_model`` params (``dit.params_from_jax``) and ``sample_inputs``,
with the reference's flip masks (``JaxReplayFlipSource`` on
``PRNGKey(SEED + 2)``, the run key of ``common.run_sampler``), at
``N_STEPS`` denoising steps on both sides, against the reference's
``common.run_sampler`` and ``quality_vs_clean`` at a few points: lpips,
ssim and clip within 1e-3 relative plus 1e-6, psnr within 0.01 dB, NaN
equal to NaN. The reference's Fig 7 ``trajectory`` unpacks four of
``sampler._model_eval``'s five outputs and raises (ROADMAP Queue C 27,
pinned by ``test_reference_fig7_trajectory_raises``); its loop, copied
here with the fifth output taken, is the reference side of the selfheal
test (``_model_eval`` jitted once per drift config: eager, each call
compiles every op). Its ``"clean"`` mode is ``_model_eval``'s, which maps clean to
drift at BER 0 as the port's sampler does: the two clean trajectories
agree within the same 1e-4 as the faulty ones.

Also here: the metrics ``ssim``, ``clip_proxy`` and ``fid_proxy`` against
the reference's, ``dvfs.uniform_schedule``, ``dvfs.pareto_sweep`` and
``fault.expected_flips`` ``==`` the reference's, and each probe's CLI at
SMOKE on the CPU printing the reference's CSV lines (the sweeps at
``N_STEPS``, ``selfheal`` at the reference's 10). Why the parity tests
stop at 4 steps: ``tests/test_torch_resilience_trace.py``.
"""
import functools
import inspect
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import common                              # noqa: E402
from benchmarks import fig4_bitlevel as fig4               # noqa: E402
from benchmarks import fig5_timestep as fig5               # noqa: E402
from benchmarks import fig6_block as fig6                  # noqa: E402
from benchmarks import fig7_selfcorrection as fig7         # noqa: E402
from repro.core import dvfs as jdvfs                       # noqa: E402
from repro.core import fault as jfault                     # noqa: E402
from repro.core import metrics as jmetrics                 # noqa: E402
from repro.core.exec_ctx import DriftSystemConfig as JCfg  # noqa: E402
from repro.diffusion import sampler as jsampler            # noqa: E402
from repro.diffusion import schedule as jsched             # noqa: E402
from repro_torch import configs                            # noqa: E402
from repro_torch.core import dvfs, fault, metrics          # noqa: E402
from repro_torch.examples import resilience_study as rs    # noqa: E402
from repro_torch.models import dit                         # noqa: E402

from test_torch_core import JaxReplayFlipSource            # noqa: E402

ARCH = "dit-xl-512"
N_STEPS = 4                 # denoising steps on both sides
RTOL, ATOL, PSNR_DB, TRAJ_ATOL = 1e-3, 1e-6, 0.01, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread: the SMOKE ops are too small to split, and with
    other test processes on the cores they spend most of their time
    waiting on the pool's threads (the CLIs 3x slower on eight)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def study():
    """(cfg, params, inputs): the reference's SMOKE model and inputs in
    the port's layout."""
    jcfg, jparams = common.tiny_model(ARCH)
    lat0, cond, _ = common.sample_inputs(jcfg)
    cfg = configs.get_config(ARCH, smoke=True)
    params = dit.params_from_jax(jax.tree.map(np.asarray, jparams))
    return cfg, params, (torch.from_numpy(np.array(lat0)),
                         torch.from_numpy(np.array(cond)).long(), None)


def _masks():
    return JaxReplayFlipSource(jax.random.PRNGKey(common.SEED + 2))


def _gate(n_layers, site):
    gate = np.zeros((n_layers,), np.float32)
    if site != "embed":
        gate[site] = 1.0
    return gate, 1.0 if site == "embed" else 0.0


def _reference_sample(kind, x):
    """The reference's faulty sample of one probe point."""
    n = N_STEPS
    if kind == "bits":
        out = common.run_sampler(ARCH, "faulty",
                                 common.schedule_uniform(fig4.RATE, n), n,
                                 5, 10, x)
    elif kind == "steps":
        out = common.run_sampler(
            ARCH, "faulty", common.schedule_single_step(fig5.BER, x, n), n)
    else:
        jcfg, _ = common.tiny_model(ARCH)
        gate, embed = _gate(jcfg.n_layers, x)
        out = common.run_sampler(ARCH, "faulty",
                                 common.schedule_uniform(fig6.BER, n), n, 5,
                                 10, -1, "union", False, gate, embed)
    return out


def _check_quality(got, want):
    assert set(got) == set(want) | {"us"}
    for k in ("lpips", "ssim", "clip"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=0,
                               atol=PSNR_DB, err_msg="psnr")


# --------------------------------------------------------- the protocol
def test_constants_match_reference():
    assert rs.SEED == common.SEED and rs.BATCH == common.BATCH
    assert rs.STEPS == common.N_STEPS == fig7.N_STEPS
    assert list(rs.BITS) == fig4.BITS and rs.BIT_RATE == fig4.RATE
    assert rs.STEP_BER == fig5.BER and rs.BLOCK_BER == fig6.BER


@pytest.mark.parametrize("n", [4, 10])
def test_schedules_match_reference(n):
    for got, want in (
            (rs.schedule_uniform(3e-4, n), common.schedule_uniform(3e-4, n)),
            (rs.schedule_single_step(1e-3, 2, n),
             common.schedule_single_step(1e-3, 2, n))):
        np.testing.assert_array_equal(got.ber_table,
                                      np.asarray(want.ber_table))
        assert got.aggressive.name == want.aggressive.name
        assert got.nominal_steps == want.nominal_steps == 0


def test_clean_reference_against_itself(study, reference):
    """The clean sample scored against itself: lpips 0, psnr at the 1e-12
    clamp, ssim 1, as the reference's; the cache hands the same output
    back."""
    cfg, params, inputs = study
    ref = rs.clean_reference(cfg, params, inputs, N_STEPS)
    assert rs.clean_reference(cfg, params, inputs, N_STEPS) is ref
    got = rs.quality_vs_clean(ref, cfg, params, inputs, N_STEPS)
    want = common.quality_vs_clean(common.clean_reference(ARCH, N_STEPS),
                                   ARCH, N_STEPS)
    assert got["lpips"] == want["lpips"] == 0.0
    assert got["psnr"] == pytest.approx(10 * np.log10(4 / 1e-12), abs=1e-4)
    np.testing.assert_allclose(got["psnr"], want["psnr"], atol=PSNR_DB)
    np.testing.assert_allclose([got["ssim"], want["ssim"]], 1.0, atol=1e-6)
    np.testing.assert_allclose(got["clip"], want["clip"], rtol=RTOL,
                               atol=ATOL)


POINTS = [("bits", 10), ("bits", 30), ("steps", 2), ("blocks", "embed"),
          ("blocks", 0)]
HEAL = {"clean": ("clean", None), **{
    name: ("faulty", common.schedule_single_step(ber, rs.HEAL_STEP))
    for name, ber in rs.HEAL_BERS}}


@pytest.fixture(scope="module")
def reference():
    """The reference's side of every comparison: the quality numbers at
    POINTS and the Fig 7 trajectories (HEAL). Its samplers compile in
    threads at once (XLA compiles outside the GIL; each ``run_sampler``
    call compiles anew); the two faulty trajectories share one compile."""
    jobs = {"clean": lambda: common.clean_reference(ARCH, N_STEPS),
            "heal clean": lambda: _reference_trajectory(*HEAL["clean"]),
            "heal faulty": lambda: {n: _reference_trajectory(*HEAL[n])
                                    for n in HEAL if n != "clean"},
            **{p: functools.partial(_reference_sample, *p) for p in POINTS}}
    common.tiny_model(ARCH)             # its cache filled before the threads
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = {k: pool.submit(fn) for k, fn in jobs.items()}
        done = {k: f.result() for k, f in done.items()}
    return dict(points={p: common.quality_vs_clean(done[p], ARCH, N_STEPS)
                        for p in POINTS},
                heal={"clean": done["heal clean"], **done["heal faulty"]})


@pytest.mark.parametrize("kind,x", POINTS)
def test_probe_point_matches_reference(study, reference, kind, x):
    """One point of ``bit_sweep`` (Fig 4), ``step_sweep`` (Fig 5) or
    ``block_sweep`` (Fig 6) against the reference's run of it."""
    cfg, params, inputs = study
    sweep = {"bits": rs.bit_sweep, "steps": rs.step_sweep,
             "blocks": rs.block_sweep}[kind]
    got = sweep(cfg, params, inputs, [x], N_STEPS, _masks())
    assert list(got) == [x]
    _check_quality(got[x], reference["points"][(kind, x)])


# ------------------------------------------------------- Fig 7 selfheal
@functools.lru_cache(maxsize=None)
def _jitted_eval(scfg):
    cfg, _ = common.tiny_model(ARCH)

    def run(params, lat, t, cond, key, i, ber, stores, have):
        return _EAGER_EVAL(cfg, params, lat, t, cond, None,
                           (scfg, key, i, ber, stores, have))
    return jax.jit(run)


_EAGER_EVAL = jsampler._model_eval


def _model_eval(model_cfg, params, latents, t, cond, text, drift_inputs,
                gates=(None, None)):
    """``sampler._model_eval`` on the SMOKE DiT, jitted once per drift
    config (each eager call would compile every op anew)."""
    assert text is None and gates == (None, None)
    scfg, key, i, ber, stores, have = drift_inputs
    return _jitted_eval(scfg)(params, latents, t, cond, key, i,
                              jnp.asarray(ber, jnp.float32), stores,
                              jnp.asarray(have))


def _reference_trajectory(mode, schedule):
    """``fig7_selfcorrection.trajectory`` at N_STEPS: its loop, taking
    the five outputs ``sampler._model_eval`` returns (jitted)."""
    cfg, params = common.tiny_model(ARCH)
    lat0, cond, text = common.sample_inputs(cfg)
    scfg = jsampler.SamplerConfig(num_sample_steps=N_STEPS,
                                  drift=JCfg(mode=mode), schedule=schedule)
    sched = jsched.DdpmSchedule.default(scfg.num_train_steps)
    ts = jsched.ddim_timesteps(scfg.num_train_steps, N_STEPS)
    key = jax.random.PRNGKey(1234 + 2)
    vals, lat = [], lat0
    stores = jsampler.init_stores(cfg, params, lat0,
                                  jnp.full((common.BATCH,), float(ts[0])),
                                  cond, text, scfg.drift)
    for i, t in enumerate(ts):
        ber = (schedule.ber_table[i] if schedule is not None
               else jnp.zeros(3))
        eps, stores, _, _, _ = _model_eval(
            cfg, params, lat, jnp.full((common.BATCH,), float(t)), cond,
            text, (scfg.drift, jax.random.fold_in(key, i), jnp.int32(i),
                   ber, stores, i > 0))
        t_next = ts[i + 1] if i + 1 < len(ts) else -1
        lat = sched.ddim_step(lat, eps, int(t), int(t_next))
        vals.append(float(lat[0, 4, 4, 0]))
    return np.array(vals)


def test_reference_fig7_trajectory_raises(reference, monkeypatch):
    """The reference's Fig 7 does not run (Queue C 27): it unpacks four
    of ``_model_eval``'s five outputs (the jitted one here, compiled by
    then, for time)."""
    monkeypatch.setattr(fig7, "N_STEPS", N_STEPS)
    monkeypatch.setattr(jsampler, "_model_eval", _model_eval)
    with pytest.raises(ValueError, match="too many values to unpack"):
        fig7.trajectory("clean", None)


@pytest.fixture(scope="module")
def port_heal(study):
    cfg, params, inputs = study
    return rs.selfheal(cfg, params, inputs, N_STEPS, _masks())


@pytest.mark.parametrize("name", ["clean", "small_err", "large_err"])
def test_selfheal_trajectory_matches_reference(port_heal, reference, name):
    """Each Fig 7 trajectory (the clean one through the port's sampler's
    clean-to-drift mapping, the reference's through ``_model_eval``'s)
    within 1e-4 of the reference loop's; the faulted ones leave the clean
    one at step HEAL_STEP and not before."""
    want = reference["heal"][name]
    got = port_heal[name]
    assert got.shape == (N_STEPS,)
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAJ_ATOL)
    if name != "clean":
        assert np.array_equal(got[:rs.HEAL_STEP],
                              port_heal["clean"][:rs.HEAL_STEP])
        assert got[rs.HEAL_STEP] != port_heal["clean"][rs.HEAL_STEP]


def test_heal_summary():
    trajs = {"clean": np.zeros(5), "small_err": np.array([0, 0, 0, .4, .1]),
             "large_err": np.array([0, 0, 0, 1., .9])}
    got = rs.heal_summary(trajs)
    assert got["small_err"] == dict(peak_dev=0.4, final_dev=0.1,
                                    healed=True)
    assert got["large_err"]["healed"] is False


# ------------------------------------------------------------ the CLIs
@pytest.fixture
def cli(monkeypatch):
    """The CLIs as they run, at ``N_STEPS`` denoising steps (their lines'
    format and names do not depend on the step count): ``bit_sweep``,
    ``step_sweep`` and ``block_sweep`` bind ``n_steps=STEPS`` when they
    are defined, so each is replaced by itself at ``N_STEPS``.
    ``selfheal`` keeps the reference's 10."""
    for name in ("bit_sweep", "step_sweep", "block_sweep"):
        monkeypatch.setattr(rs, name, functools.partial(getattr(rs, name),
                                                        n_steps=N_STEPS))


_NUM = r"(-?\d+\.\d{4}|nan|-?inf)"
_CLI = {
    "bits": (fig4, "# fig4: bit,lpips,psnr",
             [f"fig4_bit{b:02d}" for b in fig4.BITS],
             rf"^(\w+),\d+\.\d,lpips={_NUM} psnr=(-?\d+\.\d\d|nan|-?inf)$"),
    "steps": (fig5, "# fig5: inject_step,lpips,psnr",
              [f"fig5_step{s}" for s in range(0, N_STEPS, 2)],
              rf"^(\w+),\d+\.\d,lpips={_NUM} psnr=(-?\d+\.\d\d|nan|-?inf)$"),
    "blocks": (fig6, "# fig6: site,lpips,psnr", None,
               rf"^(\w+),\d+\.\d,lpips={_NUM}$"),
}


@pytest.mark.parametrize("probe", ["bits", "steps", "blocks"])
def test_probe_cli_prints_reference_lines(probe, cli, capsys):
    """``--probe`` at SMOKE on the CPU: the reference's header (as its
    source prints it) and one ``name,us,derived`` line per point, named
    as the reference names them (the steps probe's at ``N_STEPS``)."""
    mod, header, names, pattern = _CLI[probe]
    if names is None:
        n_layers = configs.get_config(ARCH, smoke=True).n_layers
        names = ["fig6_embed"] + [f"fig6_block{b}" for b in range(n_layers)]
    rows = rs.main(["--probe", probe, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert header in inspect.getsource(mod.main) and lines[0] == header
    assert [re.match(pattern, ln).group(1) for ln in lines[1:]] == names
    assert len(rows) == len(names)


def test_selfheal_cli_prints_reference_lines(cli, capsys):
    trajs = rs.main(["--probe", "selfheal", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    header = "# fig7: step,clean,small_err,large_err (pixel [0,4,4,0])"
    assert header in inspect.getsource(fig7.main) and lines[0] == header
    for i, ln in enumerate(lines[1:1 + rs.STEPS]):
        assert re.match(rf"^fig7,{i},{_NUM},{_NUM},{_NUM}$", ln), ln
    assert re.match(r"^fig7_small_recovery,0\.0,peak_dev=\d+\.\d{4} "
                    r"final_dev=\d+\.\d{4} healed=(True|False)$",
                    lines[1 + rs.STEPS])
    assert re.match(r"^fig7_large_recovery,0\.0,peak_dev=\d+\.\d{4} "
                    r"final_dev=\d+\.\d{4}$", lines[2 + rs.STEPS])
    assert len(lines) == rs.STEPS + 3
    assert all(t.shape == (rs.STEPS,) for t in trajs.values())


# ---------------------------------------------------- metrics, helpers
_SHAPES = [(2, 8, 8, 4), (3, 16, 16, 4), (4, 9, 7, 3)]


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    a = np.clip(rng.standard_normal(shape), -1, 1).astype(np.float32)
    b = np.clip(a + 0.3 * rng.standard_normal(shape), -1, 1
                ).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", _SHAPES)
def test_ssim_matches_reference(shape):
    a, b = _images(shape, 11)
    np.testing.assert_allclose(
        float(metrics.ssim(torch.from_numpy(a), torch.from_numpy(b))),
        float(jmetrics.ssim(a, b)), rtol=1e-5)
    assert float(metrics.ssim(torch.from_numpy(a), torch.from_numpy(a))) \
        == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("shape", _SHAPES)
@pytest.mark.parametrize("cond_dim", [8, 64])
def test_clip_proxy_matches_reference(shape, cond_dim):
    a, _ = _images(shape, 12)
    cond = np.random.default_rng(13).standard_normal(
        (shape[0], cond_dim)).astype(np.float32)
    np.testing.assert_allclose(
        float(metrics.clip_proxy(torch.from_numpy(a),
                                 torch.from_numpy(cond))),
        float(jmetrics.clip_proxy(a, cond)), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape", _SHAPES)
def test_fid_proxy_matches_reference(shape):
    a, b = _images(shape, 14)
    np.testing.assert_allclose(
        float(metrics.fid_proxy(torch.from_numpy(a), torch.from_numpy(b))),
        float(jmetrics.fid_proxy(a, b)), rtol=1e-4, atol=1e-7)
    assert float(metrics.fid_proxy(torch.from_numpy(a),
                                   torch.from_numpy(a))) == pytest.approx(
        0.0, abs=1e-6)


@pytest.mark.parametrize("name", ["nominal", "undervolt", "overclock",
                                  "ladder2"])
def test_uniform_schedule_matches_reference(name):
    op = dvfs.OP_LADDER[2] if name == "ladder2" else dvfs.OP_BY_NAME[name]
    jop = jdvfs.OperatingPoint(op.voltage, op.freq_ghz, op.name)
    got, want = dvfs.uniform_schedule(7, op), jdvfs.uniform_schedule(7, jop)
    assert isinstance(got.ber_table, np.ndarray)
    assert got.ber_table.dtype == np.float32
    np.testing.assert_array_equal(got.ber_table, np.asarray(want.ber_table))
    assert got.aggressive == op and got.nominal_steps == want.nominal_steps


def test_pareto_sweep_matches_reference():
    volts, freqs = [0.62, 0.7, 0.8, 0.9], [1.6, 2.0, 2.4]
    got = dvfs.pareto_sweep(volts, freqs)
    want = jdvfs.pareto_sweep(volts, freqs)
    assert len(got) == len(want) == len(volts) * len(freqs)
    for (op, ber, e, s), (jop, jber, je, js) in zip(got, want):
        assert (op.voltage, op.freq_ghz, op.name) == (
            jop.voltage, jop.freq_ghz, jop.name)
        assert (ber, e, s) == (jber, je, js)


@pytest.mark.parametrize("shape,ber,bits", [((64, 32), 3e-3, 32),
                                            ((2, 1024, 1152), 1e-5, 32),
                                            ((7,), 0.5, 16), ((), 1e-3, 32)])
def test_expected_flips_matches_reference(shape, ber, bits):
    assert fault.expected_flips(shape, ber, bits) == \
        jfault.expected_flips(shape, ber, bits)
