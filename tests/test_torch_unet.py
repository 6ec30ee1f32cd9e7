"""The port's SD1.5 UNet against the JAX package's, on the SMOKE config
(channels 32/64/96, 16x16 latents, two stride-2 downsamples, 8 stub text
tokens of width 32).

Params come from the reference's init with ``conv_out`` made non-zero
(with its zero init the model predicts eps = 0), carried over by
``unet.params_from_jax``; latents, timesteps and text are the same numpy
arrays on both sides, and the flip masks the reference's: the UNet's one
context draws from the step key without a scope fold
(``JaxReplayFlipSource(fold_scope=False)``).

The UNet's quantized path is held looser than the DiT's (ROADMAP Queue C
13). Its 40 GEMM inputs sit behind convolutions and GroupNorms whose f32
sums each framework orders its own way (XLA's compiled code differently
again from eager JAX), and an input whose ``x / scale`` lies within that
noise of a rounding boundary lands on the neighbouring int8 level, 1/127
of the tensor's range: on these inputs jitted JAX's ``up1`` GEMM outputs
differ from eager JAX's by up to 5.6e-3 of their scale. The protected
forward is held against the reference run eagerly, within one such
level. Over a served run the same noise reaches the masks: a flip's
contribution to its row's checksum difference is +2^b or -2^b by the
bit's value, so where a tip changes a low bit of a flipped accumulator, a
row of several flips below the threshold bit can cross it. The corrected
count of a served SMOKE batch then differs by a few tile rows, as the
card's does from the CPU's in ``chip_smoke.py``; the slice test states
its bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.exec_ctx import DriftSystemConfig as JCfg
from repro.core.exec_ctx import ExecContext as JCtx
from repro.diffusion import sampler as jsampler
from repro.models import unet as junet
from repro.serving import DriftServeEngine as JaxEngine
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.core.exec_ctx import DriftSystemConfig, ExecContext
from repro_torch.diffusion.sampler import detection_rows
from repro_torch.launch import serve
from repro_torch.models import unet
from repro_torch.serving import DriftServeEngine
from repro_torch.perfmodel import energy
from repro_torch.serving.servable import paradigm_for

from test_torch_core import JaxReplayFlipSource, jax_replay_factory

ARCH = "sd15-unet"
STEPS = 3
SEEDS = (0, 1)


def perturbed_unet_params(cfg, seed=0):
    """The reference's init with a non-zero ``conv_out``."""
    key = jax.random.PRNGKey(seed)
    p = jsteps.init_model_params(cfg, key)
    p["conv_out"] = 0.05 * jax.random.normal(jax.random.fold_in(key, 1),
                                             p["conv_out"].shape)
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    np_params = perturbed_unet_params(jcfg, seed=2)
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([999.0, 500.0], np.float32)
    text = (0.1 * rng.standard_normal((2, 8, 32))).astype(np.float32)
    return jcfg, np_params, lat, t, text


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def test_config_matches_reference():
    for smoke in (False, True):
        got = configs.get_config(ARCH, smoke=smoke)
        want = jconfigs.get_config(ARCH, smoke=smoke)
        for f in ("family", "n_layers", "d_model", "unet_channels",
                  "latent_size", "latent_channels", "cond_dim",
                  "cond_tokens"):
            assert getattr(got, f) == getattr(want, f), f
    full = configs.get_config(ARCH)
    assert full.unet_channels == (320, 640, 1280)
    assert full.dtype == torch.bfloat16
    assert paradigm_for(ARCH) == "diffusion"
    assert detection_rows(full) == 1
    assert unet.protected_gemms(full) == 40


@pytest.mark.parametrize("size,k,stride", [(16, 3, 1), (16, 3, 2),
                                           (15, 3, 2), (8, 1, 1)])
def test_conv_same_padding_matches_lax(size, k, stride):
    """"SAME" at stride 2 pads (0, 1) on an even size: the port's conv
    equals lax.conv_general_dilated within 1e-5 (f32 sums in another
    order); with symmetric (1, 1) padding it would not."""
    rng = np.random.default_rng(size + k + stride)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 7)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = unet._conv(_t(x), _t(w), stride=stride).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if stride == 2 and size % 2 == 0:
        sym = torch.nn.functional.conv2d(
            _t(x).permute(0, 3, 1, 2), _t(w).permute(3, 2, 0, 1),
            stride=2, padding=1).permute(0, 2, 3, 1).numpy()
        assert sym.shape == want.shape and not np.allclose(sym, want,
                                                           atol=1e-3)


def test_group_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = (3 * rng.standard_normal((2, 4, 4, 64)) + 1).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(junet.group_norm(jnp.asarray(x), jnp.asarray(s),
                                       jnp.asarray(b)))
    got = unet.group_norm(_t(x), _t(s), _t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_params_from_jax_keeps_structure(setup):
    jcfg, np_params, *_ = setup
    p = unet.params_from_jax(np_params)
    own = unet.init_params(configs.get_config(ARCH, smoke=True), seed=1)

    def shapes(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)
    assert shapes(p) == shapes(own)
    assert p["down"][0]["attn"] is None and p["up"][2]["up"] is None
    np.testing.assert_array_equal(p["mid"]["attn"]["cross"]["wk"].numpy(),
                                  np_params["mid"]["attn"]["cross"]["wk"])
    assert not own["conv_out"].any()


def test_forward_float_matches_jax(setup):
    """Unprotected f32 forward: 2e-5 of the eps scale."""
    jcfg, np_params, lat, t, text = setup
    want = np.asarray(junet.forward(
        jcfg, jax.tree.map(jnp.asarray, np_params), jnp.asarray(lat),
        jnp.asarray(t), jnp.asarray(text)))
    cfg = configs.get_config(ARCH, smoke=True)
    got = unet.forward(cfg, unet.params_from_jax(np_params), _t(lat), _t(t),
                       _t(text))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("mode", ["clean", "drift"])
def test_forward_protected_matches_jax(setup, mode):
    """clean (BER 0) and drift at BER 1e-2 with the reference's masks,
    against the reference run eagerly: detected rows and corrected
    elements exact (0 in clean), the store's names and shapes the
    reference's (``eval_shape``). eps within 2e-3 of its scale and each
    refreshed store buffer within 1e-2 of its scale: one GEMM input that
    tips to the neighbouring int8 level (module docstring) moves that
    GEMM's outputs by up to one level, 1/127 of the input's range, times
    a weight."""
    jcfg, np_params, lat, t, text = setup
    run_key = jax.random.PRNGKey(3)
    step = 10
    ber = np.full((3,), 1e-2 if mode == "drift" else 0.0, np.float32)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstore = jsampler.init_stores(jcfg, jparams, jnp.asarray(lat),
                                  jnp.asarray(t), None, jnp.asarray(text),
                                  JCfg(mode="drift"))

    jctx = JCtx(JCfg(mode="drift"), key=jax.random.fold_in(run_key, step),
                step=step, ber_by_class=jnp.asarray(ber), state_in=jstore,
                have_ckpt=True)
    want = junet.forward(jcfg, jparams, jnp.asarray(lat), jnp.asarray(t),
                         jnp.asarray(text), ctx=jctx)
    jstate, jstats = jctx.state_out, jctx.stats
    cfg = configs.get_config(ARCH, smoke=True)
    store = unet.drift_store_spec(cfg, 2)
    assert {k: tuple(v.shape) for k, v in store.items()} == \
        {k: v.shape for k, v in jstore.items()}
    ctx = ExecContext(DriftSystemConfig(mode="drift"),
                      flip_source=JaxReplayFlipSource(run_key,
                                                      fold_scope=False),
                      step=step, scope=unet.SCOPE, ber_by_class=ber,
                      state_in=store, have_ckpt=True)
    got = unet.forward(cfg, unet.params_from_jax(np_params), _t(lat), _t(t),
                       _t(text), ctx=ctx)
    for stat in ("detected_row_errors", "corrected_elems", "gemm_words"):
        assert int(ctx.stats[stat]) == int(jstats[stat]), stat
    assert (int(ctx.stats["corrected_elems"]) > 0) == (mode == "drift")
    assert int(ctx.stats["gemm_words"]) == sum(
        v.numel() for v in store.values())
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2e-3 * np.abs(want).max(), rtol=0)
    for name, w_ in jstate.items():
        w_ = np.asarray(w_)
        np.testing.assert_allclose(store[name].numpy(), w_,
                                   atol=1e-2 * np.abs(w_).max(), rtol=0)


@pytest.fixture(scope="module")
def jax_run():
    """One reference engine: 2 drift then 2 faulty requests at undervolt
    (2 batches, one shared clean reference)."""
    eng = JaxEngine(arch=ARCH, smoke=True, bucket=2, base_seed=0)
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    np_params = perturbed_unet_params(jcfg, seed=5)
    eng._params[(ARCH, True)] = jax.tree.map(jnp.asarray, np_params)
    lat, _, text = eng.servable_for(ARCH).batch_inputs(jcfg, list(SEEDS))
    for mode in ("drift", "faulty"):
        for s in SEEDS:
            eng.submit(steps=STEPS, mode=mode, op="undervolt", seed=s)
    return np_params, np.asarray(lat), np.asarray(text), eng.run()


def test_slice_matches_jax_engine(jax_run):
    """Per request: evaluations, the monitor's ladder index and every
    ledger term but recovery exact. Within the int8 rounding tips of the
    module docstring: the corrected count and the heatmap's detections
    within 0.1%, the recovery joules within 0.1% and the billed energy
    within 1e-6 relative; drift latents within 1e-2 everywhere and 1e-4
    on average (a tile row spliced in one run and not in the other moves
    its neighbourhood), PSNR within 0.05 dB. Faulty corrects nothing;
    its latents are finite on the port, while the jitted reference's are
    NaN (ROADMAP Queue C 13; eager JAX agrees with the port), so they are
    not compared."""
    np_params, lat, text, want = jax_run
    eng = DriftServeEngine(arch=ARCH, smoke=True, bucket=2, base_seed=0,
                           device="cpu",
                           flip_source_factory=jax_replay_factory(
                               0, fold_scope=False))
    eng.set_params(ARCH, True, unet.params_from_jax(np_params))
    eng.servable.batch_inputs = lambda cfg, seeds: (_t(lat), None, _t(text))
    for mode in ("drift", "faulty"):
        for s in SEEDS:
            eng.submit(steps=STEPS, mode=mode, op="undervolt", seed=s)
    got = eng.run()
    assert [g.mode for g in got] == [w.mode for w in want]
    for g, w in zip(got, want):
        assert abs(g.batch_corrected_elems - w.batch_corrected_elems) \
            <= 1e-3 * w.batch_corrected_elems
        assert (g.batch_corrected_elems > 0) == (g.mode == "drift")
        assert g.n_model_evals == w.n_model_evals == STEPS
        assert g.monitor_op_index == w.monitor_op_index
        for f in ("baseline_energy_j", "latency_s", "baseline_latency_s",
                  "completed_at_s"):
            assert getattr(g, f) == getattr(w, f), f
        for comp, v in w.energy_breakdown.items():
            if comp != "recovery":
                assert g.energy_breakdown[comp] == v, comp
        np.testing.assert_allclose(g.energy_breakdown["recovery"],
                                   w.energy_breakdown["recovery"], rtol=1e-3)
        np.testing.assert_allclose(g.energy_j, w.energy_j, rtol=1e-6)
        assert energy.ledger_total(g.energy_breakdown) == g.energy_j
        np.testing.assert_allclose(np.asarray(g.detect_heatmap, float),
                                   np.asarray(w.detect_heatmap, float),
                                   rtol=1e-3)
        assert bool(torch.isfinite(g.latents).all())
        if g.mode == "faulty":
            assert np.isnan(np.asarray(w.latents)).all()
            continue
        diff = np.abs(g.latents.numpy() - np.asarray(w.latents))
        assert diff.max() <= 1e-2 and diff.mean() <= 1e-4
        assert abs(g.psnr_vs_clean_db - w.psnr_vs_clean_db) < 0.05
        assert g.psnr_vs_clean_db < 90
    assert eng.stats.clean_samples_computed == 1


def test_cli_serves_the_unet_on_cpu(capsys):
    """``--arch sd15-unet`` through the CLI: 3 evaluations per request,
    one detection row, and the perfmodel line."""
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out
    assert "sd15-unet" in out and out.count("perfmodel/request") == 2
    for r in res:
        assert r.n_model_evals == 3 and r.batch_corrected_elems > 0
        assert len(r.detect_heatmap) == 1


@pytest.mark.parametrize("arch", ["pixart-alpha", ARCH])
def test_offload_and_previews_keep_finals(arch):
    """The offload store takes PixArt's (embed, block) stores and the
    UNet's flat one unchanged: offload with previews every step at
    refresh interval 2 commits 2 snapshots (steps 0 and 2) of the whole
    store,
    yields 2 previews per request, and leaves the finals and counts
    bit-identical to a plain run's."""
    from repro_torch.serving import OffloadConfig
    from repro_torch.serving.offload import layout
    out = {}
    for offload in (False, True):
        eng = DriftServeEngine(arch=arch, smoke=True, bucket=2,
                               device="cpu",
                               offload=OffloadConfig() if offload else None)
        for s in SEEDS:
            eng.submit(steps=3, mode="drift", op="undervolt", seed=s,
                       rollback_interval=2)
        events = list(eng.run_stream(1) if offload else eng.run())
        res = [e for e in events if hasattr(e, "batch_corrected_elems")]
        out[offload] = (res, len(events) - len(res), eng)
    (plain, _, _), (off, previews, eng) = out[False], out[True]
    for a, b in zip(plain, off):
        assert torch.equal(a.latents, b.latents)
        assert a.batch_corrected_elems == b.batch_corrected_elems > 0
    assert previews == 2 * len(SEEDS)
    st = eng.offload_store.stats
    cfg = configs.get_config(arch, smoke=True)
    if cfg.family == "unet":
        spec = unet.drift_store_spec(cfg, 2)
    else:
        from repro_torch.models import dit
        spec = dit.drift_store_spec(cfg, 2)
    # the whole store, tile-padded as the repacked layout holds it
    nbytes = layout.store_nbytes(layout.pack_store(spec, 32, 32))
    assert st.commits == 2 and st.bytes_offloaded == 2 * nbytes
