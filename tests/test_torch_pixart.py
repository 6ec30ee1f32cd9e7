"""The port's PixArt-alpha against the JAX package's, on the 3-layer SMOKE
config (d = 64, 8 stub text tokens of width 32).

Params come from the reference's init with the adaLN and final
projections perturbed (``perturbed_jax_params``), carried over by
``dit.params_from_jax``; latents, timesteps and the stub text are the same
numpy arrays on both sides, and the flip masks the reference's
(``JaxReplayFlipSource``). The slice test serves 2 requests in drift and 2
in faulty through one reference engine and one port engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.exec_ctx import DriftSystemConfig as JCfg
from repro.models import dit as jdit
from repro.serving import DriftServeEngine as JaxEngine
from repro_torch import configs
from repro_torch.core.exec_ctx import DriftSystemConfig
from repro_torch.diffusion.sampler import detection_rows
from repro_torch.launch import serve
from repro_torch.models import dit
from repro_torch.serving import DriftServeEngine
from repro_torch.serving.servable import paradigm_for

from test_torch_core import JaxReplayFlipSource, jax_replay_factory
from test_torch_dit import perturbed_jax_params
from test_torch_serving import assert_attribution_equal

ARCH = "pixart-alpha"
STEPS = 3
SEEDS = (0, 1)


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    np_params = perturbed_jax_params(jcfg, seed=2)
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([999.0, 500.0], np.float32)
    text = (0.1 * rng.standard_normal((2, 8, 32))).astype(np.float32)
    return jcfg, np_params, lat, t, text


def _port_forward(np_params, lat, t, text, drift=None):
    cfg = configs.get_config(ARCH, smoke=True)
    return dit.forward(cfg, dit.params_from_jax(np_params),
                       torch.from_numpy(lat), torch.from_numpy(t), None,
                       drift=drift, text=torch.from_numpy(text))


def test_config_and_param_count_match_reference():
    for smoke in (False, True):
        got = configs.get_config(ARCH, smoke=smoke)
        want = jconfigs.get_config(ARCH, smoke=smoke)
        for f in ("family", "n_layers", "d_model", "n_heads", "d_ff",
                  "latent_size", "latent_channels", "patch_size",
                  "cond_dim", "cond_tokens", "num_classes"):
            assert getattr(got, f) == getattr(want, f), f
        assert dit.param_count(got) == jdit.param_count(want)
    full = configs.get_config(ARCH)
    assert (full.n_layers, full.d_model, full.cond_tokens, full.cond_dim) \
        == (28, 1152, 120, 4096) and full.dtype == torch.bfloat16
    assert paradigm_for(ARCH) == "diffusion"


def test_params_from_jax_carries_text_and_xattn(setup):
    jcfg, np_params, *_ = setup
    p = dit.params_from_jax(np_params)
    assert "class_embed" not in p
    np.testing.assert_array_equal(p["text_proj"].numpy(),
                                  np_params["text_proj"])
    np.testing.assert_array_equal(p["blocks"][2]["xattn"]["wk"].numpy(),
                                  np_params["blocks"]["xattn"]["wk"][2])
    own = dit.init_params(configs.get_config(ARCH, smoke=True), seed=1)
    assert own["text_proj"].shape == (32, 64)
    assert set(own["blocks"][0]["xattn"]) == {"wq", "wk", "wv", "wo"}


def test_forward_float_matches_jax(setup):
    """Unprotected f32 forward with text: 2e-5 of the eps scale (f32
    summation order differs between XLA and PyTorch)."""
    jcfg, np_params, lat, t, text = setup
    want, _, _ = jdit.forward(jcfg, jax.tree.map(jnp.asarray, np_params),
                              jnp.asarray(lat), jnp.asarray(t), None,
                              text=jnp.asarray(text))
    got, _ = _port_forward(np_params, lat, t, text)
    want = np.asarray(want)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("mode", ["clean", "drift"])
def test_forward_protected_matches_jax(setup, mode):
    """clean (BER 0) and drift at BER 1e-2 on every class with the
    reference's masks: per-site detections and corrected elements exact
    (0 in clean), eps within 1e-4 of its scale, the text and xattn
    checkpoints refreshed on step 10 like the reference's."""
    jcfg, np_params, lat, t, text = setup
    run_key = jax.random.PRNGKey(3)
    step = 10
    ber = np.full((3,), 1e-2 if mode == "drift" else 0.0, np.float32)
    jembed, jblock = jdit.drift_store_spec(jcfg, 2)

    @jax.jit
    def jax_forward(params, lat, t, text):
        jds = jdit.DriftState(cfg=JCfg(mode="drift"),
                              key=jax.random.fold_in(run_key, step),
                              step=jnp.int32(step),
                              ber_by_class=jnp.asarray(ber),
                              embed_store=jembed, block_store=jblock,
                              have_ckpt=True)
        eps, new, st = jdit.forward(jcfg, params, lat, t, None, text=text,
                                    drift=jds)
        return eps, new.embed_store, new.block_store, st

    want, jembed_new, jblock_new, jstats = jax_forward(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(lat),
        jnp.asarray(t), jnp.asarray(text))
    cfg = configs.get_config(ARCH, smoke=True)
    embed, block = dit.drift_store_spec(cfg, 2)
    assert {k: tuple(v.shape) for k, v in embed.items()} == \
        {k: v.shape for k, v in jembed.items()}
    assert {k: tuple(v.shape) for k, v in block.items()} == \
        {k: v.shape for k, v in jblock.items()}
    ds = dit.DriftState(cfg=DriftSystemConfig(mode="drift"),
                        flip_source=JaxReplayFlipSource(run_key), step=step,
                        ber_by_class=ber, embed_store=embed,
                        block_store=block, have_ckpt=True)
    got, stats = _port_forward(np_params, lat, t, text, drift=ds)
    np.testing.assert_array_equal(stats["detected_per_block"].numpy(),
                                  np.asarray(jstats["detected_per_block"]))
    assert int(stats["corrected_elems"]) == int(jstats["corrected_elems"])
    assert (int(stats["corrected_elems"]) > 0) == (mode == "drift")
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)
    for store, jstore, name in ((embed, jembed_new, "text"),
                                (block, jblock_new, "xattn.k"),
                                (block, jblock_new, "xattn.o")):
        w_ = np.asarray(jstore[name])
        np.testing.assert_allclose(store[name].numpy(), w_,
                                   atol=1e-4 * np.abs(w_).max(), rtol=0)


def test_batch_inputs_stub_text():
    """(latents, None, text) with the stub text 0.1 N(0, 1) per seed, the
    same for a seed whatever its batch, and a heatmap row per block."""
    eng = DriftServeEngine(arch=ARCH, smoke=True, device="cpu")
    cfg = configs.get_config(ARCH, smoke=True)
    lat, cond, text = eng.servable.batch_inputs(cfg, [3, 4])
    assert cond is None and lat.shape == (2, 8, 8, 4)
    assert text.shape == (2, cfg.cond_tokens, cfg.cond_dim)
    assert 0.05 < float(text.std()) < 0.15
    _, _, again = eng.servable.batch_inputs(cfg, [4])
    assert torch.equal(again[0], text[1])
    assert detection_rows(cfg) == cfg.n_layers + 1


@pytest.fixture(scope="module")
def jax_run():
    """One reference engine: 2 drift then 2 faulty requests at undervolt
    (2 batches, one shared clean reference)."""
    eng = JaxEngine(arch=ARCH, smoke=True, bucket=2, base_seed=0)
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    np_params = perturbed_jax_params(jcfg, seed=5)
    eng._params[(ARCH, True)] = jax.tree.map(jnp.asarray, np_params)
    lat, _, text = eng.servable_for(ARCH).batch_inputs(jcfg, list(SEEDS))
    for mode in ("drift", "faulty"):
        for s in SEEDS:
            eng.submit(steps=STEPS, mode=mode, op="undervolt", seed=s)
    return np_params, np.asarray(lat), np.asarray(text), eng.run()


def test_slice_matches_jax_engine(jax_run):
    """Per request: corrected elements, evaluations, the monitor's ladder
    index and the perfmodel attribution exact; latents within 1e-4 (f32
    SMOKE; sums in other orders), PSNR within 0.05 dB."""
    np_params, lat, text, want = jax_run
    eng = DriftServeEngine(arch=ARCH, smoke=True, bucket=2, base_seed=0,
                           device="cpu",
                           flip_source_factory=jax_replay_factory(0))
    eng.set_params(ARCH, True, dit.params_from_jax(np_params))
    eng.servable.batch_inputs = lambda cfg, seeds: (
        torch.from_numpy(lat.copy()), None, torch.from_numpy(text.copy()))
    for mode in ("drift", "faulty"):
        for s in SEEDS:
            eng.submit(steps=STEPS, mode=mode, op="undervolt", seed=s)
    got = eng.run()
    assert [g.mode for g in got] == [w.mode for w in want]
    for g, w in zip(got, want):
        assert g.batch_corrected_elems == w.batch_corrected_elems
        assert (g.batch_corrected_elems > 0) == (g.mode == "drift")
        assert g.n_model_evals == w.n_model_evals == STEPS
        assert g.monitor_op_index == w.monitor_op_index
        np.testing.assert_allclose(g.latents.numpy(), np.asarray(w.latents),
                                   atol=1e-4, rtol=0)
        assert abs(g.psnr_vs_clean_db - w.psnr_vs_clean_db) < 0.05
        assert g.psnr_vs_clean_db < 90
        assert_attribution_equal(g, w)
    assert eng.stats.clean_samples_computed == 1


def test_cli_serves_pixart_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out
    assert "pixart-alpha" in out and out.count("perfmodel/request") == 2
    assert all(r.n_model_evals == 3 and r.batch_corrected_elems > 0
               for r in res)
