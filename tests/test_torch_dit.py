"""The port's DiT against the JAX package's, on the 3-layer SMOKE config.

Params come from the reference's init, with the adaLN and final
projections perturbed so the network computes something (adaLN-Zero
predicts eps = 0), carried over by ``params_from_jax``; latents and class
ids are the same numpy arrays on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.exec_ctx import DriftSystemConfig as JCfg
from repro.models import dit as jdit
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.core import dvfs
from repro_torch.core.exec_ctx import DriftSystemConfig
from repro_torch.models import dit

from test_torch_core import JaxReplayFlipSource


def perturbed_jax_params(cfg, seed=0):
    """The reference's init with adaLN/final weights made non-zero, as
    tests/test_diffusion.py does."""
    key = jax.random.PRNGKey(seed)
    p = jsteps.init_model_params(cfg, key)
    p["blocks"]["adaln_w"] = 0.1 * jax.random.normal(
        jax.random.fold_in(key, 1), p["blocks"]["adaln_w"].shape)
    p["final_w"] = 0.2 * jax.random.normal(jax.random.fold_in(key, 2),
                                           p["final_w"].shape)
    p["final_adaln_w"] = 0.1 * jax.random.normal(
        jax.random.fold_in(key, 4), p["final_adaln_w"].shape)
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_config("dit-xl-512", smoke=True)
    np_params = perturbed_jax_params(jcfg)
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([999.0, 500.0], np.float32)
    cond = np.array([1, 7], np.int32)
    return jcfg, np_params, lat, t, cond


def test_config_matches_reference():
    for smoke in (False, True):
        got = configs.get_config("dit-xl-512", smoke=smoke)
        want = jconfigs.get_config("dit-xl-512", smoke=smoke)
        for f in ("n_layers", "d_model", "n_heads", "d_ff", "latent_size",
                  "latent_channels", "patch_size", "num_classes"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.hd == want.hd and got.tokens == (
            want.latent_size // want.patch_size) ** 2
    full = configs.get_config("dit-xl-512")
    assert (full.n_layers, full.d_model, full.hd, full.tokens) == (
        28, 1152, 72, 1024)
    assert full.dtype == torch.bfloat16 and full.param_dtype == torch.float32
    for arch in ("whisper-base", "internvl2-76b"):
        got, want = configs.get_config(arch), jconfigs.get_config(arch)
        for f in dataclasses.fields(got):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_forward_float_matches_jax_f32(setup):
    """Unprotected f32 forward: 2e-5 relative to the eps scale (f32
    summation order differs between XLA and PyTorch)."""
    jcfg, np_params, lat, t, cond = setup
    want, _, _ = jdit.forward(jcfg, jax.tree.map(jnp.asarray, np_params),
                              jnp.asarray(lat), jnp.asarray(t),
                              jnp.asarray(cond))
    cfg = configs.get_config("dit-xl-512", smoke=True)
    got, _ = dit.forward(cfg, dit.params_from_jax(np_params),
                         torch.from_numpy(lat), torch.from_numpy(t),
                         torch.from_numpy(cond).long())
    want = np.asarray(want)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2e-5 * np.abs(want).max(), rtol=0)


def test_forward_float_matches_jax_bf16(setup):
    """A bf16 copy of SMOKE (bf16 activations, as at full width): 3e-2 of
    the eps scale -- bf16 keeps ~3 significant digits, and the two
    frameworks round intermediate bf16 results at different places."""
    jcfg, np_params, lat, t, cond = setup
    jcfg16 = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    want, _, _ = jdit.forward(jcfg16, jax.tree.map(jnp.asarray, np_params),
                              jnp.asarray(lat), jnp.asarray(t),
                              jnp.asarray(cond))
    cfg16 = dataclasses.replace(configs.get_config("dit-xl-512", smoke=True),
                                dtype=torch.bfloat16)
    got, _ = dit.forward(cfg16, dit.params_from_jax(np_params),
                         torch.from_numpy(lat), torch.from_numpy(t),
                         torch.from_numpy(cond).long())
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=3e-2 * np.abs(want).max(), rtol=0)


def test_forward_drift_matches_jax(setup):
    """Drift mode at a BER of 1e-2 with the reference's replayed masks on
    every class: detection counts per site and corrected elements exact,
    eps within 1e-4 of its scale, checkpoints refreshed on step 10."""
    jcfg, np_params, lat, t, cond = setup
    run_key = jax.random.PRNGKey(3)
    step = 10
    ber = np.full((3,), 1e-2, np.float32)
    jembed, jblock = jdit.drift_store_spec(jcfg, 2)

    @jax.jit
    def jax_forward(params, lat, t, cond):
        jds = jdit.DriftState(cfg=JCfg(mode="drift"),
                              key=jax.random.fold_in(run_key, step),
                              step=jnp.int32(step),
                              ber_by_class=jnp.asarray(ber),
                              embed_store=jembed, block_store=jblock,
                              have_ckpt=True)
        eps, new, st = jdit.forward(jcfg, params, lat, t, cond, drift=jds)
        return eps, new.block_store, st

    want, jblock_new, jstats = jax_forward(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(lat),
        jnp.asarray(t), jnp.asarray(cond))

    cfg = configs.get_config("dit-xl-512", smoke=True)
    embed, block = dit.drift_store_spec(cfg, 2)
    for k, v in jembed.items():
        assert tuple(embed[k].shape) == v.shape, k
    for k, v in jblock.items():
        assert tuple(block[k].shape) == v.shape, k
    ds = dit.DriftState(cfg=DriftSystemConfig(mode="drift"),
                        flip_source=JaxReplayFlipSource(run_key), step=step,
                        ber_by_class=ber, embed_store=embed,
                        block_store=block, have_ckpt=True)
    got, stats = dit.forward(cfg, dit.params_from_jax(np_params),
                             torch.from_numpy(lat), torch.from_numpy(t),
                             torch.from_numpy(cond).long(), drift=ds)
    np.testing.assert_array_equal(stats["detected_per_block"].numpy(),
                                  np.asarray(jstats["detected_per_block"]))
    assert int(stats["corrected_elems"]) == int(jstats["corrected_elems"])
    assert int(stats["corrected_elems"]) > 0
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)
    for name in ("attn.q", "mlp.w2"):
        w_ = np.asarray(jblock_new[name])
        np.testing.assert_allclose(block[name].numpy(), w_,
                                   atol=1e-4 * np.abs(w_).max(), rtol=0)


def test_init_params_is_adaln_zero():
    """The port's own init keeps adaLN-Zero: eps is exactly 0."""
    cfg = configs.get_config("dit-xl-512", smoke=True)
    p = dit.init_params(cfg, seed=1)
    assert not p["final_w"].any() and not p["blocks"][0]["adaln_w"].any()
    assert p["blocks"][2]["mlp_w1"].shape == (cfg.d_model, cfg.d_ff)
    assert float(p["patch_w"].abs().max()) <= 2.0 / cfg.patch_dim ** 0.5
    eps, _ = dit.forward(cfg, p, torch.randn(2, 8, 8, 4),
                         torch.tensor([5.0, 6.0]), torch.tensor([0, 3]))
    assert eps.shape == (2, 8, 8, 4) and not eps.any()
    assert dit.init_params(cfg, seed=1)["patch_w"].equal(p["patch_w"])


def test_params_from_jax_unstacks_blocks(setup):
    jcfg, np_params, *_ = setup
    p = dit.params_from_jax(np_params)
    assert len(p["blocks"]) == jcfg.n_layers
    np.testing.assert_array_equal(p["blocks"][1]["attn"]["wk"].numpy(),
                                  np_params["blocks"]["attn"]["wk"][1])
    assert p["class_embed"].dtype == torch.float32
    assert dvfs.CLASS_FIRST_BLOCK == 1
