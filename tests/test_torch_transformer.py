"""The port's dense LM against the JAX package's, on ``olmo-1b-smoke``.

Params come from the reference's init, with the embedding scaled down and
the output projections scaled up so that greedy decoding does not simply
repeat the last token (``lm_jax_params``), carried over by
``params_from_jax``; prompts are the reference's. The norms, RoPE and
activation, decode attention, prefill (logits and KV cache), the clean
decode step and the statistical-ABFT decode step are each held against
the reference on the same numpy inputs, f32 throughout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.serving import ar as jar
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.core import dvfs
from repro_torch.models import attention, common, transformer
from repro_torch.serving import ar

from test_torch_core import JaxReplayFlipSource

ARCH = "olmo-1b"
MAX_SEQ = 12


def lm_jax_params(cfg, seed=0):
    """The reference's init, embedding x0.05 and ``wo``/``w_down`` x4."""
    p = jsteps.init_model_params(cfg, jax.random.PRNGKey(seed))
    p["embed"] = p["embed"] * 0.05
    p["layers"]["attn"]["wo"] = p["layers"]["attn"]["wo"] * 4.0
    p["layers"]["mlp"]["w_down"] = p["layers"]["mlp"]["w_down"] * 4.0
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    cfg = configs.get_config(ARCH, smoke=True)
    np_params = lm_jax_params(jcfg)
    prompts = np.asarray(jar.prompt_tokens(jcfg, [0, 1]))
    return jcfg, cfg, np_params, prompts


def test_config_matches_reference():
    fields = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "attn_pattern", "norm", "act", "tie_embeddings",
              "rope_theta", "logit_softcap", "attn_softcap", "family")
    for smoke in (False, True):
        got = configs.get_config(ARCH, smoke=smoke)
        want = jconfigs.get_config(ARCH, smoke=smoke)
        for f in fields:
            assert getattr(got, f) == getattr(want, f), f
        assert got.hd == want.hd and got.kv_heads == want.kv_heads
    full = configs.get_config(ARCH)
    assert (full.n_layers, full.d_model, full.hd, full.d_ff, full.vocab) == (
        16, 2048, 128, 8192, 50304)
    assert full.dtype == torch.bfloat16
    assert configs.get_config(ARCH, smoke=True).dtype == torch.float32
    for arch in ("whisper-base", "internvl2-76b"):
        for smoke in (False, True):
            got = configs.get_config(arch, smoke=smoke)
            want = jconfigs.get_config(arch, smoke=smoke)
            for f in fields + ("n_encoder_layers", "encoder_seq",
                               "cross_attention", "vis_tokens"):
                assert getattr(got, f) == getattr(want, f), (arch, f)


@pytest.mark.parametrize("op", ["nonparam_ln", "rmsnorm", "rope", "silu",
                                "gelu", "softcap"])
def test_common_ops_match_jax(op):
    """Within 1e-6 absolute plus 1e-6 relative (one f32 ulp of the
    softcap's outputs near 30) on f32 inputs."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    cfg = configs.get_config(ARCH, smoke=True)
    if op == "nonparam_ln":
        want, got = jcommon.apply_norm(jcfg, {}, jx), \
            common.apply_norm(cfg, {}, tx)
    elif op == "rmsnorm":
        s = rng.standard_normal(16).astype(np.float32)
        want = jcommon.rmsnorm(jx, jnp.asarray(s))
        got = common.rmsnorm(tx, torch.from_numpy(s))
    elif op == "rope":
        pos = np.array([0, 3, 7, 11, 40])
        want = jcommon.apply_rope(jx, jnp.asarray(pos), 10000.0)
        got = common.apply_rope(tx, torch.from_numpy(pos), 10000.0)
    elif op in ("silu", "gelu"):
        import dataclasses
        want = jcommon.activation(
            dataclasses.replace(jcfg, act=op), jx)
        got = common.activation(dataclasses.replace(cfg, act=op), tx)
    else:
        want, got = jcommon.softcap(jx * 40, 30.0), common.softcap(tx * 40,
                                                                   30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("dtype,rewind,tol", [("float32", 0, 1e-6),
                                               ("bfloat16", 0, 2e-2),
                                               ("float32", 3, 1e-6)])
def test_decode_attention_matches_jax(dtype, rewind, tol):
    """One token against a (2, 9, 4, 16) cache at pos ``6 - rewind`` (a
    rollback rewinds pos), slots past pos filled with garbage (the
    reference masks them, the port does not read them). f32 within 1e-6;
    bf16 within 2e-2 (bf16 output, p rounded to bf16 on both sides)."""
    pos = 6 - rewind
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    k[:, pos + 1:], v[:, pos + 1:] = 1e4, 1e4
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in (jq, jk, jv))
    want = jattn.decode_attention(jq, jk, jv, pos=jnp.int32(pos))
    got = attention.decode_attention(tq, tk, tv, pos=pos)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=0)
    tk[:, pos + 1:] = float("nan")            # a rolled-back window's NaN
    assert torch.isfinite(attention.decode_attention(tq, tk, tv,
                                                     pos=pos)).all()


def test_params_from_jax_unstacks_layers(setup):
    jcfg, cfg, np_params, _ = setup
    p = transformer.params_from_jax(np_params)
    assert len(p["layers"]) == cfg.n_layers
    for i in (0, cfg.n_layers - 1):
        np.testing.assert_array_equal(p["layers"][i]["mlp"]["w_up"].numpy(),
                                      np_params["layers"]["mlp"]["w_up"][i])
    np.testing.assert_array_equal(p["embed"].numpy(), np_params["embed"])
    own = transformer.init_params(cfg, 0)
    assert {k: v.shape for k, v in own["layers"][1]["attn"].items()} == {
        k: v.shape[1:] for k, v in np_params["layers"]["attn"].items()}
    assert own["embed"].shape == np_params["embed"].shape
    w = transformer.prepare(cfg, p)
    assert transformer.prepare(cfg, w) is w
    proj = w.layers[0]["attn"]["wq"]
    assert proj.w.dtype == cfg.dtype
    torch.testing.assert_close(proj.w_sum, proj.w.float().sum(-1))


def _jax_prefill(jcfg, np_params, prompts):
    return jax.jit(lambda p, t: jtf.prefill(jcfg, p, t, MAX_SEQ))(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(prompts))


def test_prefill_matches_jax(setup):
    """Logits (B, 8, V) and the K/V cache within 1e-4 absolute; the port's
    attention here is the flash kernel's plain version."""
    jcfg, cfg, np_params, prompts = setup
    jlogits, jcache = _jax_prefill(jcfg, np_params, prompts)
    logits, cache = transformer.prefill(
        cfg, transformer.params_from_jax(np_params),
        torch.from_numpy(prompts), MAX_SEQ)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v),
                               atol=1e-4, rtol=0)
    assert cache.pos == int(jcache.pos) == prompts.shape[1]


@pytest.mark.parametrize("with_stats", [False, True])
def test_decode_step_matches_jax(setup, with_stats):
    """One decode step after prefill: logits and the updated cache within
    1e-4 absolute. With stats, each layer runs a statistical-ABFT context
    at BER 1e-3 (layer 0 at 0, the first-block class) with the reference's
    masks: equal detection counts and GEMM words."""
    jcfg, cfg, np_params, prompts = setup
    jparams = jax.tree.map(jnp.asarray, np_params)
    _, jcache = _jax_prefill(jcfg, np_params, prompts)
    params = transformer.params_from_jax(np_params)
    _, cache = transformer.prefill(cfg, params, torch.from_numpy(prompts),
                                   MAX_SEQ)
    tok = np.array([[5], [300]], np.int32)
    step = 4
    row = np.array([0.0, 0.0, 1e-3], np.float32)          # per class
    run_key = jax.random.PRNGKey(7)
    if with_stats:
        def jctx(layer_idx):
            return jar.StatAbftContext(
                jax.random.fold_in(jax.random.fold_in(run_key, step),
                                   layer_idx),
                jnp.int32(step), jnp.asarray(row), detect=True)
        jlogits, jnew, jstats = jtf.decode_step_stats(
            jcfg, jparams, jcache, jnp.asarray(tok), jctx)
        src = JaxReplayFlipSource(run_key)
        logits, new, stats = transformer.decode_step_stats(
            cfg, params, cache, torch.from_numpy(tok).long(),
            lambda i: ar.StatAbftContext(src, step, i, row, detect=True))
        assert int(stats["detected_rows"]) == int(jstats["detected_rows"])
        assert stats["gemm_words"] == float(jstats["gemm_words"])
        assert {s.scope for s in src.calls} == {1, 2}   # layer 0 unfaulted
    else:
        jlogits, jnew, _ = jtf.decode_step(jcfg, jparams, jcache,
                                           jnp.asarray(tok))
        logits, new, _ = transformer.decode_step(
            cfg, params, cache, torch.from_numpy(tok).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0, equal_nan=True)
    p = prompts.shape[1]
    np.testing.assert_allclose(new.k[:, :, :p + 1].numpy(),
                               np.asarray(jnew.k)[:, :, :p + 1], atol=1e-4,
                               rtol=0, equal_nan=True)
    assert new.pos == int(jnew.pos) == p + 1


def test_unported_paths_raise(setup):
    """The teacher-forcing ``forward`` and the VLM's init are ported: the
    forward's logits within 1e-4 of the reference's, the VLM's params
    laid out as the reference's (an untied ``lm_head``); the enc-dec
    family belongs to ``models.encdec``; the windowed decode runs: this
    all-global config does not support it, as in the reference, and on
    its (all-global) mixed cache it gives ``decode_step``'s logits."""
    import dataclasses
    jcfg, cfg, np_params, prompts = setup
    with pytest.raises(ValueError, match="encdec"):
        transformer.init_params(dataclasses.replace(cfg, family="encdec"), 0)
    vlm = dataclasses.replace(cfg, family="vlm", tie_embeddings=False)
    jvlm = dataclasses.replace(jcfg, family="vlm", tie_embeddings=False)
    got = transformer.init_params(vlm, 0)
    want = jax.tree.map(np.asarray, jsteps.init_model_params(
        jvlm, jax.random.PRNGKey(0)))
    assert got["lm_head"].shape == want["lm_head"].shape
    assert sorted(got) == sorted(want)
    logits, aux = transformer.forward(cfg, transformer.params_from_jax(
        np_params), torch.from_numpy(np.array(prompts)).long())
    jlogits, jaux = jtf.forward(jcfg, jax.tree.map(jnp.asarray, np_params),
                                jnp.asarray(prompts))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    assert float(aux) == float(jaux) == 0.0
    params = transformer.init_params(cfg, 0)
    assert not transformer.supports_mixed_decode(cfg)
    assert not jtf.supports_mixed_decode(jcfg)
    tok = torch.zeros((1, 1), dtype=torch.long)
    mixed = transformer.init_mixed_cache(cfg, 1, 4, torch.float32)
    lm, mc = transformer.decode_step_mixed(cfg, params, mixed, tok)
    lf, _, _ = transformer.decode_step(
        cfg, params, transformer.init_cache(cfg, 1, 4, torch.float32), tok)
    torch.testing.assert_close(lm, lf, atol=1e-5, rtol=0)
    assert mc.pos == 1 and mc.k_local.shape[0] == 0
    with pytest.raises(ValueError):
        ar.make_decoder(cfg, ar.DecodeConfig(4, 2, "drift", 3e-3))
    assert dvfs.CLASS_FIRST_BLOCK == 1
