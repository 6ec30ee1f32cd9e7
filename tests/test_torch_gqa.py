"""The port's GQA language models against the JAX package's: gemma2-9b,
gemma3-27b and glm4-9b at SMOKE.

Attention first: ``full_attention`` and ``mha_flash``'s CPU path (the
kernel's plain version) over GQA ratios, sliding windows and softcaps, and
``decode_attention`` with a binding window. Then each arch's params carried
across by ``params_from_jax``, its prefill logits and KV cache, and one
statistical-ABFT decode step, on 12-token prompts so that the SMOKE window
of 8 binds in prefill and in decode. Then ``ar.decode_batch`` in each mode
with the reference's masks replayed (``JaxReplayFlipSource``), 12 tokens
so that ``pos`` passes the window, the engine against the JAX engine for
gemma2-9b, and the perfmodel with ``==`` at SMOKE and FULL. f32
throughout; inputs from numpy seeds, handed to both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import dvfs as jdvfs
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.perfmodel import energy as jenergy
from repro.perfmodel import flops as jflops
from repro.serving import DriftServeEngine as JaxEngine
from repro.serving import ar as jar
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.core import dvfs
from repro_torch.kernels import flash_attention as tfk
from repro_torch.launch import serve
from repro_torch.models import attention, transformer
from repro_torch.perfmodel import energy, flops
from repro_torch.serving import DriftServeEngine
from repro_torch.serving import ar

from test_torch_core import JaxReplayFlipSource, jax_replay_factory
from test_torch_transformer import lm_jax_params

ARCHS = ("gemma2-9b", "gemma3-27b", "glm4-9b")
PROMPT = 12            # prefill length in the model tests: past window 8
MAX_SEQ = 16
STEPS = 12             # decode_batch: pos runs 8 .. 18, past window 8
WINDOW = 3             # rollback window


# -------------------------------------------------------------- attention
def _qkv(rng, b, s, h, hkv, d, score_scale=1.0):
    q = (rng.standard_normal((b, s, h, d)) * score_scale).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("ratio", [1, 2, 4])
def test_full_attention_and_mha_flash_match_jax(ratio, window, softcap,
                                                causal):
    """(2, 12, 4, 16) queries over 4 / ratio KV heads, f32, within 1e-5.
    Queries are scaled by 40 so that scores reach ~100 and the softcap of
    50 bends them; a window of 5 over 12 tokens masks most keys."""
    rng = np.random.default_rng(ratio * 100 + window + int(softcap))
    q, k, v = _qkv(rng, 2, 12, 4, 4 // ratio, 16, score_scale=40.0)
    want = np.asarray(jattn.full_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window or None, attn_softcap=softcap))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = attention.full_attention(tq, tk, tv, causal=causal,
                                   window=window, attn_softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    n0 = tfk.launches
    flash = tfk.mha_flash(tq, tk, tv, causal=causal, window=window,
                          softcap=softcap)
    assert tfk.launches == n0                  # the plain version on CPU
    np.testing.assert_allclose(flash.numpy(), want, atol=1e-5, rtol=0)
    if softcap:
        uncapped = attention.full_attention(tq, tk, tv, causal=causal,
                                            window=window)
        assert not torch.allclose(uncapped, got, atol=1e-3)


@pytest.mark.parametrize("dtype,softcap,tol", [("float32", 0.0, 1e-6),
                                               ("float32", 50.0, 1e-5),
                                               ("bfloat16", 0.0, 2e-2),
                                               ("bfloat16", 50.0, 2e-2)])
def test_decode_attention_window_matches_jax(dtype, softcap, tol):
    """One token against a (2, 20, 2, 16) cache under 4 query heads at
    pos 15, window 6 (slots 10..15): the reference masks the other slots,
    the port reads only the window. Slots outside it hold 1e4. The olmo
    tolerances of ``test_decode_attention_matches_jax`` (f32 1e-6, bf16
    2e-2); with the softcap f32 is held within 1e-5, since XLA's tanh and
    PyTorch's differ by an ulp or two at scores of ~30 and the softmax
    amplifies it (1.4e-6 seen). NaN outside the window (a rolled-back
    window's) never reaches the output."""
    pos, win = 15, 6
    rng = np.random.default_rng(4)
    q = (rng.standard_normal((2, 1, 4, 16)) * 8).astype(np.float32)
    k = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    for x in (k, v):
        x[:, pos + 1:] = 1e4
        x[:, :pos - win + 1] = 1e4
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in (jq, jk, jv))
    want = jattn.decode_attention(jq, jk, jv, pos=jnp.int32(pos),
                                  window=jnp.int32(win),
                                  attn_softcap=softcap)
    got = attention.decode_attention(tq, tk, tv, pos=pos, window=win,
                                     attn_softcap=softcap)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=0)
    tk[:, :pos - win + 1] = float("nan")
    tv[:, pos + 1:] = float("nan")
    assert torch.isfinite(attention.decode_attention(
        tq, tk, tv, pos=pos, window=win, attn_softcap=softcap)).all()


def test_launch_args_with_fewer_kv_heads():
    """GQA layout: q and o at H heads, k and v at Hkv, each tensor's own
    strides (k and v sliced from one fused (B, S, 2, Hkv, D) projection)."""
    b, s, h, hkv, d = 2, 10, 8, 2, 256
    q = torch.zeros((b, s, h, d), dtype=torch.bfloat16)
    kv = torch.zeros((b, s, 2, hkv, d), dtype=torch.bfloat16)
    k, v = kv[:, :, 0], kv[:, :, 1]
    o = torch.empty_like(q)
    got = tfk.launch_args(q, k, v, o)
    qs = (s * h * d, h * d, d)
    kvs = (s * 2 * hkv * d, 2 * hkv * d, d)
    assert got == (b, s, h, d, qs + kvs + kvs + qs, True)
    # D = 168 rows are 336 bytes: still whole 16-byte chunks.
    y = torch.zeros((b, s, h, 168), dtype=torch.bfloat16)
    z = torch.zeros((b, s, hkv, 168), dtype=torch.bfloat16)
    assert tfk.launch_args(y, z, z, y)[5]


@pytest.mark.parametrize("bad", ["ratio", "head_dim", "window", "softcap",
                                 "length"])
def test_mha_flash_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 2, 16))
    kw = {}
    if bad == "ratio":
        k = torch.zeros((1, 8, 3, 16))
    elif bad == "head_dim":
        q, k = torch.zeros((1, 8, 4, 264)), torch.zeros((1, 8, 2, 264))
    elif bad == "window":
        kw = dict(window=-1)
    elif bad == "softcap":
        kw = dict(softcap=-5.0)
    else:
        k = torch.zeros((1, 9, 2, 16))
    with pytest.raises(ValueError):
        tfk.mha_flash(q, k, k, causal=True, **kw)


# ------------------------------------------------------------------ models
@pytest.fixture(scope="module")
def arch_setup():
    """Per arch: the reference's SMOKE config, its params (numpy, via
    ``lm_jax_params``) and 12-token prompts."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = jconfigs.get_config(arch, smoke=True)
        rng = np.random.default_rng(30 + i)
        prompts = rng.integers(0, jcfg.vocab, (2, PROMPT)).astype(np.int32)
        out[arch] = (jcfg, lm_jax_params(jcfg, seed=i), prompts)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    fields = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "head_dim", "attn_pattern", "window", "norm", "act",
              "tie_embeddings", "rope_theta", "logit_softcap",
              "attn_softcap", "family")
    for smoke in (False, True):
        got = configs.get_config(arch, smoke=smoke)
        want = jconfigs.get_config(arch, smoke=smoke)
        for f in fields:
            assert getattr(got, f) == getattr(want, f), f
        assert got.hd == want.hd and got.kv_heads == want.kv_heads
        assert got.layer_windows() == tuple(want.layer_windows())
        assert str(got.dtype).split(".")[-1] == str(
            jnp.dtype(want.dtype))
        assert transformer.param_count(got) == jtf.param_count(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_gqa_shapes(arch_setup, arch):
    jcfg, np_params, _ = arch_setup[arch]
    cfg = configs.get_config(arch, smoke=True)
    p = transformer.params_from_jax(np_params)
    own = transformer.init_params(cfg, 0)
    assert len(p["layers"]) == len(own["layers"]) == cfg.n_layers
    for i in (0, cfg.n_layers - 1):
        for blk in ("attn", "mlp"):
            for name, w in p["layers"][i][blk].items():
                np.testing.assert_array_equal(
                    w.numpy(), np_params["layers"][blk][name][i])
                assert own["layers"][i][blk][name].shape == w.shape
    hd = cfg.hd
    assert p["layers"][0]["attn"]["wk"].shape == (cfg.d_model,
                                                  cfg.kv_heads * hd)
    assert p["layers"][0]["attn"]["wq"].shape == (cfg.d_model,
                                                  cfg.n_heads * hd)
    assert ("lm_head" in p) == ("lm_head" in own) == (not cfg.tie_embeddings)
    w = transformer.prepare(cfg, p)
    assert (w.lm_head is None) == cfg.tie_embeddings


def _jax_prefill(jcfg, np_params, prompts):
    return jax.jit(lambda p, t: jtf.prefill(jcfg, p, t, MAX_SEQ))(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(prompts))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_stats_decode_match_jax(arch_setup, arch):
    """Prefill logits (B, 12, V) and the K/V cache within 1e-4, then one
    statistical-ABFT decode step at pos 12 (BER 1e-3, layer 0 at 0) with
    the reference's masks: logits within 1e-4, detections and GEMM words
    equal."""
    jcfg, np_params, prompts = arch_setup[arch]
    cfg = configs.get_config(arch, smoke=True)
    jlogits, jcache = _jax_prefill(jcfg, np_params, prompts)
    params = transformer.params_from_jax(np_params)
    logits, cache = transformer.prefill(cfg, params,
                                        torch.from_numpy(prompts).long(),
                                        MAX_SEQ)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
        np.testing.assert_allclose(got[:, :, :PROMPT].numpy(),
                                   np.asarray(want)[:, :, :PROMPT],
                                   atol=1e-4, rtol=0)
    assert cache.pos == int(jcache.pos) == PROMPT

    tok = np.array([[5], [300]], np.int32)
    step = 4
    row = np.array([0.0, 0.0, 1e-3], np.float32)
    run_key = jax.random.PRNGKey(7)

    def jctx(layer_idx):
        return jar.StatAbftContext(
            jax.random.fold_in(jax.random.fold_in(run_key, step),
                               layer_idx),
            jnp.int32(step), jnp.asarray(row), detect=True)
    jlogits, jnew, jstats = jtf.decode_step_stats(
        jcfg, jax.tree.map(jnp.asarray, np_params), jcache,
        jnp.asarray(tok), jctx)
    src = JaxReplayFlipSource(run_key)
    logits, new, stats = transformer.decode_step_stats(
        cfg, params, cache, torch.from_numpy(tok).long(),
        lambda i: ar.StatAbftContext(src, step, i, row, detect=True))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0, equal_nan=True)
    assert int(stats["detected_rows"]) == int(jstats["detected_rows"])
    assert stats["gemm_words"] == float(jstats["gemm_words"])
    assert new.pos == int(jnew.pos) == PROMPT + 1


def test_windows_bind_in_prefill(arch_setup):
    """The SMOKE window changes gemma2-9b's prefill: the same params with
    every layer global give other logits."""
    jcfg, np_params, prompts = arch_setup["gemma2-9b"]
    cfg = configs.get_config("gemma2-9b", smoke=True)
    params = transformer.params_from_jax(np_params)
    tokens = torch.from_numpy(prompts).long()
    windowed, _ = transformer.prefill(cfg, params, tokens, MAX_SEQ)
    glob, _ = transformer.prefill(
        dataclasses.replace(cfg, attn_pattern=("global",)), params, tokens,
        MAX_SEQ)
    assert torch.equal(windowed[:, :8], glob[:, :8])
    assert not torch.allclose(windowed[:, 8:], glob[:, 8:], atol=1e-4)


def test_protected_words_match_reference():
    for arch in ARCHS:
        for smoke in (True, False):
            assert ar.protected_words_per_step(
                configs.get_config(arch, smoke=smoke), 2) == \
                jar.protected_words_per_step(
                    jconfigs.get_config(arch, smoke=smoke), 2)


# ------------------------------------------------------------ decode loop
def _decode_pair(arch_setup, arch, mode):
    jcfg, np_params, prompts12 = arch_setup[arch]
    prompts = prompts12[:, :jar.PROMPT_LEN]
    cfg = configs.get_config(arch, smoke=True)
    run_key = jax.random.fold_in(jax.random.PRNGKey(3), 0)
    sched = (None if mode == "clean"
             else dvfs.fine_grained_schedule(STEPS, dvfs.UNDERVOLT))
    jsched = (None if mode == "clean"
              else jdvfs.fine_grained_schedule(STEPS, jdvfs.UNDERVOLT))
    jf = jar.make_decoder(jcfg, jar.DecodeConfig(STEPS, WINDOW, mode, 3e-3),
                          schedule=jsched)
    want = jar.decode_batch(jf, jax.tree.map(jnp.asarray, np_params),
                            jnp.asarray(prompts), jdvfs.ber_monitor_init(),
                            run_key)
    fns = ar.make_decoder(cfg, ar.DecodeConfig(STEPS, WINDOW, mode, 3e-3),
                          schedule=sched)
    got = ar.decode_batch(fns, transformer.params_from_jax(np_params),
                          torch.from_numpy(prompts).long(),
                          dvfs.ber_monitor_init("cpu"),
                          JaxReplayFlipSource(run_key))
    return got, want


@pytest.mark.parametrize("mode", ["clean", "faulty", "stat_abft"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_batch_matches_jax(arch_setup, arch, mode):
    """12 tokens, rollback window 3, undervolt table: tokens, per-step
    heatmap, detections, rollbacks, evaluations, GEMM words and the
    monitor's ladder index equal to the reference's."""
    got, want = _decode_pair(arch_setup, arch, mode)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.heatmap.numpy(),
                                  np.asarray(want.heatmap))
    assert got.detections == want.detections
    assert got.rollbacks == want.rollbacks
    assert got.n_model_evals == want.n_model_evals
    assert got.n_words == want.n_words
    assert int(got.monitor.op_index) == int(want.monitor.op_index)
    assert got.tokens.shape == (2, STEPS)
    if mode == "stat_abft":
        assert got.detections > 0 and got.rollbacks >= 1
        assert got.n_model_evals > STEPS
    else:
        assert got.rollbacks == 0


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def jax_engine_run(arch_setup):
    """One reference engine run: 2 gemma2-9b-smoke requests in stat_abft
    at undervolt, 12 tokens, window 3 (plus its clean reference)."""
    _, np_params, _ = arch_setup["gemma2-9b"]
    eng = JaxEngine(bucket=2, base_seed=0)
    eng._params[("gemma2-9b", True)] = jax.tree.map(jnp.asarray, np_params)
    for s in (0, 1):
        eng.submit(arch="gemma2-9b", steps=STEPS, mode="stat_abft",
                   op="undervolt", seed=s, rollback_interval=WINDOW)
    return eng.run()


def test_engine_matches_jax_engine(arch_setup, jax_engine_run):
    """The port's engine on the CPU through its CLI against the reference
    engine, gemma2-9b-smoke: tokens, token match, detections, rollbacks,
    evaluations and heatmaps equal, and the perfmodel attribution with
    ==."""
    jcfg, np_params, _ = arch_setup["gemma2-9b"]
    prompts = np.asarray(jar.prompt_tokens(jcfg, [0, 1]))
    eng = DriftServeEngine(arch="gemma2-9b", smoke=True, bucket=2,
                           base_seed=0, device="cpu",
                           flip_source_factory=jax_replay_factory(0))
    eng.set_params("gemma2-9b", True, transformer.params_from_jax(np_params))
    eng.servable_for("gemma2-9b").batch_inputs = lambda cfg, seeds: (
        torch.from_numpy(prompts).long(),)
    got = serve.main(["--arch", "gemma2-9b", "--steps", str(STEPS),
                      "--requests", "2", "--rollback-interval", str(WINDOW),
                      "--device", "cpu"], engine=eng)
    want = jax_engine_run
    assert [r.mode for r in got] == ["stat_abft", "stat_abft"]
    for g, w in zip(got, want):
        assert g.tokens == w.tokens and len(g.tokens) == STEPS
        assert g.token_match_vs_clean == w.token_match_vs_clean == 1.0
        assert g.ar_detections == w.ar_detections > 0
        assert g.ar_rollbacks == w.ar_rollbacks >= 1
        assert g.n_model_evals == w.n_model_evals > STEPS
        assert g.monitor_op_index == w.monitor_op_index
        assert g.detect_heatmap == w.detect_heatmap
        for f in ("energy_j", "baseline_energy_j", "latency_s",
                  "baseline_latency_s", "completed_at_s"):
            assert getattr(g, f) == getattr(w, f), f
        assert g.energy_breakdown == w.energy_breakdown
        assert energy.ledger_total(g.energy_breakdown) == g.energy_j


# --------------------------------------------------------------- perfmodel
@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_perfmodel_matches_reference(arch, smoke):
    """Every dense term with ==: parameters, MACs and DRAM bytes per
    evaluation, the window-clipped cell FLOPs of every shape cell, and
    ``run_cost`` / ``per_request_cost`` at undervolt with and without
    ABFT and with replays."""
    cfg = configs.get_config(arch, smoke=smoke)
    jcfg = jconfigs.get_config(arch, smoke=smoke)
    assert flops.active_params(cfg) == jflops.active_params(jcfg)
    for batch in (1, 2):
        assert flops.gemm_macs_per_model_eval(cfg, batch) == \
            jflops.gemm_macs_per_model_eval(jcfg, batch)
        assert energy.dram_bytes_per_eval(cfg, batch) == \
            jenergy.dram_bytes_per_eval(jcfg, batch)
        assert energy.activation_bytes(cfg, batch) == \
            jenergy.activation_bytes(jcfg, batch)
    from repro.configs import shapes as jshapes
    assert shapes.cells_for(arch) == tuple(jshapes.cells_for(arch))
    for cell in shapes.cells_for(arch):
        assert flops.cell_flops(cfg, shapes.LM_SHAPES[cell]) == \
            jflops.cell_flops(jcfg, jshapes.LM_SHAPES[cell])
    em, jem = energy.calibrate(), jenergy.calibrate()
    for abft, replay in ((True, 0), (True, 7), (False, 0)):
        kw = dict(num_steps=STEPS + 7, nominal_steps=2, abft_enabled=abft,
                  ckpt_interval=WINDOW if abft else 10 ** 9,
                  taylorseer_interval=0, recovery_tiles_per_step=0.0,
                  replay_evals=replay)
        rc = energy.RunConfig(aggressive=dvfs.UNDERVOLT, **kw)
        jrc = jenergy.RunConfig(aggressive=jdvfs.UNDERVOLT, **kw)
        got = energy.run_cost(cfg, rc, batch=2, em=em)
        want = jenergy.run_cost(jcfg, jrc, batch=2, em=jem)
        assert got == want
        got = energy.per_request_cost(cfg, rc, 2, n_live=2, em=em)
        want = jenergy.per_request_cost(jcfg, jrc, 2, n_live=2, em=jem)
        assert got == want
