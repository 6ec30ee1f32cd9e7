"""The port's hybrid language model hymba-1.5b (attention and an SSD block
side by side in every layer) against the JAX package's, at SMOKE, and the
reference's chunked attention.

The layer pattern first: sliding windows on every layer but the forced
global ones. Then prefill logits, the KV cache and the SSM states, one
statistical-ABFT decode step with the reference's masks, ``ar.decode_batch``
in each mode and the engine against the JAX engine (detections,
rollbacks, evaluations and joules equal). Then the rollback of the SSM
state: each replayed window's tokens are the reference's, and the state
after each replay is the clean decode's bit for bit, while the faulted
pass had moved it. Last, ``chunked_attention`` and ``attention_any``
against the reference's with GQA, windows and the softcap at small
chunks. f32; inputs from numpy seeds, handed to both sides.
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
from repro.serving import DriftServeEngine as JaxEngine
from repro.serving import ar as jar
from repro_torch import configs
from repro_torch.core import dvfs
from repro_torch.launch import serve
from repro_torch.models import attention, transformer
from repro_torch.perfmodel import energy
from repro_torch.serving import DriftServeEngine
from repro_torch.serving import ar

from test_torch_core import JaxReplayFlipSource, jax_replay_factory
from test_torch_mamba2 import assert_decode_equal, decode_pair, ssm_jax_params

ARCH = "hymba-1.5b"
PROMPT = 12            # prefill length: past the SMOKE window and chunk of 8
MAX_SEQ = 16
STEPS = 12             # decode_batch tokens
WINDOW = 3             # rollback window


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    prompts = np.random.default_rng(41).integers(
        0, jcfg.vocab, (2, PROMPT)).astype(np.int32)
    return jcfg, ssm_jax_params(jcfg, seed=11), prompts


def test_global_layers_override_the_pattern():
    """hymba's ``("local",)`` pattern with layers 0, 15 and 31 forced
    global: 29 windows of 1024; SMOKE: layers 0 and 2 global, 1 local."""
    full = configs.get_config(ARCH)
    wins = full.layer_windows()
    assert [i for i, w in enumerate(wins) if w == 0] == [0, 15, 31]
    assert set(wins) == {0, 1024} and wins.count(1024) == 29
    assert configs.get_config(ARCH, smoke=True).layer_windows() == (0, 8, 0)
    assert (full.n_heads, full.kv_heads, full.hd) == (25, 5, 64)


def test_prefill_and_stats_decode_match_jax(setup):
    """Prefill logits (B, 12, V), K/V and SSM states within 1e-4; then one
    statistical-ABFT decode step at pos 12 (BER 1e-3, layer 0 at 0) with
    the reference's masks: logits and states within 1e-4, detections and
    GEMM words (attention and MLP only) equal."""
    jcfg, np_params, prompts = setup
    cfg = configs.get_config(ARCH, smoke=True)
    jp = jax.tree.map(jnp.asarray, np_params)
    jlogits, jcache = jax.jit(lambda p, t: jtf.prefill(jcfg, p, t, MAX_SEQ))(
        jp, jnp.asarray(prompts))
    params = transformer.params_from_jax(np_params)
    logits, cache = transformer.prefill(cfg, params,
                                        torch.from_numpy(prompts).long(),
                                        MAX_SEQ)

    def check(lg, jlg, c, jc, upto):
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=0, equal_nan=True)
        for got, want in ((c.k, jc.k), (c.v, jc.v)):
            np.testing.assert_allclose(got[:, :, :upto].numpy(),
                                       np.asarray(want)[:, :, :upto],
                                       atol=1e-4, rtol=0)
        for i, st in enumerate(c.ssm):
            np.testing.assert_allclose(st.h.numpy(), np.asarray(jc.ssm.h[i]),
                                       atol=1e-4, rtol=0)
            np.testing.assert_allclose(st.conv.numpy(),
                                       np.asarray(jc.ssm.conv[i]),
                                       atol=1e-4, rtol=0)
    check(logits, jlogits, cache, jcache, PROMPT)
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
    jlogits, jnew, jstats = jtf.decode_step_stats(jcfg, jp, jcache,
                                                  jnp.asarray(tok), jctx)
    src = JaxReplayFlipSource(run_key)
    logits, new, stats = transformer.decode_step_stats(
        cfg, params, cache, torch.from_numpy(tok).long(),
        lambda i: ar.StatAbftContext(src, step, i, row, detect=True))
    check(logits, jlogits, new, jnew, PROMPT + 1)
    assert int(stats["detected_rows"]) == int(jstats["detected_rows"])
    assert stats["gemm_words"] == float(jstats["gemm_words"]) == \
        ar.protected_words_per_step(cfg, 2)
    assert new.pos == int(jnew.pos) == PROMPT + 1


@pytest.mark.parametrize("mode", ["clean", "faulty", "stat_abft"])
def test_decode_batch_matches_jax(setup, mode):
    """12 tokens, rollback window 3, undervolt table: tokens, heatmap,
    detections, rollbacks, evaluations, GEMM words and the monitor equal
    to the reference's; stat_abft detects and rolls back."""
    _, np_params, prompts = setup
    got, want = decode_pair(ARCH, np_params, prompts, mode)
    assert_decode_equal(got, want)
    if mode == "stat_abft":
        assert got.detections > 0 and got.rollbacks >= 1
        assert got.n_model_evals > STEPS
    else:
        assert got.rollbacks == 0


def _recorded_decode(cfg, params, prompts, mode, run_key):
    """``ar.decode_batch`` with every step's (step index, BER scale, new
    cache) recorded, and the replayed windows: (out, calls, replays)."""
    fns = ar.make_decoder(
        cfg, ar.DecodeConfig(STEPS, WINDOW, mode, 3e-3),
        schedule=(None if mode == "clean"
                  else dvfs.fine_grained_schedule(STEPS, dvfs.UNDERVOLT)))
    calls, replays = [], []

    def step(params, cache, tok, i, monitor, src, scale):
        out = fns.step(params, cache, tok, i, monitor, src, scale)
        calls.append((i, scale, out[1]))
        return out
    out = ar.decode_batch(dataclasses.replace(fns, step=step), params,
                          torch.from_numpy(prompts).long(),
                          dvfs.ber_monitor_init("cpu"),
                          JaxReplayFlipSource(run_key),
                          on_replay=lambda i, n: replays.append((i, n)))
    return out, calls, replays


def test_rollback_restores_the_ssm_state(setup):
    """stat_abft at undervolt rolls back every window here. Each replayed
    window's tokens equal the reference's and the clean decode's, and
    after each replay every layer's SSM state (``h`` and the conv tail)
    is the clean decode's at that step bit for bit; the faulted pass had
    moved ``h`` off it, so a replay from a state that was not restored
    would not match."""
    jcfg, np_params, prompts12 = setup
    prompts = prompts12[:, :jar.PROMPT_LEN]
    cfg = configs.get_config(ARCH, smoke=True)
    params = transformer.params_from_jax(np_params)
    run_key = jax.random.fold_in(jax.random.PRNGKey(3), 0)
    got, calls, replays = _recorded_decode(cfg, params, prompts,
                                           "stat_abft", run_key)
    clean, clean_calls, _ = _recorded_decode(cfg, params, prompts, "clean",
                                             run_key)
    jf = jar.make_decoder(jcfg, jar.DecodeConfig(STEPS, WINDOW, "stat_abft",
                                                 3e-3),
                          schedule=jdvfs.fine_grained_schedule(
                              STEPS, jdvfs.UNDERVOLT))
    want = jar.decode_batch(jf, jax.tree.map(jnp.asarray, np_params),
                            jnp.asarray(prompts), jdvfs.ber_monitor_init(),
                            run_key)
    n_windows = -(-(STEPS - 1) // WINDOW)
    assert got.rollbacks == want.rollbacks == len(replays) == n_windows
    clean_at = {i: c for i, _, c in clean_calls}
    moved = 0
    for start, n in replays:
        span = slice(start, start + n)
        np.testing.assert_array_equal(got.tokens[:, span].numpy(),
                                      np.asarray(want.tokens)[:, span])
        assert torch.equal(got.tokens[:, span], clean.tokens[:, span])
        last = start + n - 1
        (faulted,) = [c for i, s, c in calls if i == last and s == 1.0]
        (replayed,) = [c for i, s, c in calls if i == last and s == 0.0]
        for r, c, f in zip(replayed.ssm, clean_at[last].ssm, faulted.ssm):
            assert torch.equal(r.h, c.h) and torch.equal(r.conv, c.conv)
            moved += not torch.equal(f.h, c.h)
    assert moved > 0


def test_engine_matches_jax_engine(setup):
    """The port's engine through its CLI against the reference engine, 2
    requests in stat_abft at undervolt, 12 tokens, window 3: tokens,
    match 1.0, detections, rollbacks, evaluations, the monitor, heatmaps
    and the perfmodel attribution with ==."""
    jcfg, np_params, _ = setup
    prompts = np.array(jar.prompt_tokens(jcfg, [0, 1]))
    jeng = JaxEngine(bucket=2, base_seed=0)
    jeng._params[(ARCH, True)] = jax.tree.map(jnp.asarray, np_params)
    for s in (0, 1):
        jeng.submit(arch=ARCH, steps=STEPS, mode="stat_abft",
                    op="undervolt", seed=s, rollback_interval=WINDOW)
    want = jeng.run()
    eng = DriftServeEngine(arch=ARCH, smoke=True, bucket=2, base_seed=0,
                           device="cpu",
                           flip_source_factory=jax_replay_factory(0))
    eng.set_params(ARCH, True, transformer.params_from_jax(np_params))
    eng.servable_for(ARCH).batch_inputs = lambda cfg, seeds: (
        torch.from_numpy(prompts).long(),)
    got = serve.main(["--arch", ARCH, "--steps", str(STEPS),
                      "--requests", "2", "--rollback-interval", str(WINDOW),
                      "--device", "cpu"], engine=eng)
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


# ------------------------------------------------------- chunked attention
@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (True, 20, 0.0), (True, 40, 30.0), (False, 24, 0.0),
    (False, 0, 30.0)])
@pytest.mark.parametrize("ratio", [1, 2, 4])
def test_chunked_attention_matches_jax(ratio, causal, window, cap):
    """(2, 64, 4/ratio, 16) in query chunks of 16 and KV chunks of 32, the
    windows binding across chunks and whole KV chunks masked for some
    query chunks: within 1e-5 of the reference's ``chunked_attention``
    and of the port's ``full_attention``, as the GQA tests hold the
    attention (``tanh`` of scores near 30 differs by ulps between XLA and
    PyTorch). Queries scaled by 8 with the softcap of 30, so that scores
    bend."""
    rng = np.random.default_rng(ratio * 31 + window + int(cap))
    q = (rng.standard_normal((2, 64, 4, 16))
         * (8.0 if cap else 1.0)).astype(np.float32)
    k, v = (rng.standard_normal((2, 64, 4 // ratio, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), q_chunk=16, kv_chunk=32,
                                   **kw)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = attention.chunked_attention(tq, tk, tv, q_chunk=16, kv_chunk=32,
                                      **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(got, attention.full_attention(tq, tk, tv,
                                                             **kw),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        attention.chunked_attention(tq[:, :48], tk[:, :48], tv[:, :48],
                                    q_chunk=16, kv_chunk=32, **kw)


@pytest.mark.parametrize("s,chunked", [(64, True), (48, False), (32, False)])
def test_attention_any_dispatches_as_the_reference(s, chunked, monkeypatch):
    """Past the threshold (32 here) and at multiples of both chunks the
    chunked path runs, else ``full_attention``; both sides agree within
    2e-6. The reference's defaults: 4096, chunks of 512 and 1024."""
    assert (attention.CHUNK_THRESHOLD, attention.Q_CHUNK,
            attention.KV_CHUNK) == (4096, 512, 1024)
    rng = np.random.default_rng(s)
    q = rng.standard_normal((1, s, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, s, 2, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=True, window=20, attn_softcap=0.0, chunk_threshold=32,
              q_chunk=16, kv_chunk=32)
    ran = []
    chunked_fn = attention.chunked_attention
    monkeypatch.setattr(attention, "chunked_attention",
                        lambda *a, **k_: ran.append(1) or chunked_fn(*a, **k_))
    want = jattn.attention_any(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **kw)
    got = attention.attention_any(*(torch.from_numpy(a) for a in (q, k, v)),
                                  **kw)
    assert bool(ran) == chunked
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=0)


def test_cpu_prefill_takes_attention_any(monkeypatch):
    """On the CPU the LM prefill's attention goes through
    ``attention_any`` (which chunks past 4096 tokens), with the layer's
    window and the softcap."""
    cfg = configs.get_config(ARCH, smoke=True)
    seen = []
    any_fn = attention.attention_any

    def spy(q, k, v, **kw):
        seen.append((q.shape[1], kw["window"], kw["attn_softcap"]))
        return any_fn(q, k, v, **kw)
    monkeypatch.setattr(attention, "attention_any", spy)
    transformer.prefill(cfg, transformer.init_params(cfg, 2),
                        torch.zeros((1, 12), dtype=torch.long), 16)
    assert seen == [(12, w, 0.0) for w in cfg.layer_windows()]
