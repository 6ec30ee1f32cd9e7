"""The port's SSD blocks (``models.mamba2``) and the SSM language model
mamba2-370m against the JAX package's, at SMOKE.

The block first: ``_causal_conv`` (zero-padded and with a tail),
``_gated_norm``, ``ssd_forward`` at S = 21 against a chunk of 8 (three
chunks, the last padded by 3, so the inter-chunk recurrence and the
padding both run), ``ssd_decode_step`` from a random state, each output
and returned state within 1e-5 of the reference's (f32). Then the SSD
duality on the port alone: a prefill of 13 tokens followed by 8 decode
steps gives what ``ssd_forward`` gives for all 21 tokens, within 1e-5.
Then the whole model: config and parameter count, ``params_from_jax``,
``init_weights`` against ``prepare(init_params(...))`` (the SSD blocks'
small leaves kept in ``param_dtype``), prefill logits over two chunks,
decode steps, ``ar.decode_batch`` in each mode and the engine against the
JAX engine (no protected word: no detection, no rollback, BER 0), and the
perfmodel with ``==``. Inputs from numpy seeds, handed to both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import dvfs as jdvfs
from repro.models import mamba2 as jm2
from repro.models import transformer as jtf
from repro.perfmodel import energy as jenergy
from repro.perfmodel import flops as jflops
from repro.serving import DriftServeEngine as JaxEngine
from repro.serving import ar as jar
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.core import dvfs
from repro_torch.launch import serve
from repro_torch.models import mamba2, transformer
from repro_torch.perfmodel import energy, flops
from repro_torch.serving import DriftServeEngine
from repro_torch.serving import ar

from test_torch_core import JaxReplayFlipSource, jax_replay_factory
from test_torch_moe import weight_leaves

ARCH = "mamba2-370m"
SSM_ARCHS = ("mamba2-370m", "hymba-1.5b")
TOL = 1e-5             # f32 SSD outputs and states
PROMPT = 12            # prefill length in the model tests: two chunks of 8
MAX_SEQ = 16
STEPS = 12             # decode_batch tokens
WINDOW = 3             # rollback window


def ssm_jax_params(cfg, seed=0):
    """The reference's init, embedding x0.05 and each SSD ``out_proj`` x4
    (and, for hybrid layers, ``wo`` and ``w_down`` x4, as
    ``test_torch_transformer.lm_jax_params`` scales the dense LM), so
    that greedy decoding does not repeat one token."""
    p = jsteps.init_model_params(cfg, jax.random.PRNGKey(seed))
    p["embed"] = p["embed"] * 0.05
    layers = p["layers"]
    layers["ssm"]["out_proj"] = layers["ssm"]["out_proj"] * 4.0
    if "attn" in layers:
        layers["attn"]["wo"] = layers["attn"]["wo"] * 4.0
        layers["mlp"]["w_down"] = layers["mlp"]["w_down"] * 4.0
    return jax.tree.map(np.asarray, p)


def block_params(arch, seed):
    """One SSD block's params from the reference's init, every leaf moved
    by a seeded N(0, 0.1) so that the conv bias and the norm scale are
    not zero: (numpy dict, torch dict)."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    jp = jax.tree.map(np.asarray, jm2.init_ssm_params(
        jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    jp = {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
          for k, v in jp.items()}
    return jp, {k: torch.from_numpy(v.copy()) for k, v in jp.items()}


def _jp(np_params):
    return jax.tree.map(jnp.asarray, np_params)


# ----------------------------------------------------------------- block
@pytest.mark.parametrize("tail", [False, True])
def test_causal_conv_matches_jax(tail):
    """(2, 11, 40) through a width-4 depthwise conv, from zeros or from a
    (2, 3, 40) tail, within 1e-6."""
    rng = np.random.default_rng(1 + tail)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 11, 40), (4, 40), (40,)))
    t = rng.standard_normal((2, 3, 40)).astype(np.float32) if tail else None
    want = jm2._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            None if t is None else jnp.asarray(t))
    got = mamba2._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b),
                              None if t is None else torch.from_numpy(t))
    assert got.shape == (2, 11, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_gated_norm_matches_jax():
    """``y * silu(z)`` normalized with eps 1e-6 and scaled by ``1 +
    scale``, within 1e-6."""
    rng = np.random.default_rng(3)
    y, z = (rng.standard_normal((2, 5, 32)).astype(np.float32)
            for _ in range(2))
    scale = (0.1 * rng.standard_normal(32)).astype(np.float32)
    want = jm2._gated_norm(jnp.asarray(y), jnp.asarray(z), jnp.asarray(scale))
    got = mamba2._gated_norm(torch.from_numpy(y), torch.from_numpy(z),
                             torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssd_forward_matches_jax(arch):
    """S = 21 against the SMOKE chunk of 8: three chunks, the last padded
    by 3. Output, final ``h`` and conv tail within 1e-5."""
    cfg = configs.get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    assert cfg.ssm_chunk == 8 and (-21) % cfg.ssm_chunk == 3
    jp, p = block_params(arch, 5)
    x = np.random.default_rng(6).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32)
    want, wst = jm2.ssd_forward(jcfg, _jp(jp), jnp.asarray(x),
                                return_state=True)
    got, st = mamba2.ssd_forward(cfg, p, torch.from_numpy(x),
                                 return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(st.h.numpy(), np.asarray(wst.h), atol=TOL,
                               rtol=0)
    np.testing.assert_array_equal(st.conv.numpy(), np.asarray(wst.conv))
    assert st.h.shape == (2, cfg.ssm_groups, cfg.ssm_heads, cfg.ssm_state,
                          cfg.ssm_head_dim)
    assert mamba2.ssd_forward(cfg, p, torch.from_numpy(x))[1] is None


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssd_decode_step_matches_jax(arch):
    """One token from a random state: output, new ``h`` and new conv tail
    within 1e-5; the state handed in is left as it was."""
    cfg = configs.get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    jp, p = block_params(arch, 7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    zero = mamba2.init_ssm_state(cfg, 2)
    h = rng.standard_normal(tuple(zero.h.shape)).astype(np.float32)
    conv = rng.standard_normal(tuple(zero.conv.shape)).astype(np.float32)
    want, wst = jm2.ssd_decode_step(
        jcfg, _jp(jp), jnp.asarray(x),
        jm2.SsmState(h=jnp.asarray(h), conv=jnp.asarray(conv)))
    state = mamba2.SsmState(h=torch.from_numpy(h.copy()),
                            conv=torch.from_numpy(conv.copy()))
    got, st = mamba2.ssd_decode_step(cfg, p, torch.from_numpy(x), state)
    for g, w in ((got, want), (st.h, wst.h), (st.conv, wst.conv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0)
    np.testing.assert_array_equal(state.h.numpy(), h)
    np.testing.assert_array_equal(state.conv.numpy(), conv)
    zj = jm2.init_ssm_state(jcfg, 2)
    assert zero.h.shape == zj.h.shape and zero.conv.shape == zj.conv.shape
    assert zero.h.dtype == torch.float32


@pytest.mark.parametrize("split", [5, 13])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_then_decode_equals_ssd_forward(arch, split):
    """The SSD duality: ``split`` tokens through ``ssd_forward`` and the
    rest one at a time through ``ssd_decode_step`` give the outputs and
    final state of ``ssd_forward`` over all 21, within 1e-5."""
    cfg = configs.get_config(arch, smoke=True)
    _, p = block_params(arch, 9)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32))
    want, wst = mamba2.ssd_forward(cfg, p, x, return_state=True)
    outs, st = [], None
    head, st = mamba2.ssd_forward(cfg, p, x[:, :split], return_state=True)
    outs.append(head)
    for t in range(split, 21):
        y, st = mamba2.ssd_decode_step(cfg, p, x[:, t:t + 1], st)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, dim=1), want, atol=TOL,
                               rtol=0)
    torch.testing.assert_close(st.h, wst.h, atol=TOL, rtol=0)
    torch.testing.assert_close(st.conv, wst.conv, atol=TOL, rtol=0)


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    prompts = np.random.default_rng(40).integers(
        0, jcfg.vocab, (2, PROMPT)).astype(np.int32)
    return jcfg, ssm_jax_params(jcfg, seed=10), prompts


SSM_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "head_dim", "attn_pattern", "global_layer_indices",
              "window", "norm", "act", "tie_embeddings", "rope_theta",
              "family", "ssm_state", "ssm_expand", "ssm_head_dim",
              "ssm_chunk", "ssm_conv_width", "ssm_groups")


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_config_and_param_count_match_reference(arch):
    """FULL and SMOKE field for field, SMOKE in f32, and the parameter
    count of the reference's formula: mamba2-370m 367.6 M, hymba-1.5b
    1.589 B."""
    for smoke in (False, True):
        got = configs.get_config(arch, smoke=smoke)
        want = jconfigs.get_config(arch, smoke=smoke)
        for f in SSM_FIELDS:
            assert getattr(got, f) == getattr(want, f), f
        assert (got.ssm_heads, got.d_inner) == (want.ssm_heads,
                                                want.d_inner)
        assert got.layer_kinds() == tuple(want.layer_kinds())
        assert got.layer_windows() == tuple(want.layer_windows())
        for ours, theirs in ((got.dtype, want.dtype),
                             (got.param_dtype, want.param_dtype)):
            assert str(ours).split(".")[-1] == str(jnp.dtype(theirs))
        assert transformer.param_count(got) == jtf.param_count(want)
        assert mamba2.conv_channels(got) == jm2.conv_channels(want)
    n = transformer.param_count(configs.get_config(arch))
    assert {"mamba2-370m": round(n / 1e6, 1),
            "hymba-1.5b": round(n / 1e9, 3)}[arch] == \
        {"mamba2-370m": 367.6, "hymba-1.5b": 1.589}[arch]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_params_from_jax_carries_ssm_shapes(arch):
    """The (L, ...) ``ssm`` subtree unstacks per layer at the shapes of the
    port's own init (an SSM layer has only ``ln1`` and ``ssm``; a hybrid
    layer also the attention, the MLP and the two scalar mixes)."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    np_params = ssm_jax_params(jcfg, seed=1)
    p = transformer.params_from_jax(np_params)
    own = transformer.init_params(cfg, 0)
    assert len(p["layers"]) == len(own["layers"]) == cfg.n_layers
    for i in (0, cfg.n_layers - 1):
        assert sorted(p["layers"][i]) == sorted(own["layers"][i])
        for name, w in p["layers"][i]["ssm"].items():
            np.testing.assert_array_equal(
                w.numpy(), np_params["layers"]["ssm"][name][i])
            mine = own["layers"][i]["ssm"][name]
            assert mine.shape == w.shape and mine.dtype == w.dtype, name
    keys = {"ssm": ["ln1", "ssm"],
            "hybrid": ["attn", "ln1", "ln2", "mix_attn", "mix_ssm", "mlp",
                       "ssm"]}[cfg.family]
    assert sorted(own["layers"][0]) == keys
    if cfg.family == "hybrid":
        assert own["layers"][0]["mix_attn"].shape == ()


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_init_weights_equals_prepared_init_params(arch):
    """``init_weights`` bit-equal, leaf for leaf and dtype for dtype, to
    ``prepare(init_params(...))`` for a bf16 SMOKE config: the SSD blocks'
    ``in_proj`` and ``out_proj`` in bf16 with no sums, their ``A_log``,
    ``D`` and ``dt_bias`` in f32 and their conv weight and bias and norm
    scale in ``param_dtype`` (f32); the projection count is
    ``param_count``'s."""
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              dtype=torch.bfloat16)
    want = weight_leaves(transformer.prepare(
        cfg, transformer.init_params(cfg, 11)))
    got = weight_leaves(transformer.init_weights(cfg, 11))
    assert sorted(got) == sorted(want)
    small = ("A_log", "D", "dt_bias", "conv_w", "conv_b", "norm_scale")
    for k, g in got.items():
        assert g.dtype == want[k].dtype and torch.equal(g, want[k]), k
        leaf = k.split(".")[-1]
        if ".ssm." in k:
            assert g.dtype == (torch.float32 if leaf in small
                               else torch.bfloat16), k
            assert leaf in small + transformer.SSM_PROJ, k
    n = sum(t.numel() for k, t in got.items()
            if not k.endswith("sum") and ".ln" not in k
            and not k.startswith("final_norm") and "mix_" not in k
            and k.split(".")[-1] not in small)
    assert n == transformer.param_count(cfg)


def test_protected_words_match_reference():
    """None for the SSM family; the hybrid one protects attention and MLP,
    as the dense family."""
    for arch in SSM_ARCHS:
        for smoke in (True, False):
            cfg = configs.get_config(arch, smoke=smoke)
            assert ar.protected_words_per_step(cfg, 2) == \
                jar.protected_words_per_step(
                    jconfigs.get_config(arch, smoke=smoke), 2)
    assert ar.protected_words_per_step(configs.get_config(ARCH), 2) == 0


def test_prefill_and_decode_match_jax(setup):
    """Prefill logits (B, 12, V) over two chunks (the second padded by 4)
    and each layer's state within 1e-4, then 3 clean decode steps: logits
    and states within 1e-4. The cache holds no KV for the SSM family."""
    jcfg, np_params, prompts = setup
    cfg = configs.get_config(ARCH, smoke=True)
    jp = _jp(np_params)
    jlogits, jcache = jax.jit(lambda p, t: jtf.prefill(jcfg, p, t, MAX_SEQ))(
        jp, jnp.asarray(prompts))
    params = transformer.params_from_jax(np_params)
    logits, cache = transformer.prefill(cfg, params,
                                        torch.from_numpy(prompts).long(),
                                        MAX_SEQ)
    assert cache.k is None and cache.v is None and jcache.k is None
    assert cache.pos == int(jcache.pos) == PROMPT

    def check(lg, jlg, c, jc):
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=0)
        for i, st in enumerate(c.ssm):
            np.testing.assert_allclose(st.h.numpy(), np.asarray(jc.ssm.h[i]),
                                       atol=1e-4, rtol=0)
            np.testing.assert_allclose(st.conv.numpy(),
                                       np.asarray(jc.ssm.conv[i]),
                                       atol=1e-4, rtol=0)
    check(logits, jlogits, cache, jcache)
    step = jax.jit(lambda p, c, t: jtf.decode_step(jcfg, p, c, t))
    for tok in ([[5], [300]], [[7], [7]], [[511], [0]]):
        tok = np.array(tok, np.int32)
        jlogits, jcache, _ = step(jp, jcache, jnp.asarray(tok))
        logits, cache, _ = transformer.decode_step(
            cfg, params, cache, torch.from_numpy(tok).long())
        check(logits, jlogits, cache, jcache)
    assert cache.pos == int(jcache.pos) == PROMPT + 3


def decode_pair(arch, np_params, prompts12, mode):
    """``ar.decode_batch`` and the reference's on the same params, prompts
    and masks: 12 tokens, window 3, undervolt (none when clean)."""
    prompts = prompts12[:, :jar.PROMPT_LEN]
    cfg = configs.get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    run_key = jax.random.fold_in(jax.random.PRNGKey(3), 0)
    sched = (None if mode == "clean"
             else dvfs.fine_grained_schedule(STEPS, dvfs.UNDERVOLT))
    jsched = (None if mode == "clean"
              else jdvfs.fine_grained_schedule(STEPS, jdvfs.UNDERVOLT))
    jf = jar.make_decoder(jcfg, jar.DecodeConfig(STEPS, WINDOW, mode, 3e-3),
                          schedule=jsched)
    want = jar.decode_batch(jf, _jp(np_params), jnp.asarray(prompts),
                            jdvfs.ber_monitor_init(), run_key)
    fns = ar.make_decoder(cfg, ar.DecodeConfig(STEPS, WINDOW, mode, 3e-3),
                          schedule=sched)
    got = ar.decode_batch(fns, transformer.params_from_jax(np_params),
                          torch.from_numpy(prompts).long(),
                          dvfs.ber_monitor_init("cpu"),
                          JaxReplayFlipSource(run_key))
    return got, want


def assert_decode_equal(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.heatmap.numpy(),
                                  np.asarray(want.heatmap))
    assert got.detections == want.detections
    assert got.rollbacks == want.rollbacks
    assert got.n_model_evals == want.n_model_evals
    assert got.n_words == want.n_words
    assert int(got.monitor.op_index) == int(want.monitor.op_index)
    # within two f32 ulps: XLA folds the EMA's division into a constant
    # and contracts its update into an fma
    np.testing.assert_array_max_ulp(got.monitor.ema_ber.numpy(),
                                    np.asarray(want.monitor.ema_ber), 2)
    assert got.tokens.shape == (2, STEPS)


@pytest.mark.parametrize("mode", ["clean", "faulty", "stat_abft"])
def test_decode_batch_matches_jax(setup, mode):
    """12 tokens, rollback window 3, undervolt table: tokens, heatmap,
    detections (none), rollbacks (none), evaluations (one a token), GEMM
    words (none) and the monitor equal to the reference's; every mode's
    tokens are the clean ones, since nothing is injected."""
    _, np_params, prompts = setup
    got, want = decode_pair(ARCH, np_params, prompts, mode)
    assert_decode_equal(got, want)
    assert got.detections == 0 and got.rollbacks == 0 and got.n_words == 0
    assert got.n_model_evals == STEPS
    clean, _ = decode_pair(ARCH, np_params, prompts, "clean")
    assert torch.equal(got.tokens, clean.tokens)
    assert len(set(got.tokens[0].tolist())) > STEPS // 2


def test_engine_matches_jax_engine(setup):
    """The port's engine through its CLI against the reference engine, 2
    requests in stat_abft at undervolt: tokens, match 1.0, no detection
    or rollback, 12 evaluations, the monitor at BER 0 and ladder 0, the
    heatmaps and the perfmodel attribution with ==; the telemetry
    exposition holds no NaN."""
    jcfg, np_params, _ = setup
    prompts = np.array(jar.prompt_tokens(jcfg, [0, 1]))
    jeng = JaxEngine(bucket=2, base_seed=0)
    jeng._params[(ARCH, True)] = _jp(np_params)
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
    for g, w in zip(got, want):
        assert g.tokens == w.tokens and len(g.tokens) == STEPS
        assert g.token_match_vs_clean == w.token_match_vs_clean == 1.0
        assert g.ar_detections == w.ar_detections == 0
        assert g.ar_rollbacks == w.ar_rollbacks == 0
        assert g.n_model_evals == w.n_model_evals == STEPS
        assert g.monitor_ber == w.monitor_ber == 0.0
        assert g.monitor_op_index == w.monitor_op_index == 0
        assert g.detect_heatmap == w.detect_heatmap
        for f in ("energy_j", "baseline_energy_j", "latency_s",
                  "baseline_latency_s", "completed_at_s"):
            assert getattr(g, f) == getattr(w, f), f
        assert g.energy_breakdown == w.energy_breakdown
        assert energy.ledger_total(g.energy_breakdown) == g.energy_j
    text = eng.telemetry.registry.expose()
    assert "nan" not in text.lower() and "drift_" in text
    assert "nan" not in jeng.telemetry.registry.expose().lower()


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_perfmodel_matches_reference(arch, smoke):
    """The SSD terms with ==: active parameters, MACs and DRAM bytes per
    evaluation, the protected activation bytes (none for the SSM family),
    the cell FLOPs of every shape cell (long_500k included), and
    ``run_cost`` / ``per_request_cost`` at undervolt with and without ABFT
    and with replays."""
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
    for seq in (1, 7, 8, 21, 4096):
        assert flops._ssd_flops(cfg, 2, seq) == jflops._ssd_flops(jcfg, 2,
                                                                  seq)
    from repro.configs import shapes as jshapes
    assert shapes.cells_for(arch) == tuple(jshapes.cells_for(arch))
    assert "long_500k" in shapes.cells_for(arch)
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
        assert energy.run_cost(cfg, rc, batch=2, em=em) == \
            jenergy.run_cost(jcfg, jrc, batch=2, em=jem)
        assert energy.per_request_cost(cfg, rc, 2, n_live=2, em=em) == \
            jenergy.per_request_cost(jcfg, jrc, 2, n_live=2, em=jem)
