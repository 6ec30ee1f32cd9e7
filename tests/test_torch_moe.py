"""The port's MoE language models against the JAX package's:
deepseek-moe-16b and kimi-k2-1t-a32b at SMOKE, and the bf16-only LM
weights (``transformer.init_weights``) every autoregressive arch serves
on.

``moe_ffn`` first, at T = 16 and at T = 256 with ``capacity_factor`` 0.5,
where assignments drop: the reference's routing integers (``keep``,
``slot``, ``rank``), read off its own ``jnp.where`` and ``jnp.argsort``
calls, bit-equal to ``moe.route``'s, ``y`` within 1e-5 and the aux loss
within 1e-6. Then each arch's config and parameter count, params carried
across by ``params_from_jax``, prefill logits and KV cache, one
statistical-ABFT decode step, ``ar.decode_batch`` in each mode with the
reference's masks replayed, the engine against the JAX engine, and the
perfmodel with ``==`` at SMOKE and FULL. f32 throughout; inputs from numpy
seeds, handed to both sides. Last, ``init_weights`` against
``prepare(init_params(...))`` leaf for leaf in bf16, and the AR servable
holding only those weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import dvfs as jdvfs
from repro.models import moe as jmoe
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
from repro_torch.models import moe, transformer
from repro_torch.perfmodel import energy, flops
from repro_torch.serving import DriftServeEngine
from repro_torch.serving import ar

from test_torch_core import JaxReplayFlipSource, jax_replay_factory

ARCHS = ("deepseek-moe-16b", "kimi-k2-1t-a32b")
PROMPT = 12            # prefill length in the model tests
MAX_SEQ = 16
STEPS = 12             # decode_batch tokens
WINDOW = 3             # rollback window


def moe_jax_params(cfg, seed=0):
    """The reference's init, embedding x0.05 and ``wo`` and every expert
    ``w_down`` x4, as ``test_torch_transformer.lm_jax_params`` scales the
    dense LM, so that greedy decoding does not repeat one token."""
    p = jsteps.init_model_params(cfg, jax.random.PRNGKey(seed))
    p["embed"] = p["embed"] * 0.05
    layers = p["layers"]
    layers["attn"]["wo"] = layers["attn"]["wo"] * 4.0
    layers["moe"]["w_down"] = layers["moe"]["w_down"] * 4.0
    layers["moe"]["shared"]["w_down"] = \
        layers["moe"]["shared"]["w_down"] * 4.0
    return jax.tree.map(np.asarray, p)


# ---------------------------------------------------------------- moe_ffn
class _RecordingJnp:
    """``jax.numpy`` for the reference's MoE module, recording the
    operands of its ``argsort`` (the flat expert ids) and of its first
    ``where`` (``keep``, ``flat_e * capacity + rank``, and the slot it
    returns)."""

    def __init__(self):
        self.argsort_in = []
        self.where_calls = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argsort(self, a, **kw):
        self.argsort_in.append(np.asarray(a))
        return jnp.argsort(a, **kw)

    def where(self, *args):
        out = jnp.where(*args)
        self.where_calls.append((args, out))
        return out


@pytest.mark.parametrize("t,cf", [(16, None), (256, 0.5)])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, t, cf, monkeypatch):
    """Routing integers bit-equal, ``y`` within 1e-5 absolute and the aux
    loss within 1e-6. At T = 256 with capacity factor 0.5 the capacity
    (48 or 32, rounded up to 64) is below some experts' load, so
    assignments drop into slot 0; at T = 16 none drop. Row 3 of ``x`` is
    zero, as a faulted residual that overflows the norm leaves it: its E
    probabilities tie, and both sides take the lowest k expert ids."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    jp = jax.tree.map(np.asarray, jmoe.init_moe_params(
        jcfg, jax.random.PRNGKey(t)))
    x = np.random.default_rng(t).standard_normal(
        (t, cfg.d_model)).astype(np.float32)
    x[3] = 0.0
    rec = _RecordingJnp()
    monkeypatch.setattr(jmoe, "jnp", rec)
    jy, jaux = jmoe.moe_ffn(jcfg, jax.tree.map(jnp.asarray, jp),
                            jnp.asarray(x))
    monkeypatch.undo()
    (flat_e,) = rec.argsort_in
    (keep, e_cap_rank, _), slot = rec.where_calls[0]
    cap = moe.capacity(cfg, t)
    rank = np.asarray(e_cap_rank) - flat_e * cap

    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    tx = torch.from_numpy(x)
    r = moe.route(cfg, p["router"], tx)
    np.testing.assert_array_equal(r.flat_e.numpy(), flat_e)
    k = cfg.top_k
    np.testing.assert_array_equal(r.flat_e[3 * k:4 * k].numpy(),
                                  np.arange(k))
    np.testing.assert_array_equal(r.rank.numpy(), rank)
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(r.slot.numpy(), np.asarray(slot))
    assert r.capacity == cap == 64
    dropped = int((~r.keep).sum())
    assert (dropped > 0) == (cf is not None)
    assert bool((r.slot[~r.keep] == 0).all())

    y, aux = moe.moe_ffn(cfg, p, tx)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    # but for the tied row, the selection had room: the k-th and
    # (k+1)-th probabilities of every token are apart by more than an f32
    # ulp of either
    top = torch.topk(r.probs, k + 1, dim=-1).values
    gaps = top[:, -2] - top[:, -1]
    assert float(gaps[3]) == 0.0
    assert float(torch.cat([gaps[:3], gaps[4:]]).min()) > 2 * float(
        np.finfo(np.float32).eps)


def test_capacity_rounds_up_to_64():
    cfg = configs.get_config("deepseek-moe-16b")
    assert [moe.capacity(cfg, t) for t in (2, 16, 256, 1000)] == [
        64, 64, 64, 128]
    # 1.25 * 1000 * 6 / 64 = 117.19 -> 117 -> 128; 2 tokens -> 0 -> 1 -> 64
    assert moe.capacity(cfg, 100000) == -(-int(1.25 * 100000 * 6 / 64)
                                           // 64) * 64


# ------------------------------------------------------------------ models
@pytest.fixture(scope="module")
def arch_setup():
    """Per arch: the reference's SMOKE config, its params (numpy) and
    12-token prompts."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = jconfigs.get_config(arch, smoke=True)
        rng = np.random.default_rng(40 + i)
        prompts = rng.integers(0, jcfg.vocab, (2, PROMPT)).astype(np.int32)
        out[arch] = (jcfg, moe_jax_params(jcfg, seed=10 + i), prompts)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_count_match_reference(arch):
    fields = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "head_dim", "attn_pattern", "norm", "act",
              "tie_embeddings", "rope_theta", "family", "n_experts",
              "n_shared_experts", "top_k", "capacity_factor")
    for smoke in (False, True):
        got = configs.get_config(arch, smoke=smoke)
        want = jconfigs.get_config(arch, smoke=smoke)
        for f in fields:
            assert getattr(got, f) == getattr(want, f), f
        assert got.hd == want.hd and got.kv_heads == want.kv_heads
        assert got.layer_windows() == tuple(want.layer_windows())
        for ours, theirs in ((got.dtype, want.dtype),
                             (got.param_dtype, want.param_dtype)):
            assert str(ours).split(".")[-1] == str(jnp.dtype(theirs))
        assert moe.moe_param_count(got) == jmoe.moe_param_count(want)
        assert transformer.param_count(got) == jtf.param_count(want)
    if arch == "deepseek-moe-16b":
        assert transformer.param_count(configs.get_config(arch)) == \
            16_879_452_160
    else:
        assert configs.get_config(arch).param_dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_moe_shapes(arch_setup, arch):
    """The (L, ...) ``moe`` subtree unstacks per layer, shared experts
    included, at the shapes of the port's own init; the router stays f32
    in the masters and is cast with the experts by ``prepare``."""
    jcfg, np_params, _ = arch_setup[arch]
    cfg = configs.get_config(arch, smoke=True)
    p = transformer.params_from_jax(np_params)
    own = transformer.init_params(cfg, 0)
    assert len(p["layers"]) == len(own["layers"]) == cfg.n_layers
    for i in (0, cfg.n_layers - 1):
        got, mine = p["layers"][i]["moe"], own["layers"][i]["moe"]
        assert "mlp" not in p["layers"][i] and "mlp" not in own["layers"][i]
        for name in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                got[name].numpy(), np_params["layers"]["moe"][name][i])
            assert mine[name].shape == got[name].shape
        for name, w in got["shared"].items():
            np.testing.assert_array_equal(
                w.numpy(), np_params["layers"]["moe"]["shared"][name][i])
            assert mine["shared"][name].shape == w.shape
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    m = own["layers"][0]["moe"]
    assert m["router"].shape == (d, e) and m["router"].dtype == torch.float32
    assert m["w_down"].shape == (e, f, d)
    assert m["shared"]["w_up"].shape == (d, f * cfg.n_shared_experts)
    w = transformer.prepare(dataclasses.replace(cfg, dtype=torch.bfloat16),
                            own)
    assert w.layers[0]["moe"]["router"].dtype == torch.bfloat16
    assert w.lm_head is not None


def _jax_prefill(jcfg, np_params, prompts):
    return jax.jit(lambda p, t: jtf.prefill(jcfg, p, t, MAX_SEQ))(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(prompts))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_stats_decode_match_jax(arch_setup, arch):
    """Prefill logits (B, 12, V) and the K/V cache within 1e-4, then one
    statistical-ABFT decode step at pos 12 (BER 1e-3, layer 0 at 0) with
    the reference's masks: logits within 1e-4, detections and GEMM words
    (attention projections only) equal."""
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
    h, hkv, hd, d = cfg.n_heads, cfg.kv_heads, cfg.hd, cfg.d_model
    assert stats["gemm_words"] == 2 * cfg.n_layers * (
        h * hd + 2 * hkv * hd + d)
    assert new.pos == int(jnew.pos) == PROMPT + 1


def test_protected_words_match_reference():
    """The MoE family counts attn q/k/v/o only; the dense one adds its
    MLP, as before."""
    for arch in ARCHS + ("olmo-1b", "gemma3-27b"):
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
def jax_engine_runs(arch_setup):
    """Per arch, one reference engine run: 2 SMOKE requests in stat_abft
    at undervolt, 12 tokens, window 3 (plus its clean reference)."""
    out = {}
    for arch in ARCHS:
        _, np_params, _ = arch_setup[arch]
        eng = JaxEngine(bucket=2, base_seed=0)
        eng._params[(arch, True)] = jax.tree.map(jnp.asarray, np_params)
        for s in (0, 1):
            eng.submit(arch=arch, steps=STEPS, mode="stat_abft",
                       op="undervolt", seed=s, rollback_interval=WINDOW)
        out[arch] = eng.run()
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch_setup, jax_engine_runs, arch):
    """The port's engine on the CPU through its CLI against the reference
    engine: tokens, token match, detections, rollbacks, evaluations and
    heatmaps equal, and the perfmodel attribution with ==."""
    jcfg, np_params, _ = arch_setup[arch]
    prompts = np.asarray(jar.prompt_tokens(jcfg, [0, 1]))
    eng = DriftServeEngine(arch=arch, smoke=True, bucket=2, base_seed=0,
                           device="cpu",
                           flip_source_factory=jax_replay_factory(0))
    eng.set_params(arch, True, transformer.params_from_jax(np_params))
    eng.servable_for(arch).batch_inputs = lambda cfg, seeds: (
        torch.from_numpy(prompts).long(),)
    got = serve.main(["--arch", arch, "--steps", str(STEPS),
                      "--requests", "2", "--rollback-interval", str(WINDOW),
                      "--device", "cpu"], engine=eng)
    want = jax_engine_runs[arch]
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
    """The MoE terms with ==: active parameters (top-k and shared experts
    only), MACs and DRAM bytes per evaluation, the protected activation
    bytes (attention only), the cell FLOPs of every shape cell, and
    ``run_cost`` / ``per_request_cost`` at undervolt with and without
    ABFT and with replays."""
    cfg = configs.get_config(arch, smoke=smoke)
    jcfg = jconfigs.get_config(arch, smoke=smoke)
    assert flops.active_params(cfg) == jflops.active_params(jcfg)
    assert flops.active_params(cfg) < transformer.param_count(cfg)
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


# -------------------------------------------------------- bf16-only weights
def weight_leaves(w: transformer.Weights):
    """{path: tensor} over a ``Weights``, each ``Proj`` field a leaf."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}.{k}")
        elif isinstance(t, transformer.Proj):
            for f in t._fields:
                out[f"{path}.{f}"] = getattr(t, f)
        elif t is not None:
            out[path] = t
    walk(w.embed, "embed")
    walk(w.lm_head, "lm_head")
    walk(w.final_norm, "final_norm")
    for i, lp in enumerate(w.layers):
        walk(lp, f"layers.{i}")
    return out


@pytest.mark.parametrize("arch,param_dtype", [
    ("olmo-1b", torch.float32), ("gemma2-9b", torch.float32),
    ("deepseek-moe-16b", torch.float32), ("kimi-k2-1t-a32b", torch.float32),
    ("kimi-k2-1t-a32b", torch.bfloat16)])
def test_init_weights_equals_prepared_init_params(arch, param_dtype):
    """``init_weights`` bit-equal, leaf for leaf and dtype for dtype, to
    ``prepare(init_params(...))`` for a bf16 SMOKE config (with kimi-k2's
    bf16 masters too, FULL's ``param_dtype``): projections, their f32
    sums, the embedding, the MoE router and experts in bf16, the norm
    scales in ``param_dtype``."""
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              dtype=torch.bfloat16, param_dtype=param_dtype)
    want = weight_leaves(transformer.prepare(
        cfg, transformer.init_params(cfg, 11)))
    got = weight_leaves(transformer.init_weights(cfg, 11))
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        assert g.dtype == want[k].dtype and torch.equal(g, want[k]), k
        if not (k.endswith("w_sum") or k.endswith("w_abs_sum")
                or ".ln" in k or k.startswith("final_norm")):
            assert g.dtype == torch.bfloat16, k
    n = sum(t.numel() for k, t in got.items()
            if not k.endswith("sum") and ".ln" not in k
            and not k.startswith("final_norm"))
    assert n == transformer.param_count(cfg)


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-moe-16b"])
def test_ar_servable_holds_bf16_weights_only(arch, monkeypatch):
    """With a bf16 SMOKE config, the engine's default params are
    ``init_weights``' ``Weights``; served, and after ``set_params`` with
    other ``Weights``, the servable holds that one object (no second
    copy) and no projection, embedding or expert tensor in f32."""
    get = configs.get_config

    def bf16_smoke(a, smoke=False):
        cfg = get(a, smoke=smoke)
        return dataclasses.replace(cfg, dtype=torch.bfloat16) if smoke \
            else cfg
    monkeypatch.setattr(configs, "get_config", bf16_smoke)
    eng = DriftServeEngine(arch=arch, smoke=True, bucket=1, device="cpu")
    default = eng.params_for(arch, True)
    assert isinstance(default, transformer.Weights)
    mine = transformer.init_weights(configs.get_config(arch, smoke=True), 4)
    for w in (default, mine):
        if w is mine:
            eng.set_params(arch, True, mine)
        eng.submit(arch=arch, steps=4, mode="stat_abft", op="undervolt",
                   seed=0, rollback_interval=2)
        (res,) = eng.run()
        assert len(res.tokens) == 4
        held = eng.servable_for(arch)._weights[(arch, True)]
        assert held[0] is w and held[1] is w
        for k, t in weight_leaves(w).items():
            if not (k.endswith("sum") or ".ln" in k
                    or k.startswith("final_norm")):
                assert t.dtype == torch.bfloat16, k
