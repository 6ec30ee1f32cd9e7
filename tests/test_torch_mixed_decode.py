"""The language models' last decode paths against the JAX package's.

``decode_attention_ring`` (one token against a window-sized ring buffer,
softcap before the fill-level mask), ``mixed_from_full`` (position p in
ring slot p % W), ``decode_step_mixed`` for the local/global families
(SMOKE gemma2-9b and gemma3-27b, decoded past the ring's wrap) against
the reference's and against the port's own ``decode_step``, and
``decode_step(drift=DriftDecode(...))`` for the dense, MoE, hybrid and
SSM families with the reference's flip masks replayed
(``JaxReplayFlipSource``): the checkpoint store, each layer's counts and
every GEMM's tile flags bit-equal, logits within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import abft as jabft
from repro.core.exec_ctx import DriftSystemConfig as JDriftCfg
from repro.core.rollback import RollbackConfig as JRollbackCfg
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.core import exec_ctx as exec_ctx_mod
from repro_torch.core.exec_ctx import DriftSystemConfig
from repro_torch.core.rollback import RollbackConfig
from repro_torch.models import attention, mamba2, transformer

from test_torch_core import JaxReplayFlipSource
from test_torch_mamba2 import ssm_jax_params
from test_torch_moe import moe_jax_params
from test_torch_transformer import lm_jax_params

MIXED_ARCHS = ("gemma2-9b", "gemma3-27b")
MIXED_STEPS = 6            # decode steps past the prefill
DRIFT_STEPS = 3            # steps 0, 1, 2: refreshes at 0 and 2
DRIFT_INTERVAL = 2
DRIFT_BER = np.array([0.0, 1e-2, 1e-2], np.float32)   # per class


def _to_torch(a):
    return torch.from_numpy(np.array(a))


def port_cache(jcache) -> transformer.Cache:
    """The port's ``Cache`` holding the reference cache's values."""
    k = None if jcache.k is None else _to_torch(jcache.k)
    v = None if jcache.v is None else _to_torch(jcache.v)
    ssm = None
    if jcache.ssm is not None:
        n = jcache.ssm.h.shape[0]
        ssm = tuple(mamba2.SsmState(_to_torch(jcache.ssm.h[i]),
                                    _to_torch(jcache.ssm.conv[i]))
                    for i in range(n))
    return transformer.Cache(k, v, ssm, int(jcache.pos))


# ------------------------------------------------------------- the ring
@pytest.mark.parametrize("pos", [3, 7, 8, 13])
@pytest.mark.parametrize("cap", [0.0, 5.0])
def test_decode_attention_ring_matches_jax(pos, cap):
    """One token against a (2, 8, 2, 16) ring with 4 query heads, before
    the ring fills (pos 3), when it fills (7), at the wrap (8) and past
    it (13); with the softcap of 5 and without: f32 within 1e-6. Empty
    slots hold garbage the port never reads."""
    rng = np.random.default_rng(pos)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32) * 3
    k = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    if pos < 8:
        k[:, pos + 1:], v[:, pos + 1:] = 1e4, 1e4
    want = jattn.decode_attention_ring(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos=jnp.int32(pos),
        attn_softcap=cap)
    tk = torch.from_numpy(k)
    if pos < 8:
        tk[:, pos + 1:] = float("nan")
    got = attention.decode_attention_ring(
        torch.from_numpy(q), tk, torch.from_numpy(v), pos=pos,
        attn_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


# ------------------------------------------------------- mixed decode
@pytest.fixture(scope="module", params=MIXED_ARCHS)
def mixed_setup(request):
    arch = request.param
    jcfg = jconfigs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    np_params = lm_jax_params(jcfg, seed=5)
    prompt = cfg.window + 6          # past the window before decoding
    max_seq = prompt + MIXED_STEPS
    prompts = np.random.default_rng(9).integers(
        0, jcfg.vocab, (2, prompt)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, np_params)
    _, jcache = jax.jit(lambda p, t: jtf.prefill(jcfg, p, t, max_seq))(
        jp, jnp.asarray(prompts))
    toks = np.random.default_rng(10).integers(
        0, jcfg.vocab, (MIXED_STEPS, 2, 1)).astype(np.int32)
    return jcfg, cfg, np_params, jp, jcache, toks


def test_mixed_layout_matches_jax(mixed_setup):
    jcfg, cfg, *_ = mixed_setup
    assert transformer.mixed_layout(cfg) == jtf.mixed_layout(jcfg)
    assert transformer.supports_mixed_decode(cfg)
    assert jtf.supports_mixed_decode(jcfg)
    for arch in ("glm4-9b", "olmo-1b", "hymba-1.5b", "gemma2-9b",
                 "gemma3-27b"):
        for smoke in (True, False):
            assert transformer.supports_mixed_decode(
                configs.get_config(arch, smoke=smoke)) == \
                jtf.supports_mixed_decode(
                    jconfigs.get_config(arch, smoke=smoke)), (arch, smoke)
    mc = transformer.init_mixed_cache(cfg, 2, 20)
    jmc = jtf.init_mixed_cache(jcfg, 2, 20)
    for got, want in zip(mc[:4], jmc[:4]):
        assert tuple(got.shape) == want.shape
        assert got.dtype == torch.bfloat16 and bool((got == 0).all())


@pytest.mark.parametrize("pos", [5, 8, 14])
def test_mixed_from_full_bit_equal(mixed_setup, pos):
    """The ring layout of one full cache, before the window fills (pos
    5), when it just fills (8) and past it (14): every ring and global
    cache bit-equal to the reference's."""
    jcfg, cfg, _, _, jcache, _ = mixed_setup
    jc = jcache._replace(pos=jnp.int32(pos))
    want = jtf.mixed_from_full(jcfg, jc)
    got = transformer.mixed_from_full(cfg, port_cache(jc))
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.pos == pos


def test_decode_step_mixed_matches_jax_and_decode_step(mixed_setup):
    """Six steps past the prefill of window + 6 tokens, so the rings wrap
    while they decode: each step's logits within 1e-4 of the reference's
    ``decode_step_mixed`` and bit-equal to the port's ``decode_step`` on
    the full cache (the rings are read oldest first, so the sums run in
    its order), the rings within 1e-4 of the reference's."""
    jcfg, cfg, np_params, jp, jcache, toks = mixed_setup
    params = transformer.params_from_jax(np_params)
    jstep = jax.jit(lambda p, c, t: jtf.decode_step_mixed(jcfg, p, c, t))
    jmc = jtf.mixed_from_full(jcfg, jcache)
    mc = transformer.mixed_from_full(cfg, port_cache(jcache))
    full = port_cache(jcache)
    for t in toks:
        jlogits, jmc = jstep(jp, jmc, jnp.asarray(t))
        tt = torch.from_numpy(t).long()
        logits, mc = transformer.decode_step_mixed(cfg, params, mc, tt)
        flogits, full, _ = transformer.decode_step(cfg, params, full, tt)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=0)
        assert torch.equal(logits, flogits)
    assert mc.pos == int(jmc.pos) == full.pos
    for g, w in zip(mc[:4], jmc[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)


# --------------------------------------------------------- DriftDecode
DRIFT_ARCHS = {"olmo-1b": lm_jax_params,
               "deepseek-moe-16b": moe_jax_params,
               "hymba-1.5b": ssm_jax_params,
               "mamba2-370m": ssm_jax_params}


class _Recorder:
    """Each context a decode step builds, and every GEMM's tile flags."""

    def __init__(self):
        self.ctxs, self.flags = [], []


@pytest.mark.parametrize("arch", sorted(DRIFT_ARCHS))
def test_drift_decode_matches_jax(arch, monkeypatch):
    """Three ``DriftDecode`` steps (refreshes at steps 0 and 2, interval
    2) at BER 1e-2 (layer 0 at 0, the first-block class), masks replayed
    from the reference's keys: each step's store bit-equal (MoE: the four
    attention projections; mamba2: empty, as the reference's stacked
    ``state_out``), each layer's detected rows and corrected elements and
    every GEMM's tile flags equal, logits within 1e-4. The reference runs
    its layers unrolled and eagerly, so its contexts can be read."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               scan_layers=False)
    cfg = configs.get_config(arch, smoke=True)
    np_params = DRIFT_ARCHS[arch](jcfg, seed=3)
    jp = jax.tree.map(jnp.asarray, np_params)
    prompts = np.random.default_rng(4).integers(
        0, jcfg.vocab, (2, 8)).astype(np.int32)
    _, jcache = jax.jit(lambda p, t: jtf.prefill(jcfg, p, t, 12))(
        jp, jnp.asarray(prompts))
    params = transformer.prepare(cfg, transformer.params_from_jax(np_params))
    cache = port_cache(jcache)

    jrec, rec = _Recorder(), _Recorder()

    class JCtx(jtf.ExecContext):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            jrec.ctxs.append(self)

    class Ctx(transformer.ExecContext):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            rec.ctxs.append(self)

    real_mask = jabft.tile_error_mask
    real_fused = exec_ctx_mod.drift_gemm_fused

    def jmask(*a, **kw):
        mask, flag = real_mask(*a, **kw)
        jrec.flags.append(np.asarray(flag))
        return mask, flag

    def fused(*a, **kw):
        out = real_fused(*a, **kw)
        rec.flags.append((out[3] > 0).numpy())      # the tile counts
        return out

    monkeypatch.setattr(jtf, "ExecContext", JCtx)
    monkeypatch.setattr(transformer, "ExecContext", Ctx)
    monkeypatch.setattr(jabft, "tile_error_mask", jmask)
    monkeypatch.setattr(exec_ctx_mod, "drift_gemm_fused", fused)

    jdcfg = JDriftCfg(mode="drift",
                      rollback=JRollbackCfg(interval=DRIFT_INTERVAL))
    dcfg = DriftSystemConfig(mode="drift",
                             rollback=RollbackConfig(interval=DRIFT_INTERVAL))
    run_key = jax.random.PRNGKey(7)
    src = JaxReplayFlipSource(run_key)
    jstore = jtf.drift_store_spec(jcfg, 2)
    store = transformer.drift_store_spec(cfg, 2)
    assert {k: tuple(v.shape) for k, v in store.items()} == \
        {k: v.shape for k, v in jstore.items()}
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab, (DRIFT_STEPS, 2, 1)).astype(np.int32)
    for step, t in enumerate(toks):
        jrec.ctxs.clear()
        rec.ctxs.clear()
        jdrift = jtf.DriftDecode(
            cfg=jdcfg, key=jax.random.fold_in(run_key, step),
            ber_by_class=jnp.asarray(DRIFT_BER), store=jstore,
            step=jnp.int32(step))
        jlogits, jcache, jnew = jtf.decode_step(jcfg, jp, jcache,
                                                jnp.asarray(t), jdrift)
        drift = transformer.DriftDecode(cfg=dcfg, flip_source=src,
                                        ber_by_class=DRIFT_BER, store=store,
                                        step=step)
        logits, cache, new = transformer.decode_step(
            cfg, params, cache, torch.from_numpy(t).long(), drift)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=0)
        assert sorted(new) == sorted(jnew)
        for name in jnew:
            np.testing.assert_array_equal(new[name].numpy(),
                                          np.asarray(jnew[name]), name)
        if jnew:
            jstore = jnew
        assert len(rec.ctxs) == len(jrec.ctxs) == cfg.n_layers
        for c, jc in zip(rec.ctxs, jrec.ctxs):
            for stat in ("detected_row_errors", "corrected_elems"):
                assert int(c.stats[stat]) == int(jc.stats[stat]), stat
    assert len(rec.flags) == len(jrec.flags)
    assert len(rec.flags) == DRIFT_STEPS * cfg.n_layers * (
        0 if cfg.family == "ssm" else 4 if cfg.family == "moe" else 7)
    for got, want in zip(rec.flags, jrec.flags):
        np.testing.assert_array_equal(got, want)
    if cfg.family != "ssm":     # the BER really flagged tiles
        assert any(f.any() for f in rec.flags)
