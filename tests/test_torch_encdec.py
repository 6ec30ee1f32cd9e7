"""The port's enc-dec model (whisper-base) against the JAX package's, on
``whisper-base-smoke`` (2 + 2 layers, d 64, 4 heads of 16, 20 frames).

Params come from the reference's init through ``encdec.params_from_jax``;
frames and tokens are the reference's synthetic batch, handed to both
sides as numpy arrays; f32 throughout. ``encode``, ``decode_train``,
``init_decode_cache`` and ``decode_step`` are each held against the
reference, and the serve steps (``make_prefill_step``,
``make_decode_step``) against each other: teacher-forced decode steps
give the prefill's logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import synthetic as jsynthetic
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.models import common, encdec
from repro_torch.train import steps

ARCH = "whisper-base"


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    cfg = configs.get_config(ARCH, smoke=True)
    np_params = jax.tree.map(np.asarray, jsteps.init_model_params(
        jcfg, jax.random.PRNGKey(0)))
    dcfg = jsynthetic.for_model(jcfg, global_batch=2, seq_len=8)
    batch = jax.tree.map(np.asarray, jsynthetic.batch_at(dcfg, step=0))
    return jcfg, cfg, np_params, batch


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a).long() if a.dtype.kind == "i" \
        else torch.from_numpy(a)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-76b"])
def test_config_matches_reference(arch, smoke):
    """Every field of the port's config equals the reference's (dtypes by
    name); the reference's ``remat`` and ``scan_layers`` have no port
    counterpart."""
    got = configs.get_config(arch, smoke=smoke)
    want = jconfigs.get_config(arch, smoke=smoke)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert str(a).replace("torch.", "") == np.dtype(b).name, f.name
        else:
            assert a == b, f.name
    assert got.hd == want.hd and got.kv_heads == want.kv_heads


def test_layernorm_matches_jax(setup):
    """The parametric LayerNorm within 1e-6."""
    jcfg, cfg, _, _ = setup
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    want = jcommon.apply_norm(jcfg, _j(p), jnp.asarray(x))
    got = common.apply_norm(cfg, {k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    init = common.norm_params(cfg)
    assert init["scale"].eq(1).all() and not init["bias"].any()


def test_encode_and_decode_train_match_jax(setup):
    """Memory within 2e-5 and logits within 1e-4 of the reference's."""
    jcfg, cfg, np_params, batch = setup
    params = encdec.params_from_jax(np_params)
    jmem = jencdec.encode(jcfg, _j(np_params), jnp.asarray(batch["frames"]))
    mem = encdec.encode(cfg, params, _t(batch["frames"]))
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), atol=2e-5,
                               rtol=0)
    tok = batch["tokens"][:, :-1]
    want = jencdec.decode_train(jcfg, _j(np_params), jnp.asarray(tok), jmem)
    got = encdec.decode_train(cfg, params, _t(tok), mem)
    assert got.dtype == torch.float32 and got.shape == (2, 8, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_decode_cache_and_steps_match_jax(setup):
    """``init_decode_cache``'s cross k, v within 2e-5; then 6 decode steps
    on the same tokens: logits within 1e-4 and the written self-attention
    cache within 2e-5 of the reference's, ``pos`` equal."""
    jcfg, cfg, np_params, batch = setup
    params = encdec.params_from_jax(np_params)
    jmem = jencdec.encode(jcfg, _j(np_params), jnp.asarray(batch["frames"]))
    mem = encdec.encode(cfg, params, _t(batch["frames"]))
    jcache = jencdec.init_decode_cache(jcfg, _j(np_params), jmem, 12)
    cache = encdec.init_decode_cache(cfg, params, mem, 12)
    assert cache.self_k.shape == jcache.self_k.shape and cache.pos == 0
    np.testing.assert_allclose(cache.cross_k.numpy(),
                               np.asarray(jcache.cross_k), atol=2e-5)
    np.testing.assert_allclose(cache.cross_v.numpy(),
                               np.asarray(jcache.cross_v), atol=2e-5)
    for i in range(6):
        tok = batch["tokens"][:, i:i + 1]
        want, jcache = jencdec.decode_step(jcfg, _j(np_params), jcache,
                                           jnp.asarray(tok))
        got, cache = encdec.decode_step(cfg, params, cache, _t(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0, err_msg=f"step {i}")
    assert cache.pos == int(jcache.pos) == 6
    np.testing.assert_allclose(cache.self_k[:, :, :6].numpy(),
                               np.asarray(jcache.self_k)[:, :, :6],
                               atol=2e-5)


def test_serve_steps_agree(setup):
    """``make_prefill_step`` gives ``decode_train``'s logits over the
    prompt; ``make_decode_step`` fed the same tokens one by one from a
    fresh cache gives each position's logits again, within 1e-4."""
    _, cfg, np_params, batch = setup
    params = encdec.params_from_jax(np_params)
    frames, tok = _t(batch["frames"]), _t(batch["tokens"][:, :8])
    logits = steps.make_prefill_step(cfg, 16)(params, {"frames": frames,
                                                       "tokens": tok})
    assert logits.shape == (2, 8, cfg.vocab)
    cache = encdec.init_decode_cache(cfg, params,
                                     encdec.encode(cfg, params, frames), 16)
    decode = steps.make_decode_step(cfg)
    for i in range(8):
        step_logits, cache = decode(params, cache, tok[:, i:i + 1])
        np.testing.assert_allclose(step_logits[:, 0].numpy(),
                                   logits[:, i].numpy(), atol=1e-4)


def test_init_params_has_the_reference_layout(setup):
    """The port's own init draws every leaf the reference's has, with its
    shape and dtype, the LayerNorms at scale 1 and bias 0."""
    _, cfg, np_params, _ = setup
    mine = encdec.init_params(cfg, 0)
    ref = encdec.params_from_jax(np_params)

    def shapes(t, path=""):
        if isinstance(t, dict):
            return {k: v for key, val in t.items()
                    for k, v in shapes(val, f"{path}/{key}").items()}
        if isinstance(t, list):
            return {k: v for i, val in enumerate(t)
                    for k, v in shapes(val, f"{path}/{i}").items()}
        return {path: (tuple(t.shape), t.dtype)}
    assert shapes(mine) == shapes(ref)
    assert mine["dec_layers"][1]["ln_x"]["scale"].eq(1).all()
    with pytest.raises(ValueError, match="encdec"):
        encdec.init_params(configs.get_config("olmo-1b", smoke=True), 0)
