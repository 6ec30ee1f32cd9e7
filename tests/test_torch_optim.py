"""The port's optimizers against the JAX package's: ``lr_at`` over warmup
and decay, ``global_norm`` and clipping, and AdamW and Adafactor ``init``
and ``apply`` over three steps on a small tree (leaves of rank 0 to 3,
one of them factored by Adafactor along its two largest dims), f32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as joptim
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves


def _tree(rng, scale=1.0):
    shapes = {"b": (7,), "w": (6, 5), "e": {"x": (3, 4, 9), "s": ()}}

    def draw(t):
        if isinstance(t, dict):
            return {k: draw(v) for k, v in t.items()}
        return (scale * rng.standard_normal(t)).astype(np.float32)
    return draw(shapes)


def _to_torch(t):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t)


def _close(got, want, rtol, atol, label):
    """Leaves compared in sorted-key order on both sides."""
    g = jax.tree_util.tree_leaves(jax.tree.map(
        lambda a: a.numpy(), got, is_leaf=lambda x: isinstance(
            x, torch.Tensor)))
    w = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w), label
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"{label} leaf {i}")


@pytest.mark.parametrize("warmup,total", [(1, 10), (5, 40), (100, 10_000),
                                          (10, 10)])
def test_lr_at_matches_jax(warmup, total):
    """Over warmup, the cosine decay and past the end: within one f32 ulp
    (numpy's and XLA's f32 cos may round apart)."""
    cfg = adamw.OptimConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    jcfg = joptim.OptimConfig(lr=3e-4, warmup_steps=warmup,
                              total_steps=total)
    for step in sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2,
                        total - 1, total, total + 5}):
        got = adamw.lr_at(cfg, step)
        want = np.float32(joptim.lr_at(jcfg, jnp.int32(step)))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)
    assert adamw.lr_at(cfg, 0) > 0


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_global_norm_and_clip_match_jax(max_norm):
    """Within 1e-6 relative (summation order)."""
    t = _tree(np.random.default_rng(0), 3.0)
    got, gn = adamw.clip_by_global_norm(_to_torch(t), max_norm)
    want, wn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, t),
                                          max_norm)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    np.testing.assert_allclose(float(adamw.global_norm(_to_torch(t))),
                               float(joptim.global_norm(t)), rtol=1e-6)
    _close(got, want, 1e-6, 0, "clipped")


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_apply_matches_jax(kind):
    """Three updates from ``init`` with fresh gradients each step: params,
    every moment, ``grad_norm`` and ``lr`` against the reference's,
    within 2e-6 relative plus 1e-7 (f32; clipping binds on the first
    step's gradient, of norm ~15)."""
    rng = np.random.default_rng(1)
    cfg = adamw.OptimConfig(kind=kind, lr=1e-2, warmup_steps=2,
                            total_steps=6)
    jcfg = joptim.OptimConfig(kind=kind, lr=1e-2, warmup_steps=2,
                              total_steps=6)
    p = _tree(rng)
    params, jparams = _to_torch(p), jax.tree.map(jnp.asarray, p)
    state, jstate = adamw.init(cfg, params), joptim.init(jcfg, jparams)
    for name in ("mu", "nu", "vr", "vc"):
        mine, ref = getattr(state, name), getattr(jstate, name)
        assert (mine is None) == (ref is None), name
        if mine is not None:
            assert sorted(tuple(x.shape) for x in tree_leaves(mine)) == \
                sorted(tuple(x.shape) for x in jax.tree_util.tree_leaves(ref))
    for step in range(3):
        g = _tree(rng, 4.0 if step == 0 else 0.05)
        params, state, m = adamw.apply(cfg, state, params, _to_torch(g))
        jparams, jstate, jm = joptim.apply(jcfg, jstate, jparams,
                                           jax.tree.map(jnp.asarray, g))
        _close(params, jparams, 2e-6, 1e-7, f"{kind} params, step {step}")
        for name in ("mu", "nu", "vr", "vc"):
            if getattr(state, name) is not None:
                _close(getattr(state, name), getattr(jstate, name), 2e-6,
                       1e-12, f"{kind} {name}, step {step}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1.2e-7)
        assert state.step == int(jstate.step) == step + 1


def test_apply_leaves_its_inputs_alone():
    cfg = adamw.OptimConfig()
    params = _to_torch(_tree(np.random.default_rng(2)))
    before = [x.clone() for x in tree_leaves(params)]
    state = adamw.init(cfg, params)
    grads = _to_torch(_tree(np.random.default_rng(3)))
    adamw.apply(cfg, state, params, grads)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                  before))
    assert all(not x.any() for x in tree_leaves(state.mu))
    with pytest.raises(ValueError):
        adamw.init(adamw.OptimConfig(kind="sgd"), params)
