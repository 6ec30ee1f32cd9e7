"""The port's training path against the JAX package's, at SMOKE sizes.

Params come from the reference's init (``jsteps.init_model_params``; the
diffusion models' all-zero weights, which would zero most gradients, are
given small seeded values) and reach the port through each model's
``params_from_jax``; batches are the reference's synthetic ones, handed
to both sides as numpy arrays. For every arch of the registry one
``make_train_step`` step is held against ``jax.value_and_grad`` of the
reference's loss and the reference's AdamW update: the loss, every
gradient leaf and every updated param. For the diffusion models the
reference loss is built from ``q_sample`` and ``forward`` with the
timesteps and noise the port's step draws. Also: ``softmax_xent``, the
teacher-forcing ``forward`` of each LM family (VLM with ``vis_embeds``),
a microbatched step against the single shot, the attention kernel's
autograd plumbing, checkpoints, the elastic planner and the launcher.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.data import synthetic as jsynthetic
from repro.diffusion import schedule as jsched
from repro.distributed import elastic as jelastic
from repro.models import dit as jdit
from repro.models import transformer as jtf
from repro.models import unet as junet
from repro.optim import adamw as joptim
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import synthetic
from repro_torch.distributed import elastic
from repro_torch.kernels import flash_attention as fk
from repro_torch.launch import train as train_cli
from repro_torch.models import dit, encdec, transformer, unet
from repro_torch.models.attention import full_attention
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.tree import tree_leaves

ARCHS = list(jconfigs.ALL_ARCHS)
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def jax_params(jcfg, seed=0):
    """The reference's init as numpy; for the diffusion models every
    all-zero weight of rank >= 2 (adaLN-Zero, the output convs) gets
    0.05-scaled seeded normals, so that every block has a gradient."""
    p = jax.tree.map(np.asarray, jsteps.init_model_params(
        jcfg, jax.random.PRNGKey(seed)))
    if jcfg.family not in ("dit", "unet"):
        return p
    rng = np.random.default_rng(seed + 100)

    def nudge(a):
        if a.ndim >= 2 and not a.any():
            return (0.05 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(nudge, p)


def port_params(cfg, tree):
    if cfg.family == "encdec":
        return encdec.params_from_jax(tree)
    if cfg.family == "dit":
        return dit.params_from_jax(tree)
    if cfg.family == "unet":
        return unet.params_from_jax(tree)
    return transformer.params_from_jax(tree)


def jax_batch(jcfg, batch=2, seq=16):
    """The reference's synthetic batch at step 0 (numpy), with seeded
    ``vis_embeds`` for the VLM."""
    dcfg = jsynthetic.for_model(jcfg, global_batch=batch, seq_len=seq)
    b = jax.tree.map(np.asarray, jsynthetic.batch_at(dcfg, step=0))
    if jcfg.family == "vlm":
        b["vis_embeds"] = (0.1 * np.random.default_rng(1).standard_normal(
            (batch, jcfg.vis_tokens, jcfg.d_model))).astype(np.float32)
    return b


def torch_batch(b):
    return {k: torch.from_numpy(np.array(v)).long() if v.dtype.kind == "i"
            else torch.from_numpy(np.array(v)) for k, v in b.items()}


def jax_loss(jcfg, params, batch, t=None, eps=None):
    """The reference's loss; for diffusion, from ``q_sample`` and
    ``forward`` with the given ``t`` and ``eps``."""
    if jcfg.family in transformer.FAMILIES:
        return jsteps._lm_loss(jcfg, params, batch)
    if jcfg.family == "encdec":
        return jsteps._encdec_loss(jcfg, params, batch)
    sched = jsched.DdpmSchedule.default(1000)
    x_t = sched.q_sample(batch["latents"], t, eps)
    tf = t.astype(jnp.float32)
    if jcfg.family == "dit":
        if jcfg.cond_tokens:
            pred = jdit.forward(jcfg, params, x_t, tf, None,
                                text=batch["text"])[0]
        else:
            pred = jdit.forward(jcfg, params, x_t, tf, batch["labels"])[0]
    else:
        pred = junet.forward(jcfg, params, x_t, tf, batch.get("text"))
    return jnp.mean((pred - eps) ** 2), {}


def assert_tree_close(got, want_np, rtol, atol_frac, label, floor=0.0):
    """Leaf by leaf: |got - want| <= rtol |want| + atol_frac * max|want of
    the leaf| + floor * max|want of every leaf|."""
    got_l, want_l = tree_leaves(got), [np.asarray(w, np.float32)
                                       for w in tree_leaves(want_np)]
    assert len(got_l) == len(want_l), label
    top = max(float(np.abs(w).max()) for w in want_l if w.size)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(
            g.detach().numpy(), w, rtol=rtol,
            atol=atol_frac * scale + floor * top + 1e-30,
            err_msg=f"{label} leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One AdamW step at SMOKE, global batch 2, seq 16, against the
    reference's, f32 (summation order differs between XLA and PyTorch):
    - the loss and the gradient's global norm within 2e-5 relative;
    - each gradient leaf within 2e-4 relative plus 2e-4 of the leaf's
      largest magnitude plus 1e-6 of the largest gradient anywhere (a
      gradient that is zero by structure, as a UNet ``temb_w`` ahead of a
      GroupNorm of one channel a group, is roundoff on both sides);
    - the update: the port's AdamW given the reference's gradient within
      1e-6 of the reference's new params (AdamW's first step divides
      each gradient by its own magnitude, so it is compared on one
      gradient), and ``make_train_step``'s new params bit-equal to the
      port's AdamW given the port's gradient."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    np_params = jax_params(jcfg)
    b = jax_batch(jcfg)
    ocfg = adamw.OptimConfig(**OCFG)
    params = port_params(cfg, np_params)
    state = steps.TrainState(params, adamw.init(ocfg, params), 0, 7)
    tb = torch_batch(b)

    t = eps = None
    if cfg.family in ("dit", "unet"):
        gen = synthetic.generator(state.seed, state.step)
        t = torch.randint(0, 1000, (2,), generator=gen)
        eps = torch.randn(tuple(tb["latents"].shape), generator=gen)
        t, eps = t.numpy().astype(np.int32), eps.numpy()

    jparams = jax.tree.map(jnp.asarray, np_params)
    jb = jax.tree.map(jnp.asarray, b)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(jcfg, p, jb, t, eps), has_aux=True))(jparams)
    jocfg = joptim.OptimConfig(**OCFG)
    jnew, _, jm = joptim.apply(jocfg, joptim.init(jocfg, jparams), jparams,
                               jg)
    jg_port = port_params(cfg, jax.tree.map(np.asarray, jg))

    loss, _, grads = steps.value_and_grad(
        cfg, state.params, tb, synthetic.generator(state.seed, state.step))
    new, metrics = steps.make_train_step(cfg, ocfg)(state, tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=2e-5)
    assert float(metrics["loss"]) == float(loss)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jm["grad_norm"]), rtol=2e-5)
    assert float(metrics["lr"]) == float(jm["lr"])
    assert_tree_close(grads, jg_port, 2e-4, 2e-4, f"{arch} grads",
                      floor=1e-6)
    upd, _, _ = adamw.apply(ocfg, state.opt, state.params, jg_port)
    assert_tree_close(upd, port_params(cfg, jax.tree.map(np.asarray, jnew)),
                      0, 1e-6, f"{arch} params")
    mine, opt, _ = adamw.apply(ocfg, state.opt, state.params, grads)
    for a, b_ in zip(tree_leaves((new.params, new.opt)),
                     tree_leaves((mine, opt))):
        assert (a == b_) if isinstance(a, int) else torch.equal(a, b_)
    assert new.step == 1 and new.opt.step == 1
    moved = max(float((a - b_).abs().max()) for a, b_ in
                zip(tree_leaves(new.params), tree_leaves(state.params)))
    assert moved > 0


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma2-9b", "deepseek-moe-16b",
                                  "mamba2-370m", "hymba-1.5b",
                                  "internvl2-76b"])
def test_forward_matches_jax(arch):
    """``transformer.forward`` (teacher forcing over 16 tokens, the VLM's
    8 ``vis_embeds`` first): logits within 1e-4 and the aux loss within
    1e-6 (MoE; 0 elsewhere) of the reference's."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    np_params = jax_params(jcfg)
    b = jax_batch(jcfg)
    tok = b["tokens"][:, :-1]
    vis = b.get("vis_embeds")
    want, waux = jtf.forward(jcfg, jax.tree.map(jnp.asarray, np_params),
                             jnp.asarray(tok),
                             None if vis is None else jnp.asarray(vis))
    got, aux = transformer.forward(
        cfg, transformer.params_from_jax(np_params),
        torch.from_numpy(np.array(tok)).long(),
        None if vis is None else torch.from_numpy(vis))
    assert got.dtype == torch.float32
    assert got.shape == (2, 16 + cfg.vis_tokens, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(waux), atol=1e-6)
    if cfg.family != "moe":
        assert float(aux) == 0.0


def test_forward_refuses_prepared_weights():
    cfg = configs.get_config("olmo-1b", smoke=True)
    params = transformer.init_params(cfg, 0)
    with pytest.raises(TypeError, match="raw params"):
        transformer.forward(cfg, transformer.prepare(cfg, params),
                            torch.zeros((1, 4), dtype=torch.long))


def test_vlm_prefill_and_init_match_jax():
    """The VLM's prefill takes the ``vis_embeds`` prefix (logits within
    1e-4 of the reference's), and its init draws an untied ``lm_head``:
    the port's params have the reference's leaves and shapes."""
    arch = "internvl2-76b"
    jcfg = jconfigs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    np_params = jax_params(jcfg)
    b = jax_batch(jcfg, seq=8)
    tok, vis = b["tokens"][:, :8], b["vis_embeds"]
    want, _ = jtf.prefill(jcfg, jax.tree.map(jnp.asarray, np_params),
                          jnp.asarray(tok), 24, vis_embeds=jnp.asarray(vis))
    got, cache = transformer.prefill(
        cfg, transformer.params_from_jax(np_params),
        torch.from_numpy(np.array(tok)).long(), 24,
        vis_embeds=torch.from_numpy(vis))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    assert cache.pos == 8 + cfg.vis_tokens
    mine = transformer.init_params(cfg, 0)
    ref = transformer.params_from_jax(np_params)
    assert "lm_head" in mine and mine.keys() == ref.keys()

    def shapes(t, path=""):
        if isinstance(t, dict):
            return {k: v for key, val in t.items()
                    for k, v in shapes(val, f"{path}/{key}").items()}
        if isinstance(t, list):
            return {k: v for i, val in enumerate(t)
                    for k, v in shapes(val, f"{path}/{i}").items()}
        return {path: (tuple(t.shape), t.dtype)}
    assert shapes(mine) == shapes(ref)
    assert transformer.param_count(cfg) == jtf.param_count(jcfg)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_jax(masked):
    """Within 1e-6 relative, on f32 logits with a few large entries."""
    rng = np.random.default_rng(3)
    logits = (4 * rng.standard_normal((2, 5, 11))).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6) if masked else None
    want = jsteps.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                               None if mask is None else jnp.asarray(mask))
    got = steps.softmax_xent(torch.from_numpy(logits),
                             torch.from_numpy(labels).long(),
                             None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_microbatched_train_step_matches_single_shot():
    """Gradient accumulation gives the same update (linearity), with the
    reference's test's tolerances: loss 2e-4 relative, params 5e-5."""
    cfg = dataclasses.replace(configs.get_config("olmo-1b", smoke=True),
                              name="m", n_layers=2, d_model=32, d_ff=64,
                              vocab=64)
    ocfg = adamw.OptimConfig(**OCFG)
    state = steps.init_train_state(cfg, ocfg, 0, "cpu")
    dcfg = synthetic.for_model(cfg, global_batch=8, seq_len=16)
    batch = synthetic.batch_at(dcfg, 0)
    s1, m1 = steps.make_train_step(cfg, ocfg, 1)(state, batch)
    s4, m4 = steps.make_train_step(cfg, ocfg, 4)(state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=2e-4)
    d = max(float((a - b).abs().max()) for a, b in
            zip(tree_leaves(s1.params), tree_leaves(s4.params)))
    assert d < 5e-5


def test_diffusion_loss_takes_given_draws():
    """``_diffusion_loss`` with a given ``t`` and ``eps`` equals the loss
    its generator's own draws give, when those are the same numbers."""
    cfg = configs.get_config("dit-xl-512", smoke=True)
    params = port_params(cfg, jax_params(jconfigs.get_config(
        "dit-xl-512", smoke=True)))
    batch = synthetic.batch_at(synthetic.for_model(cfg, 2), 0)
    gen = synthetic.generator(5, 3)
    t = torch.randint(0, 1000, (2,), generator=gen)
    eps = torch.randn(tuple(batch["latents"].shape), generator=gen)
    a, _ = steps._diffusion_loss(cfg, params, batch, t=t, eps=eps)
    b_, _ = steps._diffusion_loss(cfg, params, batch,
                                  synthetic.generator(5, 3))
    assert float(a) == float(b_)


def test_attention_autograd_carries_plain_gradients(monkeypatch):
    """``_Attention`` (the card's differentiable launch), its launch
    replaced by the plain version on the CPU: the output carries a
    ``grad_fn``, each backward counts once, and q, k and v get the plain
    version's gradients exactly (GQA 4/2 heads, window 3, softcap 5);
    under ``no_grad``, ``inference_mode`` or on inputs that need no
    gradient it records no graph (serving calls it so)."""
    monkeypatch.setattr(fk, "_launch", lambda q, k, v, c, w=0, s=0.0:
                        full_attention(q, k, v, causal=c, window=w,
                                       attn_softcap=s))
    rng = np.random.default_rng(4)
    qkv = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
           for sh in ((2, 6, 4, 8), (2, 6, 2, 8), (2, 6, 2, 8))]
    go = torch.from_numpy(rng.standard_normal((2, 6, 4, 8)).astype(
        np.float32))
    leaves = [t.clone().requires_grad_(True) for t in qkv]
    n0 = fk.backward_calls
    out = fk._Attention.apply(*leaves, True, 3, 5.0)
    assert out.grad_fn is not None
    out.backward(go)
    assert fk.backward_calls == n0 + 1
    ref = [t.clone().requires_grad_(True) for t in qkv]
    full_attention(*ref, causal=True, window=3, attn_softcap=5.0).backward(go)
    for a, b in zip(leaves, ref):
        assert torch.equal(a.grad, b.grad)
    k_only = [qkv[0], qkv[1].clone().requires_grad_(True), qkv[2]]
    fk._Attention.apply(*k_only, True, 0, 0.0).sum().backward()
    assert k_only[1].grad is not None and qkv[0].grad is None
    with torch.no_grad():
        assert fk._Attention.apply(*leaves, True, 0, 0.0).grad_fn is None
    with torch.inference_mode():
        assert fk._Attention.apply(*qkv, True, 0, 0.0).grad_fn is None
    assert fk._Attention.apply(*qkv, True, 0, 0.0).grad_fn is None


# ------------------------------------------------------------ checkpoints
def test_checkpoint_roundtrip(tmp_path):
    """A train state (tensors of three dtypes, None nodes, host ints)
    saved twice and restored bit-equal onto the template's devices, as
    the reference's test checks it."""
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    tree = {"a": torch.arange(6).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16) / 3},
            "n": None, "s": steps.TrainState({"w": torch.randn(3)},
                                             None, 5, 9)}
    mgr.save(10, tree, extra={"data_step": 10})
    mgr.save(20, tree)
    step, restored, extra = mgr.restore_latest(tree)
    assert step == 20 and extra == {}
    assert restored["n"] is None and isinstance(restored["s"],
                                                steps.TrainState)
    assert restored["s"].step == 5 and restored["s"].seed == 9
    for a, b in zip(tree_leaves(restored), tree_leaves(tree)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b
    manifest = open(os.path.join(str(tmp_path), "step_00000020",
                                 "MANIFEST.json")).read()
    assert '"bfloat16"' in manifest and '"sha256"' in manifest


def test_checkpoint_corruption_falls_back(tmp_path, capsys):
    mgr = CheckpointManager(str(tmp_path), keep_last=3)
    tree = {"a": torch.arange(4.0)}
    mgr.save(1, tree)
    mgr.save(2, {"a": torch.arange(4.0) * 2})
    leaf = os.path.join(str(tmp_path), "step_00000002", "leaf_00000.npy")
    np.save(leaf, np.zeros(4, np.float32))
    step, restored, _ = mgr.restore_latest(tree)
    assert step == 1 and torch.equal(restored["a"], torch.arange(4.0))
    assert "step 2 invalid" in capsys.readouterr().out


@pytest.mark.parametrize("mgr_cls", [CheckpointManager, JCheckpointManager])
def test_checkpoint_gc_and_layout(tmp_path, mgr_cls):
    """gc keeps the newest two, and the port's directory layout is the
    reference's (step_XXXXXXXX/ with leaf_XXXXX.npy and MANIFEST.json)."""
    mgr = mgr_cls(str(tmp_path), keep_last=2)
    zeros = (torch.zeros(2) if mgr_cls is CheckpointManager
             else jnp.zeros(2))
    for s in [1, 2, 3, 4]:
        mgr.save(s, {"a": zeros})
    assert mgr.steps() == [3, 4]
    assert sorted(os.listdir(str(tmp_path))) == ["step_00000003",
                                                 "step_00000004"]
    assert sorted(os.listdir(os.path.join(str(tmp_path), "step_00000004")
                             )) == ["MANIFEST.json", "leaf_00000.npy"]


def test_resume_is_bit_equal(tmp_path):
    """3 steps straight, or 2 steps, a checkpoint, a restore into a fresh
    state and the 3rd: every param and moment bit-equal."""
    cfg = configs.get_config("olmo-1b", smoke=True)
    ocfg = adamw.OptimConfig(**OCFG)
    dcfg = synthetic.for_model(cfg, 2, 16)
    step_fn = steps.make_train_step(cfg, ocfg)
    state = steps.init_train_state(cfg, ocfg, 0, "cpu")
    for i in range(2):
        state, _ = step_fn(state, synthetic.batch_at(dcfg, i))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state)
    straight, _ = step_fn(state, synthetic.batch_at(dcfg, 2))
    fresh = steps.init_train_state(cfg, ocfg, 0, "cpu")
    step, restored, _ = mgr.restore_latest(fresh)
    assert step == 2 and restored.step == 2
    resumed, _ = step_fn(restored, synthetic.batch_at(dcfg, 2))
    for a, b in zip(tree_leaves(resumed), tree_leaves(straight)):
        assert (a == b) if not isinstance(a, torch.Tensor) \
            else torch.equal(a, b)


# ---------------------------------------------------------------- elastic
def test_plan_mesh_and_stragglers_match_reference():
    for n, mp in ((512, 16), (256, 16), (480, 16), (8, 2), (1, 1),
                  (1024, 8), (7, 1)):
        assert elastic.plan_mesh(n, mp) == jelastic.plan_mesh(n, mp)
    with pytest.raises(ValueError):
        elastic.plan_mesh(10, 4)
    det, jdet = elastic.StragglerDetector(), jelastic.StragglerDetector()
    for times in ({0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0},
                  {0: 1.0, 1: 1.1, 2: 3.0, 3: 1.0},
                  {0: 1.0, 1: 1.0, 2: 4.0, 3: 1.0}):
        got, want = det.update(times), jdet.update(times)
        assert got == want and det.ema == jdet.ema
    assert got == [2]
    shards = {h: h for h in range(4)}
    assert det.reassign_shards(shards, got) == \
        jdet.reassign_shards(shards, got)


# --------------------------------------------------------------- launcher
def test_launcher_resumes_from_its_checkpoints(tmp_path, capsys):
    """Two runs into one ``--ckpt-dir``: the first trains 6 steps and saves
    at 2, 4 and 6; with step 6's checkpoint removed, the second resumes
    from 4 and ends bit-equal to the first. ``--model-parallel 2`` on one
    rank raises ``plan_mesh``'s error, as the reference's launcher does."""
    ck = tmp_path / "ck"
    base = ["--arch", "olmo-1b", "--device", "cpu", "--global-batch", "2",
            "--seq", "16", "--ckpt-every", "2", "--log-every", "1",
            "--steps", "6", "--ckpt-dir", str(ck)]
    straight = train_cli.main(base)
    first = capsys.readouterr().out
    assert "[train] olmo-1b-smoke on mesh {'data': 1, 'model': 1}" in first
    for s in (2, 4, 6):
        assert f"[ckpt] saved step {s}" in first
    assert "resumed" not in first and first.rstrip().endswith("done")
    shutil.rmtree(ck / "step_00000006")
    resumed = train_cli.main(base)
    second = capsys.readouterr().out
    assert "[train] resumed from step 4" in second
    assert "step     4 loss" in second and "step     3 loss" not in second
    assert resumed.step == straight.step == 6
    for a, b in zip(tree_leaves(resumed), tree_leaves(straight)):
        assert (a == b) if not isinstance(a, torch.Tensor) \
            else torch.equal(a, b)
    with pytest.raises(ValueError, match="1 devices cannot keep TP=2"):
        train_cli.main(base + ["--model-parallel", "2"])
    with pytest.raises(ValueError, match="1 devices cannot keep TP=2"):
        jelastic.plan_mesh(1, 2)
