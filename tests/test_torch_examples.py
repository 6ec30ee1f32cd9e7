"""The port's examples (``repro_torch.examples``) against the reference's.

``quickstart`` and ``resilience_study --probe similarity`` run on the
reference's params, latents and flip masks (``JaxReplayFlipSource``)
against the numbers the reference's own examples compute, loaded from
``examples/`` (the quickstart's three sampler compiles take most of this
module's time; the other probes are held in ``test_torch_resilience``).
``train_dit`` trains the SMOKE DiT 3 steps from the
reference's initial state against the reference's loss and AdamW
(``test_torch_train``'s recipe); ``drift_serve`` serves on the CPU.
"""
import dataclasses
import importlib.util
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import dit_xl_512 as jdit_cfgs
from repro.data import synthetic as jsynthetic
from repro.optim import adamw as joptim
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.configs import dit_xl_512 as dit_cfgs
from repro_torch.data import synthetic
from repro_torch.examples import (drift_serve, quickstart,
                                  resilience_study, train_dit)
from repro_torch.models import dit
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.tree import tree_leaves

from test_torch_core import JaxReplayFlipSource
from test_torch_train import jax_loss

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3               # quickstart's denoising steps, on both sides



def _reference_example(name: str):
    """The reference's ``examples/<name>.py``, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ drift_serve
@pytest.mark.parametrize("arch", ["dit-xl-512", "olmo-1b"])
def test_drift_serve_on_cpu(arch, capsys):
    """``drift_serve --device cpu``, 2 requests at bucket 2: it runs to
    the end, its self-checks (one sampler build per configuration and
    clean reference) hold, and every request comes back."""
    results = drift_serve.main(["--arch", arch, "--device", "cpu",
                                "--requests", "2", "--batch", "2",
                                "--steps", "3", "--op", "undervolt"])
    out = capsys.readouterr().out
    assert len(results) == 2
    assert "sampler cache verified" in out
    assert "2 sampler builds for 1 drift configs (+1 clean)" in out
    if arch == "olmo-1b":
        assert all(r.token_match_vs_clean == 1.0 for r in results)


def test_drift_serve_flags_cover_the_reference():
    """Every flag of the reference example, plus ``--device`` and
    ``--smoke/--no-smoke``."""
    ref = _reference_example("drift_serve")

    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}
    assert flags(drift_serve.build_parser()) == flags(ref.build_parser()) | {
        "--device", "--smoke", "--no-smoke"}


# ------------------------------------------------------------ train_dit
def test_train_100m_matches_reference():
    """``TRAIN_100M``'s fields ``==`` the reference's (dtypes by name;
    ``scan_layers`` and ``remat`` are JAX compile switches the port's
    config does not carry)."""
    got = {f.name: getattr(dit_cfgs.TRAIN_100M, f.name)
           for f in dataclasses.fields(dit_cfgs.TRAIN_100M)}
    want = {f.name: getattr(jdit_cfgs.TRAIN_100M, f.name)
            for f in dataclasses.fields(jdit_cfgs.TRAIN_100M)
            if f.name not in ("scan_layers", "remat")}
    for k in ("dtype", "param_dtype"):
        got[k] = str(got[k]).replace("torch.", "")
        want[k] = jnp.dtype(want[k]).name
    assert got == want


def test_train_dit_losses_match_reference(tmp_path):
    """``train_dit.train`` at SMOKE, batch 2, 3 steps from the
    reference's initial state on the reference's step-0 batch, saving
    every 2 steps: each loss within 2e-5 relative of the reference's loss
    at the reference's params after the reference's AdamW steps, with the
    diffusion draws the port's step makes (``test_torch_train``'s
    recipe); the last save restores bit-equal."""
    jcfg = jconfigs.get_config("dit-xl-512", smoke=True)
    cfg = configs.get_config("dit-xl-512", smoke=True)
    kw = dict(lr=2e-4, warmup_steps=20, total_steps=3)
    jocfg = joptim.OptimConfig(**kw)
    jstate = jax.jit(lambda k: jsteps.init_train_state(jcfg, jocfg, k))(
        jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jstate.params)
    jbatch = jax.tree.map(np.asarray, jsynthetic.batch_at(
        jsynthetic.for_model(jcfg, 2, seed=7), 0))
    batch = {k: torch.from_numpy(np.array(v)).long() if v.dtype.kind == "i"
             else torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    ocfg = adamw.OptimConfig(**kw)
    params = dit.params_from_jax(np_params)
    state = steps.TrainState(params, adamw.init(ocfg, params), 0, 7)
    mgr = train_dit.CheckpointManager(str(tmp_path), keep_last=2)
    final, losses = train_dit.train(cfg, ocfg, state, lambda _: batch, 3,
                                    mgr, ckpt_every=2, log=lambda _: None)

    jp, jopt = jstate.params, jstate.opt
    grad = jax.jit(jax.value_and_grad(
        lambda p, t, e: jax_loss(jcfg, p, jbatch, t, e), has_aux=True))
    update = jax.jit(lambda o, p, g: joptim.apply(jocfg, o, p, g))
    want = []
    for i in range(3):
        gen = synthetic.generator(7, i)
        t = torch.randint(0, 1000, (2,), generator=gen).numpy()
        eps = torch.randn((2, 8, 8, 4), generator=gen).numpy()
        (loss, _), g = grad(jp, t.astype(np.int32), eps)
        want.append(float(loss))
        jp, jopt, _ = update(jopt, jp, g)
    np.testing.assert_allclose(losses, want, rtol=2e-5)
    assert final.step == 3 and mgr.steps() == [2, 3]
    step, restored, _ = mgr.restore_latest(final)
    assert step == 3 and restored.step == 3
    for a, b in zip(tree_leaves(restored.params), tree_leaves(final.params)):
        assert torch.equal(a, b)


# ------------------------------------------------------ resilience_study
def test_similarity_matches_reference(capsys):
    """The Fig 2(b) probe on the reference's ``tiny_model`` and
    ``sample_inputs``: each cosine similarity within 1.5e-4 of the value
    the reference's probe prints (4 decimals, plus 1e-4 for XLA's and
    PyTorch's summation orders)."""
    sys.path.insert(0, str(ROOT))
    from benchmarks.common import sample_inputs, tiny_model
    _reference_example("resilience_study").probe_similarity()
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "step_pair,cos_similarity(eps)"
    want = [float(ln.split(",")[1]) for ln in lines[1:]]
    jcfg, jparams = tiny_model("dit-xl-512")
    lat0, cond, _ = sample_inputs(jcfg)
    cfg = configs.get_config("dit-xl-512", smoke=True)
    got = resilience_study.similarities(
        cfg, dit.params_from_jax(jax.tree.map(np.asarray, jparams)),
        torch.from_numpy(np.array(lat0)),
        torch.from_numpy(np.array(cond)).long())
    assert len(got) == len(want) == resilience_study.STEPS - 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1.5e-4)


# ------------------------------------------------------------ quickstart
def test_quickstart_matches_reference(monkeypatch, capsys):
    """``quickstart.compare`` at STEPS, on the reference quickstart's
    params and latents and its flip masks (run key ``PRNGKey(0)``),
    against the reference quickstart's ``main`` at STEPS (its
    ``lpips_proxy`` wrapped to hand back the values unrounded): the
    corrected count equal and both lpips-proxy values within 1e-3
    relative plus 1e-8 (the latents agree within ~1e-5; lpips is a
    difference of them)."""
    ref = _reference_example("quickstart")
    lpips = []
    real = ref.metrics
    monkeypatch.setattr(ref, "STEPS", STEPS)
    monkeypatch.setattr(ref, "metrics", types.SimpleNamespace(
        lpips_proxy=lambda a, b: lpips.append(float(real.lpips_proxy(a, b)))
        or lpips[-1]))
    ref.main()
    corrected = int(capsys.readouterr().out.split("(corrected ")[1].split()[0])

    monkeypatch.setattr(quickstart, "STEPS", STEPS)
    jcfg = jconfigs.get_config("dit-xl-512", smoke=True)
    key = jax.random.PRNGKey(0)
    p = jsteps.init_model_params(jcfg, key)
    p["blocks"]["adaln_w"] = 0.1 * jax.random.normal(
        jax.random.fold_in(key, 1), p["blocks"]["adaln_w"].shape)
    p["final_w"] = 0.2 * jax.random.normal(jax.random.fold_in(key, 2),
                                           p["final_w"].shape)
    lat0 = jax.random.normal(jax.random.fold_in(key, 3),
                             (2, jcfg.latent_size, jcfg.latent_size,
                              jcfg.latent_channels))
    cfg = configs.get_config("dit-xl-512", smoke=True)
    got = quickstart.compare(
        cfg, dit.params_from_jax(jax.tree.map(np.asarray, p)),
        torch.from_numpy(np.array(lat0)), torch.tensor([1, 2]),
        JaxReplayFlipSource(key))
    assert got["corrected"] == corrected > 0
    np.testing.assert_allclose([got["faulty_lpips"], got["drift_lpips"]],
                               lpips, rtol=1e-3, atol=1e-8)
    assert lpips[0] > lpips[1]
