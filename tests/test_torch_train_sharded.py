"""Training across CPU ranks: the port's side of the reference's
multi-device training (``repro.launch.train`` on a mesh,
``sharding.shardings_for`` over a ``TrainState``,
``CheckpointManager.restore_resharded``, ``optim.compression`` and
``launch.mesh``).

The reference's own multi-device launcher fails under jax 0.9.0, so the
mesh path is held against the port's one-process step, the reference's
one-device ``make_train_step`` pieces and its ``param_specs`` on
``AbstractMesh``es; GSPMD computes on a mesh what the unsharded step
computes, so those are the yardsticks.

Each group of ranks is spawned once per module (``spawn`` processes, gloo
over a ``file://`` rendezvous under ``tmp_path``, one torch thread each,
every collective timing out after ``TIMEOUT_S``): a pair (the (1, 2) and
(2, 1) meshes over one world of 2) and a quad (the (2, 2) mesh, the debug
and production meshes, a (pod 2, data 2, model 1) mesh). Every rank runs
its scenario and saves what it computed; the tests hold it against one
process run here on one thread, as each rank runs.

The MoE family on a data axis routes the global batch
(``models.moe.moe_layer``): besides the whole train step, each group runs
one MoE layer on 128 tokens a block of rows (T = 256 on 2 blocks, 512 on
4) with a router skewed toward one expert, where a rank routing its own
rows alone would drop assignments the global route keeps.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.launch import mesh as jmesh
from repro.models import dit as jdit
from repro.models import transformer as jtf
from repro.optim import adamw as joptim
from repro.optim import compression as jcomp
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import synthetic
from repro_torch.distributed import constraints, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as train_cli
from repro_torch.models import dit, encdec, moe, transformer
from repro_torch.optim import adamw, compression
from repro_torch.train import steps
from repro_torch.tree import tree_leaves, tree_map

# one arch per family, trained on the model axis
FAMILY_ARCHS = ("olmo-1b", "deepseek-moe-16b", "mamba2-370m", "hymba-1.5b",
                "internvl2-76b", "whisper-base", "dit-xl-512", "sd15-unet")
# trained on the data axis: an LM, a diffusion model (its draws are
# global), the enc-dec model, the MoE family (its routing is global)
MOE_ARCHS = ("deepseek-moe-16b", "kimi-k2-1t-a32b")
DATA_ARCHS = ("olmo-1b", "dit-xl-512", "whisper-base") + MOE_ARCHS
# (arch, group): every data arch on the pair's (2, 1) and the quad's
# (2, 2); the MoE archs also on the quad's (pod 2, data 2, model 1)
DATA_CASES = ([(a, g) for a in DATA_ARCHS for g in ("pair", "quad")]
              + [(a, "pod") for a in MOE_ARCHS])
# the MoE layer test: MOE_ROWS tokens a block of rows, E = 8, top-3,
# capacity factor 1.0: the capacity is 64 for a rank's 128 tokens, 128 for
# T = 256 (2 blocks) and 192 for T = 512 (4 blocks)
MOE_ROWS, MOE_SEED = 128, 11
BATCH, SEQ, STEPS, SEED = 4, 16, 2, 7
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TIMEOUT_S = 120                  # per collective
JOIN_S = 300                     # per group
ROOT = Path(__file__).resolve().parents[1]
# the data axis against one process (f32; a half batch's mean summed
# over 2 ranks against the whole batch's): loss and gradient norm within
# DATA_RTOL relative, each gradient leaf within DATA_RTOL of the leaf's
# largest magnitude plus 1e-7 of the largest gradient anywhere
DATA_RTOL = 1e-5


# ---------------------------------------------------------------- shared
def nudge(params, seed: int):
    """Seeded small values for every all-zero weight of rank >= 2 (the
    diffusion models' adaLN-Zero and output weights)."""
    g = torch.Generator()
    g.manual_seed(seed)

    def one(t):
        if t.ndim >= 2 and not bool(t.any()):
            return 0.05 * torch.randn(t.shape, generator=g)
        return t
    return tree_map(one, params)


def init_state(arch: str, params=None, kind: str = "adamw"):
    """(cfg, optim cfg, state) at SMOKE from the port's init (nudged), or
    from ``params``."""
    cfg = configs.get_config(arch, smoke=True)
    ocfg = adamw.OptimConfig(kind=kind, **OCFG)
    if params is None:
        params = nudge(steps.init_model_params(cfg, 3, "cpu"), 5)
    return cfg, ocfg, steps.TrainState(params, adamw.init(ocfg, params), 0,
                                       SEED)


def batches(cfg, n: int = STEPS):
    """The global batches of steps 0..n-1, seeded ``vis_embeds`` for the
    VLM."""
    dcfg = synthetic.for_model(cfg, BATCH, SEQ, seed=1)
    out = [synthetic.batch_at(dcfg, i) for i in range(n)]
    if cfg.family == "vlm":
        g = synthetic.generator(9)
        for b in out:
            b["vis_embeds"] = 0.1 * torch.randn(
                (BATCH, cfg.vis_tokens, cfg.d_model), generator=g)
    return out


def whole(tree, mesh):
    """``tree`` gathered whole, each leaf a tensor of its own."""
    from repro_torch.distributed import constraints
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, constraints.gather(tree, mesh))


def bits(t) -> int:
    return int(t.detach().float().reshape(1).view(torch.int32))


# ---------------------------------------------------------------- ranks
def _model_axis(mesh, arch: str, kind: str = "adamw"):
    cfg, ocfg, state = init_state(arch, kind=kind)
    step = steps.make_train_step(cfg, ocfg, mesh=mesh)
    st = sharding.shard_state(state, mesh)
    metrics = []
    for b in batches(cfg):
        st, m = step(st, b)
        metrics.append((bits(m["loss"]), bits(m["grad_norm"])))
    return dict(state=whole(st, mesh), metrics=metrics)


def _data_axis(mesh, tmp: str, arch: str):
    params = torch.load(f"{tmp}/params_{arch}.pt", weights_only=False)
    cfg, ocfg, state = init_state(arch, params)
    step = steps.make_train_step(cfg, ocfg, mesh=mesh)
    st = sharding.shard_state(state, mesh)
    rec = []
    for b in batches(cfg):
        before = whole(st.params, mesh)
        _, loss, _, grads = steps.sharded_value_and_grad(cfg, st, b, mesh)
        st, m = step(st, b)
        rec.append(dict(before=before, loss=loss, grads=grads,
                        metrics=(bits(m["loss"]), bits(m["grad_norm"]))))
    # one process's gradient of the first batch, applied on the blocks
    _, _, g1 = steps.value_and_grad(cfg, params, batches(cfg)[0],
                                    synthetic.generator(SEED, 0))
    st0 = sharding.shard_state(state, mesh)
    new_p, new_opt, _ = steps.sharded_update(ocfg, st0, g1,
                                             adamw.global_norm(g1), mesh)
    return dict(steps=rec, update=whole((new_p, new_opt), mesh),
                final=whole(st, mesh))


def moe_layer_inputs(t: int):
    """(cfg, params, x, c) of the MoE layer test at ``t`` tokens, from
    seeds: SMOKE deepseek-moe-16b at capacity factor 1.0 (its experts
    drawn by ``init_moe_params``); x (t, d) with a constant offset that
    the router's column 0 reads, so most tokens pick expert 0 and the
    capacity drops some of them; c, the weights of the objective
    ``(y c).sum()``."""
    cfg = dataclasses.replace(configs.get_config("deepseek-moe-16b",
                                                 smoke=True),
                              capacity_factor=1.0)
    g = torch.Generator()
    g.manual_seed(MOE_SEED)
    params = moe.init_moe_params(cfg, g)
    rng = np.random.default_rng(MOE_SEED)
    d = cfg.d_model
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    router = rng.standard_normal((d, cfg.n_experts)) / np.sqrt(d)
    router[:, 0] += 4.0 / d
    params["router"] = f32(router)
    x = f32(rng.standard_normal((t, d)) + 0.5)
    c = f32(rng.standard_normal((t, d)))
    return cfg, params, x, c


def routing_ints(r: moe.Routing):
    return dict(flat_e=r.flat_e, rank=r.rank, keep=r.keep, slot=r.slot,
                capacity=r.capacity)


def _moe_layer(mesh):
    """One MoE layer on this rank's block of the test's tokens inside
    ``split_rows(mesh)``: its rows of ``y``, the aux loss, the gradients
    of ``(y c).sum() + aux`` (its rows of ``c``) with respect to the
    params and its rows of x, the gathered tokens and their routing."""
    i, n = constraints.data_block(mesh)
    cfg, params, x, c = moe_layer_inputs(MOE_ROWS * n)
    rows = slice(i * MOE_ROWS, (i + 1) * MOE_ROWS)
    live = [t.requires_grad_(True) for t in tree_leaves(params)]
    xr = x[rows].clone().requires_grad_(True)
    with constraints.split_rows(mesh):
        y, aux = moe.moe_layer(cfg, params, xr)
    grads = torch.autograd.grad((y * c[rows]).sum() + aux, live + [xr])
    with torch.no_grad():
        seen = constraints.gather_rows_grad(x[rows], mesh)
    return dict(rows=(rows.start, rows.stop), y=y.detach(),
                aux=aux.detach(), grads=list(grads[:-1]), x_grad=grads[-1],
                gathered=seen,
                routing=routing_ints(moe.route(cfg, params["router"], seen)))


def _restore(m21, m12, tmp: str):
    """2 steps on (2, 1), saved; restored onto (1, 2), step 3; and a
    corrupt newest step falling back."""
    cfg, ocfg, state = init_state("olmo-1b")
    bs = batches(cfg, 3)
    step21 = steps.make_train_step(cfg, ocfg, mesh=m21)
    st = sharding.shard_state(state, m21)
    st1, _ = step21(st, bs[0])
    st2, _ = step21(st1, bs[1])
    mgr = CheckpointManager(f"{tmp}/ck")
    mgr.save(2, st2, extra={"data_step": 2}, mesh=m21)
    template = sharding.shard_state(init_state("olmo-1b")[2], m12)
    got, restored, extra = mgr.restore_resharded(template, m12)
    shard_specs = {s.spec for s in tree_leaves(restored)
                   if isinstance(s, sharding.Shard)}
    st3, _ = steps.make_train_step(cfg, ocfg, mesh=m12)(restored, bs[2])
    bad = CheckpointManager(f"{tmp}/bad")
    bad.save(1, st1, mesh=m21)
    bad.save(2, st2, mesh=m21)
    if m21.rank == 0:
        leaf = f"{tmp}/bad/step_00000002/leaf_00000.npy"
        np.save(leaf, np.zeros_like(np.load(leaf)))
    m21.barrier()
    fb_step, fb, _ = bad.restore_resharded(template, m12)
    return dict(saved=whole(st2, m21), step=got, extra=extra,
                restored=whole(restored, m12), step3=whole(st3, m12),
                specs=shard_specs, fallback_step=fb_step,
                fallback=whole(fb, m12), at_step1=whole(st1, m21),
                ck=f"{tmp}/ck")


def _grads_of(rank: int):
    rng = np.random.default_rng(100 + rank)
    w = (1e-3 * rng.standard_normal((33, 17))).astype(np.float32)
    # keys in sorted order: leaves in the order jax.tree.leaves gives
    return {"b": [torch.from_numpy(rng.standard_normal(7).astype(
                np.float32))], "w": torch.from_numpy(w)}


def _compress(mesh, axis: str):
    g = _grads_of(mesh.rank)
    red1, e1 = compression.allreduce_compressed(
        g, compression.init_error_buffer(g), mesh, axis)
    red2, e2 = compression.allreduce_compressed(g, e1, mesh, axis)
    return dict(coords=dict(mesh.coords), red=[red1, red2], err=[e1, e2])


def _meshes(rank: int):
    dbg = mesh_lib.make_debug_mesh(model=2, device="cpu")
    try:
        mesh_lib.make_production_mesh(device="cpu")
        prod = None
    except ValueError as e:
        prod = str(e)
    pod = mesh_lib.make_mesh((2, 2, 1), ("pod", "data", "model"),
                             device="cpu")
    sums = {}
    for name, group in (("data_group", pod.data_group),
                        ("pod", pod.group("pod")),
                        ("data", pod.group("data"))):
        t = torch.tensor([float(rank)])
        pod.all_reduce(t, group=group)
        sums[name] = float(t)
    return dict(debug=(dict(dbg.shape), dbg.axis_names, dict(dbg.coords)),
                production_error=prod, pod_coords=dict(pod.coords),
                pod_sums=sums), pod


def _rank_main(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    kw = dict(device="cpu", init_method=f"file://{tmp}/rdzv", rank=rank,
              world_size=world, timeout_s=TIMEOUT_S)
    out = {}
    if world == 2:
        m12 = mesh_lib.make_mesh((1, 2), ("data", "model"), **kw)
        m21 = mesh_lib.make_mesh((2, 1), ("data", "model"), **kw)
        out["model_axis"] = {a: _model_axis(m12, a) for a in FAMILY_ARCHS}
        out["adafactor"] = _model_axis(m12, "olmo-1b", "adafactor")
        out["data_axis"] = {a: _data_axis(m21, tmp, a) for a in DATA_ARCHS}
        out["moe_layer"] = _moe_layer(m21)
        out["restore"] = _restore(m21, m12, tmp)
        out["compress"] = _compress(m21, "data")
        out["collectives"] = m21.collectives + m12.collectives
    else:
        m22 = mesh_lib.make_mesh((2, 2), ("data", "model"), **kw)
        out["data_axis"] = {a: _data_axis(m22, tmp, a) for a in DATA_ARCHS}
        out["moe_layer"] = _moe_layer(m22)
        out["meshes"], pod = _meshes(rank)
        out["compress"] = _compress(pod, "pod")
        out["data_axis_pod"] = {a: _data_axis(pod, tmp, a)
                                for a in MOE_ARCHS}
        out["moe_layer_pod"] = _moe_layer(pod)
    torch.save(out, f"{tmp}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


def run_group(tmp_path, world: int):
    """Spawn ``world`` ranks, wait for all, return every rank's record."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, codes
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# ------------------------------------------------------------ reference
def jax_params(arch: str):
    """The reference's SMOKE init as numpy, the diffusion models' all-zero
    weights of rank >= 2 given 0.05-scaled seeded normals."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    p = jax.tree.map(np.asarray, jsteps.init_model_params(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(100)

    def one(a):
        if a.ndim >= 2 and not a.any():
            return (0.05 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(one, p) if jcfg.family == "dit" else p


def port_params(cfg, tree):
    if cfg.family == "encdec":
        return encdec.params_from_jax(tree)
    if cfg.family == "dit":
        return dit.params_from_jax(tree)
    return transformer.params_from_jax(tree)


def jax_grads(arch: str, np_params, batch):
    """The reference's loss and gradient on ``batch`` (the port's numbers
    as numpy); the DiT's from ``q_sample`` and ``forward`` with the draws
    the port's step makes (``generator(SEED, 0)``)."""
    from repro.diffusion import schedule as jsched
    jcfg = jconfigs.get_config(arch, smoke=True)
    b = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    def loss(p):
        if jcfg.family == "dit":
            gen = synthetic.generator(SEED, 0)
            t = torch.randint(0, 1000, (BATCH,), generator=gen)
            eps = torch.randn(tuple(batch["latents"].shape), generator=gen)
            t, eps = jnp.asarray(t.numpy().astype(np.int32)), \
                jnp.asarray(eps.numpy())
            x_t = jsched.DdpmSchedule.default(1000).q_sample(
                b["latents"], t, eps)
            pred = jdit.forward(jcfg, p, x_t, t.astype(jnp.float32),
                                b["labels"])[0]
            return jnp.mean((pred - eps) ** 2)
        if jcfg.family == "encdec":
            return jsteps._encdec_loss(jcfg, p, b)[0]
        return jsteps._lm_loss(jcfg, p, b)[0]
    l, g = jax.jit(jax.value_and_grad(loss))(
        jax.tree.map(jnp.asarray, np_params))
    return float(l), jax.tree.map(np.asarray, g)


@pytest.fixture(scope="module")
def data_params(tmp_path_factory):
    """The reference's SMOKE params of each data-axis arch, in the port's
    layout, saved where the ranks load them."""
    out = {}
    for arch in DATA_ARCHS:
        np_params = jax_params(arch)
        out[arch] = (np_params, port_params(
            configs.get_config(arch, smoke=True), np_params))
    return out


def _save_params(tmp, data_params):
    for arch, (_, params) in data_params.items():
        torch.save(params, tmp / f"params_{arch}.pt")


@pytest.fixture(scope="module")
def pair(tmp_path_factory, data_params):
    tmp = tmp_path_factory.mktemp("pair")
    _save_params(tmp, data_params)
    return run_group(tmp, 2)


@pytest.fixture(scope="module")
def quad(tmp_path_factory, data_params):
    tmp = tmp_path_factory.mktemp("quad")
    _save_params(tmp, data_params)
    return run_group(tmp, 4)


def one_thread(fn):
    """``fn`` run on one torch thread, as each rank runs."""
    @functools.wraps(fn)
    def run(*a, **kw):
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return fn(*a, **kw)
        finally:
            torch.set_num_threads(n)
    return run


def assert_equal_trees(got, want, label):
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b), label
    for i, (x, y) in enumerate(zip(a, b)):
        if isinstance(y, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), (label, i)
        else:
            assert x == y, (label, i)


def assert_tree_close(got, want, rtol, floor, label):
    """Leaf by leaf: |got - want| <= rtol max|want of the leaf| + floor
    max|want of every leaf|."""
    a = [t.float() for t in tree_leaves(got)]
    b = [torch.as_tensor(np.asarray(t, np.float32)) for t in
         tree_leaves(want)]
    assert len(a) == len(b), label
    top = max(float(t.abs().max()) for t in b if t.numel())
    for i, (x, y) in enumerate(zip(a, b)):
        lim = rtol * float(y.abs().max()) + floor * top + 1e-30
        err = float((x - y).abs().max())
        assert err <= lim, (label, i, tuple(y.shape), err, lim)


# ------------------------------------------------------------------ specs
SPEC_MESHES = {
    "data2_model2": AbstractMesh((2, 2), ("data", "model")),
    "data16_model16": AbstractMesh((16, 16), ("data", "model")),
    "pod2_data16_model16": AbstractMesh((2, 16, 16),
                                        ("pod", "data", "model")),
}


def _mirror(tree):
    """The port's tree as ShapeDtypeStructs in the same containers."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _mirror(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_mirror(v) for v in tree]
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.dtype(
        str(tree.dtype).replace("torch.", "")))


def _assert_specs(got, want, path="") -> int:
    """Spec trees equal; returns the leaves compared."""
    if isinstance(want, P):
        assert type(got) is tuple and got == tuple(want), (path, got, want)
        return 1
    if want is None:
        assert got is None, path
        return 0
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        return sum(_assert_specs(got[k], want[k], f"{path}/{k}")
                   for k in want)
    assert len(got) == len(want), path
    return sum(_assert_specs(g, w, f"{path}/{i}")
               for i, (g, w) in enumerate(zip(got, want)))


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", sorted(configs._MODULES))
def test_state_specs_match_reference(arch, kind):
    """``state_specs`` of a SMOKE train state `==` the reference's
    ``param_specs`` of its ``TrainState`` (the same tree as
    ShapeDtypeStructs, the reference's ``optim.init`` giving the moments'
    shapes) on (2, 2), (16, 16) and (2, 16, 16): params and AdamW moments
    by their param's rule, Adafactor's factored leaves with the rule's
    fix-up for their own shapes, the steps replicated, and the port's
    host-int seed replicated as the reference's key is."""
    cfg, _, state = init_state(arch, kind=kind)
    jparams = _mirror(state.params)
    jopt = jax.eval_shape(functools.partial(
        joptim.init, joptim.OptimConfig(kind=kind)), jparams)
    jstate = jsteps.TrainState(jparams, jopt,
                               jax.ShapeDtypeStruct((), jnp.int32),
                               jax.ShapeDtypeStruct((2,), jnp.uint32))
    for name, mesh in SPEC_MESHES.items():
        got = sharding.state_specs(state, mesh)
        want = jshd.param_specs(jstate, mesh)
        n = _assert_specs(got.params, want.params, f"{name} params")
        n += _assert_specs(got.opt, want.opt, f"{name} opt")
        assert n >= 3 * len(tree_leaves(state.params))
        assert got.step == tuple(want.step) == ()
        assert got.seed == () and tuple(want.rng) == (None,)


# ------------------------------------------------------------ compression
def _np_tree(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def test_compress_matches_reference():
    """``compress`` and ``decompress`` on numpy-seeded gradients (a
    (64, 48) leaf at 1e-3 and a (7,) leaf, with a seeded error buffer):
    ``q`` and the scales bit-equal to the reference's, the error buffer
    within one f32 ulp (XLA may contract ``gf - q * scale`` into an fma),
    the dequantized gradient bit-equal."""
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    # keys in sorted order: leaves in the order jax.tree.leaves gives
    g = {"b": [f32(rng.standard_normal(7))],
         "w": f32(1e-3 * rng.standard_normal((64, 48)))}
    e = {"b": [f32(1e-3 * rng.standard_normal(7))],
         "w": f32(1e-6 * rng.standard_normal((64, 48)))}
    q, s, ne = compression.compress(g, e)
    jq, js, je = jcomp.compress(_np_tree(g), _np_tree(e))
    for a, b in zip(tree_leaves(q), jax.tree.leaves(jq)):
        assert a.dtype == torch.int8
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tree_leaves(s), jax.tree.leaves(js)):
        assert np.asarray(a.numpy()).view(np.int32) == \
            np.asarray(b).view(np.int32)
    for a, b in zip(tree_leaves(ne), jax.tree.leaves(je)):
        ulps = np.abs(a.numpy().view(np.int32).astype(np.int64)
                      - np.asarray(b).view(np.int32).astype(np.int64))
        assert ulps.max() <= 1
    for a, b in zip(tree_leaves(compression.decompress(q, s)),
                    jax.tree.leaves(jcomp.decompress(jq, js))):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert all(torch.equal(z, torch.zeros_like(x)) for z, x in zip(
        tree_leaves(compression.init_error_buffer(g)), tree_leaves(g)))


def test_compression_error_feedback():
    """The reference's property: 20 rounds of compress/decompress with the
    error buffer carried sum to 20 times the gradient within 1%."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 64)).astype(np.float32))}
    err = compression.init_error_buffer(g)
    total = torch.zeros((64, 64))
    for _ in range(20):
        q, s, err = compression.compress(g, err)
        total = total + compression.decompress(q, s)["w"]
    rel = float(torch.linalg.norm(total - 20 * g["w"])
                / torch.linalg.norm(20 * g["w"]))
    assert rel < 0.01


def _reference_allreduce(grads, errs):
    """The reference's ``allreduce_compressed`` under ``jax.vmap`` over
    the stacked per-rank gradients and error buffers."""
    stack = lambda trees: jax.tree.map(  # noqa: E731
        lambda *xs: jnp.stack([jnp.asarray(x.numpy()) for x in xs]), *trees)
    fn = jax.vmap(lambda g, e: jcomp.allreduce_compressed(g, e, "ax"),
                  axis_name="ax")
    return fn(stack(grads), stack(errs))


@pytest.mark.parametrize("group,axis", [("pair", "data"), ("quad", "pod")])
def test_allreduce_compressed_matches_reference(group, axis, request):
    """``allreduce_compressed`` over a mesh axis of 2 ranks (the (2, 1)
    mesh's ``data``; the (2, 2, 1) mesh's ``pod``, two groups of 2), two
    rounds with the error buffer carried, against the reference under
    ``jax.vmap`` with an axis name: every rank's reduced gradient
    bit-equal (so its int32 sum is: each sum maps to one product with the
    axis's scale), the error buffer within one ulp."""
    ranks = request.getfixturevalue(group)
    others = [a for a in ranks[0]["compress"]["coords"] if a != axis]
    groups = {}
    for r, rec in enumerate(ranks):
        key = tuple(rec["compress"]["coords"][a] for a in others)
        groups.setdefault(key, []).append(r)
    assert len(groups) == (1 if group == "pair" else 2)
    for members in groups.values():
        assert len(members) == 2
        grads = [_grads_of(r) for r in members]
        errs = [compression.init_error_buffer(g) for g in grads]
        for rnd in range(2):
            red, ne = _reference_allreduce(grads, errs)
            for i, r in enumerate(members):
                got = ranks[r]["compress"]
                for a, b in zip(tree_leaves(got["red"][rnd]),
                                jax.tree.leaves(red)):
                    assert np.array_equal(a.numpy(), np.asarray(b)[i])
                for a, b in zip(tree_leaves(got["err"][rnd]),
                                jax.tree.leaves(ne)):
                    ulps = np.abs(a.numpy().view(np.int32).astype(np.int64)
                                  - np.asarray(b)[i].view(np.int32))
                    assert ulps.max() <= 1
            errs = [ranks[r]["compress"]["err"][rnd] for r in members]


# ----------------------------------------------------------------- meshes
def test_debug_and_production_meshes_match_reference(monkeypatch):
    """``make_debug_mesh`` and ``make_production_mesh`` ask for the
    reference's shapes and axes (both sides' ``make_mesh`` captured), and
    the production mesh refuses a world of 4 before any process group
    starts, naming the ranks it needs."""
    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    monkeypatch.setattr(mesh_lib, "make_mesh",
                        lambda shape, axes, **kw: (tuple(shape),
                                                   tuple(axes)))
    for multi_pod in (False, True):
        assert mesh_lib.make_production_mesh(multi_pod=multi_pod) == \
            jmesh.make_production_mesh(multi_pod=multi_pod)
    for n in (1, 2, 4, 8, 16):
        monkeypatch.setattr(jmesh.jax, "devices", lambda n=n: [None] * n)
        for model in (1, 2, 4):
            assert mesh_lib.make_debug_mesh(model, world_size=n) == \
                jmesh.make_debug_mesh(model)
    monkeypatch.undo()
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {need} ranks; the "
                                             "world has 4"):
            mesh_lib.make_production_mesh(multi_pod=multi_pod, device="cpu",
                                          world_size=4, rank=0)
    assert not torch.distributed.is_initialized()


def test_meshes_on_four_ranks(quad):
    """On 4 ranks: the debug mesh is (data 2, model 2) with rank r at
    (r // 2, r % 2); the production mesh raises; a (pod 2, data 2, model
    1) mesh places rank r at (r // 2, r % 2, 0), its data group holds the
    (pod, data) ranks of one model index (all 4) and its axis groups the
    ranks that differ only along the axis."""
    for r, rec in enumerate(quad):
        m = rec["meshes"]
        assert m["debug"] == ({"data": 2, "model": 2}, ("data", "model"),
                              {"data": r // 2, "model": r % 2})
        assert "needs 256 ranks; the world has 4" in m["production_error"]
        assert m["pod_coords"] == {"pod": r // 2, "data": r % 2, "model": 0}
        assert m["pod_sums"] == {"data_group": 6.0,
                                 "pod": float(2 * (r % 2) + 2),
                                 "data": float(4 * (r // 2) + 1)}


# ------------------------------------------------------------- the steps
@one_thread
def _one_process(arch: str, kind: str = "adamw"):
    cfg, ocfg, state = init_state(arch, kind=kind)
    step = steps.make_train_step(cfg, ocfg)
    metrics = []
    for b in batches(cfg):
        state, m = step(state, b)
        metrics.append((bits(m["loss"]), bits(m["grad_norm"])))
    return state, metrics


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_model_axis_bit_equal_to_one_process(arch, pair):
    """(data 1, model 2): 2 AdamW steps at SMOKE, global batch 4, every
    rank computing the whole batch on the gathered params and updating its
    block: the params and moments gathered whole, the loss and gradient
    norm, `torch.equal` to one process's, on every rank (the MoE family
    included: on the model axis its routing sees every token)."""
    state, metrics = _one_process(arch)
    for rec in pair:
        got = rec["model_axis"][arch]
        assert got["metrics"] == metrics
        assert_equal_trees(got["state"], state, arch)


def test_adafactor_on_the_model_axis_bit_equal_to_one_process(pair):
    """Adafactor's factored statistics span whole tensors, so the mesh
    applies it to the gathered state and keeps its blocks: 2 steps of
    SMOKE olmo-1b on (data 1, model 2), the params and factored moments
    gathered whole, the loss and gradient norm, `torch.equal` to one
    process's."""
    state, metrics = _one_process("olmo-1b", "adafactor")
    assert state.opt.vr is not None and state.opt.mu is None
    for rec in pair:
        assert rec["adafactor"]["metrics"] == metrics
        assert_equal_trees(rec["adafactor"]["state"], state, "adafactor")


@one_thread
def _value_and_grad(cfg, params, batch, step: int):
    return steps.value_and_grad(cfg, params, batch,
                                synthetic.generator(SEED, step))


# arch -> the reference's loss and gradient on the first batch
_JAX_FIRST = {}
# group -> (fixture, key of the ranks' data-axis records)
DATA_GROUPS = {"pair": ("pair", "data_axis"), "quad": ("quad", "data_axis"),
               "pod": ("quad", "data_axis_pod")}


@pytest.mark.parametrize("arch,group", DATA_CASES)
def test_data_axis_matches_one_process_and_reference(arch, group,
                                                     data_params, request):
    """(data 2, model 1) and (data 2, model 2), global batch 4 split 2 and
    2, and for the MoE family (pod 2, data 2, model 1), split 1, 1, 1, 1,
    from the reference's SMOKE init (the MoE layers routing the global
    batch, the aux loss global):
    - at each of 2 steps, the loss and the gradient (summed over the data
      axis, divided by 2) within DATA_RTOL of one process's on the same
      params (the mesh's, gathered before the step);
    - at the first step, within PR 23's limits of the reference's
      ``value_and_grad``: the loss and gradient norm 2e-5 relative, each
      leaf 2e-4 relative plus 2e-4 of the leaf's largest magnitude plus
      1e-6 of the largest anywhere;
    - one process's gradient of the first batch, applied by the mesh on
      each rank's block, gathered: `torch.equal` to one process's AdamW;
    - the replicated values (metrics, the final state gathered, every
      recorded gradient) identical on every rank."""
    fixture, key = DATA_GROUPS[group]
    ranks = request.getfixturevalue(fixture)
    np_params, params = data_params[arch]
    cfg, ocfg, state = init_state(arch, params)
    bs = batches(cfg)
    first = ranks[0][key][arch]
    for s, rec in enumerate(first["steps"]):
        loss, _, grads = _value_and_grad(cfg, rec["before"], bs[s], s)
        np.testing.assert_allclose(float(rec["loss"]), float(loss),
                                   rtol=DATA_RTOL)
        np.testing.assert_allclose(float(adamw.global_norm(rec["grads"])),
                                   float(adamw.global_norm(grads)),
                                   rtol=DATA_RTOL)
        assert_tree_close(rec["grads"], grads, DATA_RTOL, 1e-7,
                          f"{arch} step {s}")
    if arch not in _JAX_FIRST:     # the same for every group
        _JAX_FIRST[arch] = jax_grads(arch, np_params, bs[0])
    jl, jg = _JAX_FIRST[arch]
    jg_port = port_params(cfg, jg)
    rec = first["steps"][0]
    np.testing.assert_allclose(float(rec["loss"]), jl, rtol=2e-5)
    np.testing.assert_allclose(float(adamw.global_norm(rec["grads"])),
                               float(adamw.global_norm(jg_port)), rtol=2e-5)
    assert_tree_close(rec["grads"], jg_port, 2e-4, 1e-6, f"{arch} vs jax")
    _, _, g1 = _value_and_grad(cfg, params, bs[0], 0)
    new_p, new_opt, _ = adamw.apply(ocfg, state.opt, params, g1)
    for rank in ranks:
        assert_equal_trees(rank[key][arch]["update"],
                           (new_p, new_opt), f"{arch} update")
        other = rank[key][arch]
        assert [r["metrics"] for r in other["steps"]] == \
            [r["metrics"] for r in first["steps"]]
        assert_equal_trees(other["final"], first["final"], f"{arch} final")
        for a, b in zip(other["steps"], first["steps"]):
            assert_equal_trees(a["grads"], b["grads"], f"{arch} grads")


# -------------------------------------------------------- the MoE layer
# group -> (fixture, key of the ranks' MoE-layer records)
LAYER_GROUPS = {"pair": ("pair", "moe_layer"), "quad": ("quad", "moe_layer"),
                "pod": ("quad", "moe_layer_pod")}


def _layer_ranks(group, request):
    """The ranks' MoE-layer records, and one record for each block of
    rows (the model axis repeats a block)."""
    fixture, key = LAYER_GROUPS[group]
    recs = [r[key] for r in request.getfixturevalue(fixture)]
    blocks = {}
    for rec in recs:
        blocks.setdefault(rec["rows"], rec)
    return recs, [blocks[k] for k in sorted(blocks)]


@one_thread
def _moe_layer_one_process(blocks: int):
    """One process's MoE layer on all tokens of ``blocks`` blocks of rows:
    (cfg, params, x, y, aux, the gradients of ``(y c).sum() + blocks aux``
    with respect to the params then x, the routing)."""
    cfg, params, x, c = moe_layer_inputs(MOE_ROWS * blocks)
    live = [t.requires_grad_(True) for t in tree_leaves(params)]
    xg = x.clone().requires_grad_(True)
    y, aux = moe.moe_ffn(cfg, params, xg)
    grads = torch.autograd.grad((y * c).sum() + blocks * aux, live + [xg])
    return (cfg, params, x, y.detach(), aux.detach(), grads,
            moe.route(cfg, params["router"].detach(), x))


def _assert_close(got, want, label):
    """Within 1e-6 of ``want``'s largest magnitude."""
    err = float((got - want).abs().max())
    assert err <= 1e-6 * float(want.abs().max()), (label, err)


@pytest.mark.parametrize("group", ["pair", "quad", "pod"])
def test_moe_layer_routes_the_global_batch(group, request):
    """One MoE layer inside ``split_rows``, 128 tokens a rank, over (data
    2, model 1) and (data 2, model 2) at T = 256 (capacity 128) and (pod
    2, data 2, model 1) at T = 512 (capacity 192), the router skewed
    toward expert 0 (the global route drops assignments):
    on every rank the gathered tokens are one process's, their routing
    integers and this rank's rows of ``y`` `torch.equal` to one process's
    ``moe_ffn``, the aux loss equal on every rank and to one process's;
    the ranks' gradients of ``(y c).sum() + aux`` (each its rows of c),
    summed over the blocks, within 1e-6 of one process's gradient of
    ``(y c).sum() + n aux`` (n blocks), and each rank's gradient of its
    rows of x those rows of one process's."""
    recs, blocks = _layer_ranks(group, request)
    n = len(blocks)
    assert n == (4 if group == "pod" else 2)
    cfg, _, x, y, aux, grads, r = _moe_layer_one_process(n)
    want = routing_ints(r)
    assert want["capacity"] == {2: 128, 4: 192}[n] and not bool(r.keep.all())
    for rec in recs:
        assert torch.equal(rec["gathered"], x)
        for k, v in want.items():
            got = rec["routing"][k]
            assert (torch.equal(got, v) if isinstance(v, torch.Tensor)
                    else got == v), (group, k)
        lo, hi = rec["rows"]
        assert torch.equal(rec["y"], y[lo:hi])
        assert torch.equal(rec["aux"], aux)
        _assert_close(rec["x_grad"], grads[-1][lo:hi], "x")
    for i, want_g in enumerate(grads[:-1]):
        got = torch.stack([b["grads"][i] for b in blocks]).sum(0)
        _assert_close(got, want_g, f"param {i}")


@pytest.mark.parametrize("group", ["pair", "quad", "pod"])
def test_moe_layer_per_rank_routing_fails_the_checks(group, request):
    """The negative control: a rank routing its own 128 rows alone
    (capacity 64) drops assignments that the global route keeps, so its
    routing integers and its rows of ``y`` differ from one process's,
    which the ranks' records match."""
    _, blocks = _layer_ranks(group, request)
    cfg, params, x, y, _, _, r = _moe_layer_one_process(len(blocks))
    k, dropped = cfg.top_k, 0
    for b in blocks:
        lo, hi = b["rows"]
        local = moe.route(cfg, params["router"].detach(), x[lo:hi])
        assert local.capacity == 64
        lost = int((r.keep[lo * k:hi * k] & ~local.keep).sum())
        dropped += lost
        if lost:
            y_local, _ = one_thread(moe.moe_ffn)(cfg, params, x[lo:hi])
            assert not torch.equal(y_local.detach(), y[lo:hi])
            assert not torch.equal(local.keep, b["routing"]["keep"][
                lo * k:hi * k])
        assert torch.equal(b["y"], y[lo:hi])
    assert dropped > 0


# ---------------------------------------------------------- checkpoints
def test_restore_resharded_onto_another_split(pair):
    """A state saved from (data 2, model 1) after 2 steps (each leaf
    gathered whole, rank 0 writing) restores onto (data 1, model 2) with
    every rank holding its block of the new split, bit-equal to the saved
    state gathered; onto one process it restores whole, bit-equal; the
    (1, 2) mesh's step 3 from it is `torch.equal` to one process's step 3
    from the same restored state."""
    rec = pair[0]["restore"]
    assert rec["step"] == 2 and rec["extra"] == {"data_step": 2}
    assert ("data", "model") in rec["specs"] and \
        ("model", "data") in rec["specs"]
    assert_equal_trees(rec["restored"], rec["saved"], "restored")
    for other in pair[1:]:
        assert_equal_trees(other["restore"]["restored"], rec["saved"],
                           "restored, rank 1")
        assert_equal_trees(other["restore"]["step3"], rec["step3"], "step3")
    cfg, ocfg, fresh = init_state("olmo-1b")
    got, one, extra = CheckpointManager(rec["ck"]).restore_resharded(fresh)
    assert got == 2 and extra == {"data_step": 2}
    assert_equal_trees(one, rec["saved"], "one process")
    step3, _ = one_thread(steps.make_train_step(cfg, ocfg))(
        one, batches(cfg, 3)[2])
    assert_equal_trees(rec["step3"], step3, "step 3")


def test_restore_resharded_falls_back_past_a_corrupt_step(pair):
    """With the newest step's first leaf overwritten, every rank of the
    (1, 2) mesh falls back to step 1, as the reference's walk does, and
    holds step 1's state."""
    for rec in pair:
        r = rec["restore"]
        assert r["fallback_step"] == 1
        assert_equal_trees(r["fallback"], pair[0]["restore"]["at_step1"],
                           "fallback")


def test_save_from_a_mesh_needs_the_mesh(tmp_path):
    """A tree of ``Shard`` leaves saved without its mesh raises."""
    s = sharding.Shard(torch.zeros(2), (4,), ("data",))
    with pytest.raises(ValueError, match="mesh that holds them"):
        CheckpointManager(str(tmp_path)).save(1, {"w": s})


# ---------------------------------------------------------------- launcher
def _run_cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--global-batch", "2", "--seq", "16",
         "--log-every", "1", "--steps", "3", *args],
        capture_output=True, text=True, timeout=JOIN_S, env=env, cwd=cwd)


def _loss_lines(out: str):
    return [ln.split(" (")[0] for ln in out.splitlines()
            if ln.startswith("step ")]


def test_launcher_trains_on_a_mesh_and_resumes_on_another(tmp_path, capsys):
    """``launch.train --model-parallel 2`` on 2 CPU ranks under
    ``torch.distributed.run``: exit 0, the mesh line and ``[train] done``
    once (rank 0 alone prints), the loss lines those of one process;
    a second run on (data 2, model 1) resumes from its step-2 checkpoint.
    On one process ``--model-parallel 2`` raises ``plan_mesh``'s error."""
    base = ["--arch", "olmo-1b", "--device", "cpu", "--global-batch", "2",
            "--seq", "16", "--log-every", "1", "--steps", "3"]
    one_thread(train_cli.main)(base)
    want = _loss_lines(capsys.readouterr().out)
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    out = _run_cli(["--model-parallel", "2", *ck], tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("[train] olmo-1b-smoke on mesh {'data': 1, "
                            "'model': 2}") == 1
    assert out.stdout.count("[train] done") == 1
    assert out.stdout.count("[ckpt] saved step 2") == 1
    assert _loss_lines(out.stdout) == want
    again = _run_cli(ck, tmp_path)
    assert again.returncode == 0, again.stderr[-3000:]
    assert again.stdout.count("[train] olmo-1b-smoke on mesh {'data': 2, "
                              "'model': 1}") == 1
    assert again.stdout.count("[train] resumed from step 2") == 1
    assert len(_loss_lines(again.stdout)) == 1
    with pytest.raises(ValueError, match="cannot keep TP=2"):
        train_cli.main(base + ["--model-parallel", "2"])
