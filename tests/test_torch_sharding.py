"""The port's sharding rules and mesh policy against the JAX package's.

Both take a mesh by its axis names and sizes alone, so each rule is held
with ``==`` on ``jax.sharding.AbstractMesh`` meshes (no devices): the
production (data 16, model 16) and (pod 2, data 16, model 16) meshes and
a (data 4, model 2) serving mesh. Specs are tuples, ``PartitionSpec`` a
tuple subclass. ``spec_for_param`` is held on every param leaf of all 13
archs at their FULL shapes (``jax.eval_shape`` over the reference's
init); the batch, cache, SSM-state and logits specs and
``MeshPolicy.spec`` over a grid of divisible and indivisible shapes.
"""
import itertools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.distributed import constraints as jcons
from repro.distributed import sharding as jshd
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.distributed import constraints, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import dit, transformer

MESHES = {
    "data16_model16": AbstractMesh((16, 16), ("data", "model")),
    "pod2_data16_model16": AbstractMesh((2, 16, 16),
                                        ("pod", "data", "model")),
    "data4_model2": AbstractMesh((4, 2), ("data", "model")),
}


def all_archs():
    names = sorted(configs._MODULES)
    assert len(names) == 13
    return names


def ref_param_shapes(arch):
    """(path, shape) of every leaf of the reference's FULL init."""
    cfg = jconfigs.get_config(arch)
    tree = jax.eval_shape(
        lambda: jsteps.init_model_params(cfg, jax.random.PRNGKey(0)))
    out = []

    def one(path, leaf):
        out.append((jshd._path_str(path), tuple(leaf.shape)))
    jax.tree_util.tree_map_with_path(one, tree)
    return out


@pytest.mark.parametrize("arch", all_archs())
def test_spec_for_param_matches_reference(arch):
    leaves = ref_param_shapes(arch)
    assert leaves
    for mesh in MESHES.values():
        for path, shape in leaves:
            want = jshd.spec_for_param(path, shape, mesh)
            got = sharding.spec_for_param(path, shape, mesh)
            assert got == want, (arch, path, shape, mesh.shape)
            assert isinstance(got, tuple)


def test_port_trees_take_the_reference_rules():
    """The port's own trees: per-layer lists take the stacked leaf's rule
    without its leading L entry, and a prepared LM's ``Proj`` fields take
    their projection's rule (the sums its last entry)."""
    mesh = MESHES["data4_model2"]
    cfg = configs.get_config("dit-xl-512", smoke=True)
    specs = sharding.param_specs(dit.init_params(cfg, 0), mesh)
    jcfg = jconfigs.get_config("dit-xl-512", smoke=True)
    jspecs = jshd.param_specs(jax.eval_shape(
        lambda: jsteps.init_model_params(jcfg, jax.random.PRNGKey(0))), mesh)
    assert specs["blocks"][1]["attn"]["wq"] == \
        tuple(jspecs["blocks"]["attn"]["wq"])[1:]
    assert specs["patch_w"] == jspecs["patch_w"]
    lcfg = configs.get_config("olmo-1b", smoke=True)
    w = sharding.param_specs(transformer.init_weights(lcfg, 0), mesh)
    wq = w.layers[0]["attn"]["wq"]
    assert wq.w == ("data", "model") and wq.w_sum == ("model",)
    assert w.embed == ("model", "data")


SHAPES = [(1,), (2, 3), (4, 8, 5), (16, 4, 4, 4), (32, 7), (3, 16, 5),
          (64, 12, 6), (8, 8)]


@pytest.mark.parametrize("name", sorted(MESHES))
def test_batch_and_logits_specs_match_reference(name):
    mesh = MESHES[name]
    for shape in SHAPES:
        for seq_dim in (None,) + tuple(range(1, len(shape))):
            assert sharding.batch_spec(shape, mesh, seq_dim) == \
                jshd.batch_spec(shape, mesh, seq_dim), (shape, seq_dim)
    assert sharding.logits_spec(mesh) == jshd.logits_spec(mesh)
    assert sharding.data_axes(mesh) == jshd.data_axes(mesh)
    for a in ("pod", "data", "model", "expert"):
        assert sharding.axis_size(mesh, a) == jshd.axis_size(mesh, a)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_cache_and_ssm_state_specs_match_reference(name):
    mesh = MESHES[name]
    jcfg = jconfigs.get_config("gemma2-9b")
    for b, s, hkv in itertools.product((1, 2, 16, 32), (8, 4096),
                                       (2, 8, 16)):
        shape = (4, b, s, hkv, 64)
        assert sharding.cache_spec(None, shape, mesh) == \
            jshd.cache_spec(jcfg, shape, mesh), shape
    for shape in ((4, 1, 2, 16, 8, 4), (4, 32, 1, 32, 8, 4), (2, 16, 3),
                  (3, 64), (4, 2, 1, 7, 8, 4)):
        assert sharding.ssm_state_spec(None, shape, mesh) == \
            jshd.ssm_state_spec(jcfg, shape, mesh), shape


KINDS = ("act", "logits", "batch_only", "tokens2d", "slots2d", "w2d_model",
         "experts", "other")
POLICY_SHAPES = [(2, 8, 64), (16, 8, 64), (32, 64), (7, 3), (64, 4096),
                 (384, 16, 64), (3, 32, 5), (512, 96), (16, 7, 3, 5)]


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("dmodel,over_all", [(False, False), (True, False),
                                             (False, True)])
def test_mesh_policy_spec_matches_reference(name, dmodel, over_all):
    mesh = MESHES[name]
    got = constraints.MeshPolicy(mesh, shard_act_dmodel=dmodel,
                                 dp_over_all=over_all)
    want = jcons.MeshPolicy(mesh, shard_act_dmodel=dmodel,
                            dp_over_all=over_all)
    assert got.data_axes == want.data_axes and got.dp == want.dp
    assert got.dsize == want.dsize and got.msize() == want.msize()
    for kind, shape in itertools.product(KINDS, POLICY_SHAPES):
        w = want.spec(kind, shape)
        g = got.spec(kind, shape)
        assert (g is None) == (w is None), (kind, shape)
        if w is not None:
            assert g == w, (kind, shape)


def test_set_and_get_policy_and_identity_without_one():
    """Without a policy every anchor returns its input itself."""
    assert constraints.get_policy() is None
    x = torch.arange(6.0).reshape(3, 2)
    tree = {"w": x, "blocks": [x]}
    assert constraints.gather(tree) is tree
    for fn in (constraints.gather_rows, constraints.own_rows,
               constraints.data_sum, constraints.data_amax):
        assert fn(x) is x
    assert constraints.global_rows(3) == (3, 0)
    assert constraints.store_rows(5, 32) == 5
    assert constraints.is_data_leader()
    pol = constraints.MeshPolicy(MESHES["data4_model2"])
    constraints.set_policy(pol)
    try:
        assert constraints.get_policy() is pol
        assert not constraints.batch_sharded()    # no batch sharded yet
        assert constraints.gather_rows(x) is x
    finally:
        constraints.set_policy(None)


@pytest.mark.parametrize("spec", [("data", None, None), ("model",), (),
                                  (("pod", "data"), "model"),
                                  (None, ("data", "model"))])
def test_spec_str_matches_reference(spec):
    from jax.sharding import PartitionSpec as P
    assert sharding.spec_str(spec) == jshd.spec_str(P(*spec))


def test_shard_blocks_tile_the_weight():
    """The blocks ``shard_tensor`` cuts on every rank of a (2, 2) mesh
    tile each weight exactly once (the gather's precondition)."""
    class Coords:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 2}

        def __init__(self, d, m):
            self.coords = {"data": d, "model": m}
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for spec in (("data", "model"), ("model", None), (None, "data"), ()):
        cover = torch.zeros_like(x)
        for d, m in itertools.product(range(2), range(2)):
            mesh = Coords(d, m)
            s = sharding.shard_tensor(x, spec + (None,) * (2 - len(spec)),
                                      mesh)
            split = {a for a in spec if a}
            if all(mesh.coords[a] == 0 for a in mesh.axis_names
                   if a not in split):
                cover[sharding.block_slices(mesh, x.shape, s.spec)] += \
                    s.local
        assert torch.equal(cover, x), spec


@pytest.mark.parametrize("mp,world", [(3, 2), (0, 2), (3, 8)])
def test_make_serving_mesh_refuses_like_reference(mp, world):
    """``model_parallel`` that does not divide the world raises, with the
    reference's message, before any process group starts."""
    with pytest.raises(ValueError,
                       match=f"model_parallel={mp} does not divide "
                             f"{world} devices"):
        mesh_lib.make_serving_mesh(mp, device="cpu", world_size=world,
                                   rank=0, init_method="file:///nonexistent")
    assert not torch.distributed.is_initialized()
