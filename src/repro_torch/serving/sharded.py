"""Sharded DRIFT serving: one micro-batch spread over a (data, model) mesh.

Counterpart of ``repro.serving.sharded``. ``ShardedDriftServeEngine`` is
``DriftServeEngine`` run SPMD by processes: every rank of the mesh
(``launch.mesh.make_serving_mesh``) runs the same engine loop on the same
submitted requests, and the serving loop, bucket semantics, caches and
the Sec 5.1 BER-monitor feedback are the single-device engine's. What
changes is where the work lives:

  ======================  =========================  ====================
  what                    where                      how
  ======================  =========================  ====================
  a diffusion bucket's    batch on ``data``          ``place_inputs`` by
  rows                                               ``sharding.batch_spec``
  weights                 FSDP on ``data``, TP on    ``sharding.shard_tree``
                          ``model``, at rest         by ``param_specs``;
                                                     gathered whole per
                                                     block
  BER-monitor state       replicated                 every rank updates it
                                                     from the same sums
  detected / corrected    summed over ``data``       ``constraints.data_sum``
  counts                                             before the monitor
  checkpoint stores       each rank its rows         offload snapshots and
                                                     restores its shard
  ======================  =========================  ====================

Weights are gathered whole at each block boundary, and the batch-wide
quantities (per-tensor activation scales, flip masks, ABFT tiles that
would straddle ranks, small float GEMMs whose kernel depends on the row
count) are reduced or gathered over the data group
(``distributed.constraints``), so a data axis and a model axis both give
latents bit-equal to the single-device engine's (the reference promises
bit-equality for the data axis, closeness for the model axis). Results
carry the whole batch's latents, gathered.

Every rank takes the same branches: monitor steps, offload commits and
``auto`` choices read only replicated values (the monitor, fed from
reduced counts), so no rank waits at a collective the others skip.

Autoregressive buckets run whole on every rank (a replicated batch; the
weights are still gathered per layer), which gives the single-device
engine's tokens and counts, as the reference's sharded engine does
(checked on its 8-device CPU mesh at (4, 1) and (2, 2)). A bucket the
data axis does not divide is replicated too, with a warning at start.

``make_engine`` returns the plain ``DriftServeEngine`` when there is
nothing to shard over (a world of one, or no process group up and no
``WORLD_SIZE`` above 1), so launchers can use it unconditionally::

    from repro_torch.serving.sharded import make_engine

    engine = make_engine(bucket=8, model_parallel=1)   # sharded if >1 rank
    engine.submit(steps=10, mode="drift", op="auto", seed=0)
    results = engine.run()

Streaming (``run_stream``), checkpoint offload and ``DeadlineScheduler``
compose unchanged: the mesh policy is held for the whole batch, streamed
windows included, and the scheduler keeps the batcher's mesh
``key_extra``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch.distributed as dist

from repro_torch import configs
from repro_torch.distributed import constraints
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer
from repro_torch.serving import servable as servable_lib
from repro_torch.serving.engine import DriftServeEngine
from repro_torch.tree import tree_map


class ShardedDriftServeEngine(DriftServeEngine):
    """DriftServeEngine whose micro-batches run SPMD across a mesh."""

    def __init__(self, mesh: Optional[mesh_lib.ServingMesh] = None,
                 model_parallel: int = 1, **kw):
        self.mesh = mesh if mesh is not None else \
            mesh_lib.make_serving_mesh(model_parallel,
                                       device=kw.get("device", "cuda"))
        self._mesh_shape = tuple((a, int(self.mesh.shape[a]))
                                 for a in self.mesh.axis_names)
        kw["device"] = self.mesh.device      # the rank's own device
        super().__init__(**kw)
        bucket = self.batcher.bucket
        dsize = shd.axis_size(self.mesh, "data")
        if bucket % dsize:
            print(f"[sharded] bucket={bucket} not divisible by data axis "
                  f"{dsize}: batch will be replicated, not sharded")

    # ------------------------------------------------------------ placement
    def _sampler_key_extra(self, bucket: int) -> Dict[str, object]:
        bucket_spec = shd.batch_spec((bucket, 1, 1, 1), self.mesh)
        return {"mesh_shape": self._mesh_shape,
                "batch_spec": shd.spec_str(bucket_spec)}

    def _default_sampler_factory(self, key, model_cfg, scfg):
        """The single-device sampler, its latents gathered whole: each
        preview and the final output carry the whole batch's rows."""
        run = super()._default_sampler_factory(key, model_cfg, scfg)

        def gathered(*a, **kw):
            for ev in run(*a, **kw):
                yield ev._replace(
                    latents=constraints.gather_rows(ev.latents))
        return gathered

    def _params_for(self, arch: str, smoke: bool):
        """This rank's shards of the params (the whole params are built
        once, sharded by ``param_specs``, and dropped)."""
        k = (arch, smoke)
        if k not in self._params:
            self._params[k] = self._at_rest(
                arch, smoke, super()._params_for(arch, smoke))
        return self._params[k]

    def set_params(self, arch: str, smoke: bool, params) -> None:
        """This rank's shards of ``params``."""
        self._params[(arch, smoke)] = self._at_rest(arch, smoke, params)

    def _at_rest(self, arch: str, smoke: bool, params):
        """``params`` as this rank keeps them: an LM's prepared, the DiT
        family's in the activation dtype (its forward casts every weight
        to it before use, so the bits are the same and each gather moves
        half the bytes of f32 masters), then sharded."""
        cfg = configs.get_config(arch, smoke=smoke)
        if servable_lib.paradigm_for(arch) == "autoregressive":
            params = transformer.prepare(cfg, params)
        elif cfg.family == "dit":
            params = tree_map(lambda t: t.to(cfg.dtype)
                              if t.is_floating_point() else t, params)
        return shd.shard_tree(params, self.mesh)

    def place_inputs(self, tree):
        """This rank's rows of a batch's staged inputs when the batch is
        sharded; the whole batch otherwise."""
        if not constraints.batch_sharded():
            return tree
        return tree_map(constraints.own_rows, tree)

    def _policy_for(self, mb) -> constraints.MeshPolicy:
        """The mesh policy of one batch: rows over ``data`` for a
        diffusion bucket the data axis divides."""
        dsize = shd.axis_size(self.mesh, "data")
        paradigm = servable_lib.paradigm_for(mb.key.arch)
        return constraints.MeshPolicy(
            self.mesh, shard_batch=(paradigm == "diffusion" and dsize > 1
                                    and mb.key.bucket % dsize == 0))

    # ------------------------------------------------------------ one batch
    def _run_batch(self, mb):
        prev = constraints.get_policy()
        constraints.set_policy(self._policy_for(mb))
        try:
            return super()._run_batch(mb)
        finally:
            constraints.set_policy(prev)

    def _run_batch_stream(self, mb, preview_interval):
        # held across the whole generator: every window, and the
        # consumer's code between yields, runs under the batch's policy
        prev = constraints.get_policy()
        constraints.set_policy(self._policy_for(mb))
        try:
            yield from super()._run_batch_stream(mb, preview_interval)
        finally:
            constraints.set_policy(prev)


def make_engine(mesh: Optional[mesh_lib.ServingMesh] = None,
                model_parallel: int = 1, **kw) -> DriftServeEngine:
    """The widest engine the process group supports: the sharded engine on
    a mesh of more than one rank, the plain ``DriftServeEngine`` on a
    world of one (or with no process group up and ``WORLD_SIZE`` unset or
    1), the counterpart of ``jax.device_count() == 1``."""
    if mesh is not None and model_parallel != 1:
        raise ValueError("pass either an explicit mesh or model_parallel, "
                         "not both")
    if mesh is None:
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", "1")))
        if world == 1:
            return DriftServeEngine(**kw)
    elif mesh.size == 1:
        return DriftServeEngine(**kw)
    return ShardedDriftServeEngine(mesh=mesh, model_parallel=model_parallel,
                                   **kw)
