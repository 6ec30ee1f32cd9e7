"""Dry-run: count one rank's work for every (arch x shape) cell on a mesh.

Counterpart of ``repro.launch.dryrun``. The reference lowers and compiles
each cell's jitted step on 256 or 512 fake CPU devices and reads the
partitioned HLO (``launch.hlo_analysis``). The port has nothing to
compile: ``lower_cell`` builds the port's own step for the cell with
every weight, state and input on the ``meta`` device (drawn under
``FakeTensorMode``, since the port's initialisers take a generator meta
cannot give), so nothing is materialised, and counts one call on rank 0
of the mesh through ``op_analysis.analyze`` with a ``CountingMesh``. No
process group starts; a full production mesh costs one process.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape train_4k --mesh multi

Per ``configs/shapes.py`` kind, the call counted is:

* ``train``, ``denoise_train``: ``train.steps.make_sharded_train_step``
  on the mesh, the state sharded by ``sharding.shard_state``; the step
  takes the global batch and computes the rank's rows (``batch_rows``);
  with ``opt="microbatch"``, in 8 microbatches, as the reference's;
* ``prefill``: ``make_prefill_step`` on the rank's rows;
* ``decode``: ``make_decode_step`` on the rank's rows with the token at
  the cache's last slot (a full ``seq_len`` context); with
  ``opt="windowed"``, ``transformer.decode_step_mixed`` on its ring
  caches;
* ``sample``: ``make_denoise_step``, one denoising step; with
  ``opt="drift"`` (the DiT family), one denoising step with quantize,
  injection, ABFT and rollback on every GEMM at BER 3e-3 in the body
  class (``drift_sample_step``, the reference's ``:204-263`` branch).

The serving kinds run under the sharded engine's mesh policy, with the
weights at rest as ``ShardedDriftServeEngine`` keeps them (an LM's
prepared, the DiT family's in the activation dtype) and sharded by
``sharding.shard_tree``, so every block's gather is counted; the
encoder-decoder's serving steps gather nothing, so whisper-base's
weights stay whole on every rank. The rows
split over the data axes as the reference's ``batch_spec`` splits them
(the port's sharded engine itself runs an autoregressive batch whole on
every rank).

The model axis duplicates compute: the port gathers each block's weights
whole and every rank of the ``model`` axis computes the block on the
same rows (ROADMAP Queue A 15). The per-rank counts show that
duplication, and the roofline's ``useful_flops_ratio`` falls to about
1/model. That is the honest reading of the port as it stands. On a data
axis the MoE layers route the global batch (``models.moe.moe_layer``):
each gathers the data group's tokens and runs every expert on all of
them, so the MoE archs' ``train_4k`` cells count the expert compute of
the whole batch on every data rank, and the gathers' bytes.

The report keeps the reference's keys where their meaning holds (``arch``,
``shape``, ``mesh``, ``axes``, ``n_devices``, ``opt``, ``n_params``,
``model_flops``, ``tokens``, ``collectives``,
``collective_ops_executed``) and names the per-rank counts for what they
are: ``flops_per_device``, ``int8_ops_per_device``, ``bytes_per_device``,
``collective_bytes_per_device``, ``argument_bytes_per_device`` (the
rank's params, state and inputs) and ``count_s``. Every count is
computed from shapes, not measured. ``dp_only`` has no step in the port
and raises.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs
from repro_torch.configs import shapes as shapes_lib
from repro_torch.core.exec_ctx import DriftSystemConfig
from repro_torch.diffusion import schedule as sched_lib
from repro_torch.distributed import constraints
from repro_torch.distributed import sharding as shd
from repro_torch.launch import op_analysis
from repro_torch.models import dit as dit_lib
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.common import ModelConfig, count_params
from repro_torch.optim.adamw import OptimConfig
from repro_torch.perfmodel import flops as flops_lib
from repro_torch.train import steps as steps_lib

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "card": ((1, 1), ("data", "model"))}
OPTS = ("", "windowed", "drift", "dp_only", "microbatch")
# the drift cell's per-class BER: embeddings and the first block clean,
# the body at 3e-3, as the reference's drift branch
DRIFT_BER = np.array([0.0, 0.0, 3e-3], np.float32)


# --------------------------------------------------------------- inputs
def to_meta(tree: Any) -> Any:
    """``tree`` with each tensor replaced by an empty meta tensor of its
    shape and dtype (dicts, lists, named tuples and dataclasses such as
    ``transformer.Weights``)."""
    return shd._walk(tree, lambda _, x: torch.empty(
        x.shape, dtype=x.dtype, device="meta")
        if isinstance(x, torch.Tensor) else x)


def meta_init(fn: Callable[[], Any]) -> Any:
    """What ``fn()`` builds on the CPU, as meta tensors: ``fn`` runs under
    ``FakeTensorMode``, so its draws allocate nothing. No value is read,
    so ``trunc_normal_``, whose resampling loop reads its draws, leaves
    its tensor as it is."""
    init = torch.nn.init.trunc_normal_
    torch.nn.init.trunc_normal_ = lambda t, *a, **kw: t
    try:
        with FakeTensorMode():
            tree = fn()
    finally:
        torch.nn.init.trunc_normal_ = init
    return to_meta(tree)


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (a ``Shard``: its local block)."""
    out = []
    shd._walk(tree, lambda _, x: out.append(x))
    return sum(x.numel() * x.element_size() for x in out
               if isinstance(x, torch.Tensor))


def input_batch(cfg: ModelConfig, shape: shapes_lib.ShapeSpec, rows: int
                ) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for every model input of the cell at ``rows`` rows,
    as the reference's ``input_specs`` lays them out."""
    s = shape.seq_len

    def m(shp, dtype=torch.float32):
        return torch.empty(shp, dtype=dtype, device="meta")
    out: Dict[str, torch.Tensor] = {}
    if shape.kind in ("train", "prefill"):
        extra = 1 if shape.kind == "train" else 0
        if cfg.family == "encdec":
            out["frames"] = m((rows, cfg.encoder_seq, cfg.d_model))
            out["tokens"] = m((rows, s + extra), torch.int64)
        elif cfg.family == "vlm":
            out["vis_embeds"] = m((rows, cfg.vis_tokens, cfg.d_model))
            out["tokens"] = m((rows, s - cfg.vis_tokens + extra),
                              torch.int64)
        else:
            out["tokens"] = m((rows, s + extra), torch.int64)
        return out
    if shape.kind == "decode":
        return {"tokens": m((rows, 1), torch.int64)}
    if shape.kind in ("denoise_train", "sample"):
        ls, lc = cfg.latent_size, cfg.latent_channels
        out["latents"] = m((rows, ls, ls, lc))
        if cfg.cond_tokens:
            out["text"] = m((rows, cfg.cond_tokens, cfg.cond_dim))
        else:
            out["labels"] = m((rows,), torch.int64)
        return out
    raise ValueError(shape.kind)


def _optim_cfg(cfg: ModelConfig) -> OptimConfig:
    kind = "adafactor" if cfg.name in ("kimi-k2-1t-a32b",) else "adamw"
    return OptimConfig(kind=kind, warmup_steps=100, total_steps=10_000)


# -------------------------------------------------------------- steps
def drift_sample_step(cfg: ModelConfig) -> Callable:
    """One DiT denoising step with DRIFT on every GEMM (quantize, the
    flips xored into the accumulators, ABFT, tile rollback) at
    ``DRIFT_BER``: ``step(params, latents, t, cond, embed_store,
    block_store, flip_source) -> latents``; ``cond`` is the class ids, or
    the text for PixArt. The flip source's draws are not counted
    (``op_analysis.uncounted_source``)."""
    sched = sched_lib.DdpmSchedule.default(1000)
    scfg = DriftSystemConfig(mode="drift")

    @torch.no_grad()
    def step(params, latents, t: int, cond, embed_store, block_store,
             flip_source=None):
        ds = dit_lib.DriftState(
            cfg=scfg,
            flip_source=op_analysis.uncounted_source(flip_source,
                                                     latents.device),
            step=t, ber_by_class=DRIFT_BER, embed_store=embed_store,
            block_store=block_store, have_ckpt=True)
        tt = torch.full((latents.shape[0],), float(t), dtype=torch.float32,
                        device=latents.device)
        if cfg.cond_tokens:
            eps, _ = dit_lib.forward(cfg, params, latents, tt, None,
                                     drift=ds, text=cond)
        else:
            eps, _ = dit_lib.forward(cfg, params, latents, tt, cond,
                                     drift=ds)
        return sched.ddim_step(latents, eps, t, t - 1)
    return step


def _cond(batch):
    return batch.get("text", batch.get("labels"))


def build_cell(cfg: ModelConfig, shape: shapes_lib.ShapeSpec, mesh,
               opt: str = "") -> Tuple[Callable, tuple, int, Any]:
    """(step, args, n_params, policy) of one cell on ``mesh``: the call
    ``lower_cell`` counts, its meta arguments as rank 0 holds them, the
    model's parameter count, and the mesh policy it runs under (the
    sharded engine's, for the serving kinds; None for training, whose
    step takes the mesh)."""
    if opt == "dp_only":
        raise NotImplementedError(
            "opt='dp_only': the port has no step that replicates the weights "
            "and splits the batch over every axis (ROADMAP Queue A item 15)")
    if opt and opt not in OPTS:
        raise ValueError(f"unknown opt {opt!r}; one of {OPTS}")
    kind = shape.kind
    b = shape.global_batch
    rows = shd.batch_rows(b, mesh)
    rows_n = rows.stop - rows.start
    if opt == "drift" and not (kind == "sample" and cfg.family == "dit"):
        raise ValueError(f"opt='drift' is the DiT family's sample cell, "
                         f"not {cfg.name} {shape.name}")
    if opt == "microbatch" and kind not in ("train", "denoise_train"):
        raise ValueError(f"opt='microbatch' is a train cell's, not "
                         f"{shape.name}'s")
    if opt == "windowed" and not (kind == "decode"
                                  and tf_lib.supports_mixed_decode(cfg)):
        raise ValueError(f"opt='windowed' is the decode cell of an arch "
                         f"with local layers, not {cfg.name} {shape.name}")

    if kind in ("train", "denoise_train"):
        ocfg = _optim_cfg(cfg)
        state = meta_init(lambda: steps_lib.init_train_state(
            cfg, ocfg, 0, device="cpu"))
        n_params = count_params(state.params)
        step = steps_lib.make_train_step(
            cfg, ocfg, microbatches=8 if opt == "microbatch" else 1,
            mesh=mesh)
        return (step, (shd.shard_state(state, mesh),
                       input_batch(cfg, shape, b)), n_params, None)

    # the weights at rest as ShardedDriftServeEngine keeps them: an LM's
    # prepared (init_weights draws them so), the DiT family's in the
    # activation dtype
    params = meta_init(lambda: steps_lib.init_model_params(cfg, 0, "cpu"))
    n_params = count_params(params)
    if cfg.family in tf_lib.FAMILIES:
        params = meta_init(lambda: tf_lib.init_weights(cfg, 0, "cpu"))
    elif cfg.family == "dit":
        params = shd._walk(params, lambda _, t: torch.empty(
            t.shape, dtype=cfg.dtype, device="meta"))
    if cfg.family != "encdec":      # whisper serves replicated weights
        params = shd.shard_tree(params, mesh)
    batch = input_batch(cfg, shape, rows_n)
    policy = constraints.MeshPolicy(mesh, shard_batch=rows_n < b)

    if kind == "prefill":
        step = steps_lib.make_prefill_step(cfg, max_seq=shape.seq_len)
        return step, (params, batch), n_params, policy
    if kind == "decode":
        s = shape.seq_len
        if opt == "windowed":
            cache = tf_lib.init_mixed_cache(cfg, rows_n, s, cfg.dtype,
                                            "meta")._replace(pos=s - 1)

            def step(p, c, t):
                return tf_lib.decode_step_mixed(cfg, p, c, t)
            return step, (params, cache, batch["tokens"]), n_params, policy
        if cfg.family == "encdec":
            memory = torch.empty((rows_n, cfg.encoder_seq, cfg.d_model),
                                 dtype=cfg.dtype, device="meta")
            cache = encdec_lib.init_decode_cache(cfg, params, memory, s)
        else:
            cache = tf_lib.init_cache(cfg, rows_n, s, cfg.dtype, "meta")
        cache = cache._replace(pos=s - 1)
        return (steps_lib.make_decode_step(cfg),
                (params, cache, batch["tokens"]), n_params, policy)
    if kind == "sample":
        t = 500
        if opt == "drift":
            # a sharded batch's ragged GEMMs keep the whole batch's rows
            prev = constraints.get_policy()
            constraints.set_policy(policy)
            try:
                stores = dit_lib.drift_store_spec(cfg, rows_n, "meta")
            finally:
                constraints.set_policy(prev)
            return (drift_sample_step(cfg),
                    (params, batch["latents"], t, _cond(batch), *stores),
                    n_params, policy)
        return (steps_lib.make_denoise_step(cfg),
                (params, batch["latents"], t, _cond(batch)), n_params,
                policy)
    raise ValueError(kind)


def lower_cell(arch: str, shape_name: str, mesh_shape: Sequence[int],
               opt: str = "", axes: Sequence[str] = ()) -> Dict[str, Any]:
    """Count one (arch, shape) cell on rank 0 of a mesh of ``mesh_shape``
    (axes ``(data, model)`` or ``(pod, data, model)`` by its length).
    Returns the report dict (see the module docstring)."""
    cfg = configs.get_config(arch)
    shape = shapes_lib.get_shape(shape_name)
    axes = tuple(axes) or (("data", "model") if len(mesh_shape) == 2
                           else ("pod", "data", "model"))
    mesh = op_analysis.CountingMesh(mesh_shape, axes)
    step, args, n_params, policy = build_cell(cfg, shape, mesh, opt)
    prev = constraints.get_policy()
    constraints.set_policy(policy)
    try:
        counts = op_analysis.analyze(step, *args)
    finally:
        constraints.set_policy(prev)
    mf = flops_lib.cell_flops(cfg, shape)
    return {
        "opt": opt, "arch": arch, "shape": shape_name,
        "mesh": list(mesh.shape.values()), "axes": list(mesh.axis_names),
        "n_devices": mesh.size,
        "flops_per_device": counts["flops"],
        "int8_ops_per_device": counts["int8_ops"],
        "bytes_per_device": counts["bytes"],
        "collective_bytes_per_device": counts["collective_bytes"],
        "collectives": counts["collectives"],
        "collective_ops_executed": counts["collective_ops_executed"],
        "argument_bytes_per_device": tensor_bytes(args),
        "kernels": counts["kernels"],
        "top_ops": counts["top_ops"],
        "count_s": counts["count_s"],
        "n_params": int(n_params),
        "model_flops": mf["model_flops"],
        "tokens": mf["tokens"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=sorted(MESHES), default="single")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--opt", default="", choices=OPTS,
                    help="optimization variant (windowed|drift|...)")
    args = ap.parse_args(argv)

    mesh_shape, axes = MESHES[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    archs = configs.list_archs() if args.arch == "all" else [args.arch]
    failures = []
    for arch in archs:
        cells = (shapes_lib.cells_for(arch) if args.shape == "all"
                 else [args.shape])
        for cell in cells:
            suffix = f"_{args.opt}" if args.opt else ""
            tag = f"{arch}_{cell}_{args.mesh}{suffix}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip] {tag}")
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                rep = lower_cell(arch, cell, mesh_shape, opt=args.opt,
                                 axes=axes)
                with open(path, "w") as f:
                    json.dump(rep, f, indent=1)
                print(f"  ok: flops/dev={rep['flops_per_device']:.3e} "
                      f"int8/dev={rep['int8_ops_per_device']:.3e} "
                      f"count={rep['count_s']:.1f}s "
                      f"coll_ops={rep['collective_ops_executed']}",
                      flush=True)
            except Exception as e:       # noqa: BLE001 -- listed below
                failures.append((tag, f"{type(e).__name__}: {e}"[:200]))
                print(f"  FAIL: {type(e).__name__}: {e}", flush=True)
    if failures:
        print("\nFAILURES:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("all cells passed")


if __name__ == "__main__":
    main()
