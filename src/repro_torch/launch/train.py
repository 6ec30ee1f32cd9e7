"""Training launcher on PyTorch: the sharded train loop with checkpoints,
auto-resume and elastic mesh planning.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --steps 200 --global-batch 8 --seq 128 --ckpt-dir build/run1
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.train --model-parallel 2

Counterpart of ``repro.launch.train``: the same flags and defaults
(``--smoke`` is on and, as in the reference, cannot be turned off), plus
``--device`` (default "cuda"; without a GPU it raises). The mesh is
planned from the number of ranks (``elastic.plan_mesh``, which raises when
``--model-parallel`` does not divide it) and printed in the reference's
line. One rank trains as before; under ``torch.distributed.run`` the
ranks form that mesh (``launch.mesh.make_mesh``) and run the sharded step
(``train.steps.make_sharded_train_step``), each regenerating the global
batch and taking its rows. With ``--ckpt-dir`` it restores the newest
valid checkpoint there onto this run's mesh (``restore_resharded``: a run
may resume on another split), then saves the train state every
``--ckpt-every`` steps (with the data step, which is all the synthetic
pipeline's state). Rank 0 alone prints. ``main(argv)`` returns the final
``TrainState`` (its params and moments ``Shard`` leaves on a mesh).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import synthetic
from repro_torch.distributed import elastic, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim.adamw import OptimConfig
from repro_torch.train import steps as steps_lib


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    return ap


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    world = mesh_lib.world_of()
    mesh_shape, axes = elastic.plan_mesh(world, args.model_parallel)
    started = world > 1 and not dist.is_initialized()
    mesh = (mesh_lib.make_mesh(mesh_shape, axes, device=args.device)
            if world > 1 else None)
    device = mesh.device if mesh is not None else args.device
    say = print if mesh is None or mesh.rank == 0 else \
        (lambda *_a, **_kw: None)
    say(f"[train] {cfg.name} on mesh {dict(zip(axes, mesh_shape))}")
    try:
        return _loop(args, cfg, mesh, device, say)
    finally:
        if started:
            dist.destroy_process_group()


def _loop(args, cfg, mesh, device, say):
    ocfg = OptimConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                       total_steps=args.steps)
    dcfg = synthetic.for_model(cfg, args.global_batch, args.seq)
    train_step = steps_lib.make_train_step(cfg, ocfg, mesh=mesh)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    state = steps_lib.init_train_state(cfg, ocfg, 0, device)
    if mesh is not None:
        state = sharding.shard_state(state, mesh)
    start = 0
    if mgr is not None:
        got = mgr.restore_resharded(state, mesh)
        if got is not None:
            start, state, extra = got
            say(f"[train] resumed from step {start}")

    t0 = time.time()
    for step in range(start, args.steps):
        batch = synthetic.batch_at(dcfg, step, device=device)
        state, metrics = train_step(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            say(f"step {step:5d} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"({(time.time()-t0)/max(step-start+1,1):.2f}s/step)",
                flush=True)
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state, extra={"data_step": step + 1},
                     mesh=mesh)
            say(f"[ckpt] saved step {step+1}")
    say("[train] done")
    return state


if __name__ == "__main__":
    main()
