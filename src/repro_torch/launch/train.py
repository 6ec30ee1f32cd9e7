"""Training launcher on PyTorch: the train loop with checkpoints and
auto-resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --steps 200 --global-batch 8 --seq 128 --ckpt-dir build/run1

Counterpart of ``repro.launch.train`` on one device: the same flags and
defaults (``--smoke`` is on and, as in the reference, cannot be turned
off), plus ``--device`` (default "cuda"; without a GPU it raises). It
prints ``elastic.plan_mesh``'s plan for the one device and the
reference's log lines. ``--model-parallel`` above 1 needs the port's
multi-device path (ROADMAP Queue A item 13) and raises. With
``--ckpt-dir`` it restores the newest valid checkpoint there, then saves
the train state every ``--ckpt-every`` steps (with the data step, which is
all the synthetic pipeline's state). ``main(argv)`` returns the final
``TrainState``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import synthetic
from repro_torch.distributed import elastic
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
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs the multi-device path, not yet "
            "ported to repro_torch (ROADMAP Queue A item 13)")
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    mesh_shape, axes = elastic.plan_mesh(1, args.model_parallel)
    print(f"[train] {cfg.name} on mesh {dict(zip(axes, mesh_shape))}")

    ocfg = OptimConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                       total_steps=args.steps)
    dcfg = synthetic.for_model(cfg, args.global_batch, args.seq)
    train_step = steps_lib.make_train_step(cfg, ocfg)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    state = steps_lib.init_train_state(cfg, ocfg, 0, args.device)
    start = 0
    if mgr is not None:
        got = mgr.restore_latest(state)
        if got is not None:
            start, state, extra = got
            print(f"[train] resumed from step {start}")

    t0 = time.time()
    for step in range(start, args.steps):
        batch = synthetic.batch_at(dcfg, step, device=args.device)
        state, metrics = train_step(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time()-t0)/max(step-start+1,1):.2f}s/step)",
                  flush=True)
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state, extra={"data_step": step + 1})
            print(f"[ckpt] saved step {step+1}")
    print("[train] done")
    return state


if __name__ == "__main__":
    main()
