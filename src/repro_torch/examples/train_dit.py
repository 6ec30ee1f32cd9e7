"""End-to-end example: train a ~100M-parameter DiT for a few hundred steps.

Counterpart of ``examples/train_dit.py``: the synthetic class-conditioned
latent dataset (``data.synthetic``), AdamW with warmup and cosine decay,
and fault-tolerant checkpoints with auto-resume on restart, through the
port's ``train.steps``, ``optim.adamw`` and ``checkpoint.manager``:

    PYTHONPATH=src python -m repro_torch.examples.train_dit --steps 300

Checkpoints go to ``experiments/dit_train_ckpt_torch`` at the root of
the checkout (``--ckpt-dir``). Each holds the whole train state
(params, AdamW moments, step, seed), so a restart resumes where the last
save left off; the reference saves the params alone.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.dit_xl_512 import TRAIN_100M
from repro_torch.data import synthetic
from repro_torch.models import dit as dit_lib
from repro_torch.optim.adamw import OptimConfig
from repro_torch.train import steps as steps_lib

CKPT = Path(__file__).resolve().parents[3] / "experiments" / \
    "dit_train_ckpt_torch"


def train(cfg, ocfg: OptimConfig, state: steps_lib.TrainState,
          batch_at: Callable[[int], Dict[str, torch.Tensor]], steps: int,
          mgr: Optional[CheckpointManager] = None, ckpt_every: int = 100,
          log=print):
    """Train from ``state.step`` up to ``steps``, one ``batch_at(step)``
    each, saving the state every ``ckpt_every`` steps and at the end;
    returns (state, losses)."""
    step_fn = steps_lib.make_train_step(cfg, ocfg)
    losses: List[float] = []
    start = state.step
    t0 = time.time()
    for step in range(start, steps):
        state, m = step_fn(state, batch_at(step))
        losses.append(float(m["loss"]))
        if step % 20 == 0 or step == steps - 1:
            log(f"step {step:4d} loss {losses[-1]:.4f} "
                f"({(time.time() - t0) / max(step - start + 1, 1):.2f}"
                "s/step)")
        if mgr is not None and ((step + 1) % ckpt_every == 0
                                or step == steps - 1):
            mgr.save(step + 1, state)
            log(f"[ckpt] saved the train state at step {step + 1}")
    return state, losses


def main(argv: Optional[list] = None) -> List[float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=str(CKPT))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = TRAIN_100M
    n = dit_lib.param_count(cfg)
    print(f"[train_dit] {cfg.name}: {n / 1e6:.1f}M params, "
          f"latent {cfg.latent_size}x{cfg.latent_size}")
    ocfg = OptimConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    dcfg = synthetic.for_model(cfg, args.batch, seed=7)
    state = steps_lib.init_train_state(cfg, ocfg, 0, args.device)
    mgr = CheckpointManager(args.ckpt_dir, keep_last=2)
    got = mgr.restore_latest(state)
    if got is not None:
        _, state, _ = got
        print(f"[train_dit] resumed at step {state.step}")
    state, losses = train(
        cfg, ocfg, state,
        lambda step: synthetic.batch_at(dcfg, step, device=args.device),
        args.steps, mgr, args.ckpt_every,
        log=lambda s: print(s, flush=True))
    if losses:
        first, last = np.mean(losses[:20]), np.mean(losses[-20:])
        print(f"[train_dit] loss {first:.4f} -> {last:.4f} "
              f"({'DECREASED' if last < first else 'no decrease'})")
    return losses


if __name__ == "__main__":
    main()
