"""Optimizers: AdamW (f32 moments) and Adafactor (factored second moment).

Counterpart of ``repro.optim.adamw``; the state mirrors the param tree.
Every moment is f32, and every scalar the reference computes in f32 (the
learning rate, ``1 - b ** step``, Adafactor's decay) is computed in
numpy f32 on the host with the reference's association, step for step.
A scalar that divides a tensor goes to the tensor's device as a 0-d
tensor, so the card divides as the CPU does (CUDA turns a division by a
host scalar into a product with its reciprocal). ``OptState.step`` is a
host int. ``apply`` returns new tensors and writes none of its inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Any
f32 = np.float32


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    kind: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: int
    mu: Optional[Params]       # adamw first moment
    nu: Optional[Params]       # adamw second moment
    vr: Optional[Params]       # adafactor row stats
    vc: Optional[Params]       # adafactor col stats


def lr_at(cfg: OptimConfig, step: int) -> np.float32:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in f32; the first
    step (0) gets lr > 0."""
    s = f32(step) + f32(1.0)
    warm = np.minimum(s / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    t = np.clip((s - f32(cfg.warmup_steps))
                / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                f32(0.0), f32(1.0))
    cos = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * t))
    scale = f32(cfg.min_lr_ratio) + f32(1.0 - cfg.min_lr_ratio) * cos
    return f32(cfg.lr) * warm * scale


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads: Params, max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[Params, torch.Tensor]:
    """``grads`` scaled to a global norm of at most ``max_norm``; ``norm``
    is theirs unless given (a rank's block of the gradient, clipped by
    the whole gradient's norm)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(_on(max_norm, norm) / torch.clamp(norm, min=1e-9),
                        max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    if len(shape) < 2:
        return None
    # factor the two largest dims (standard Adafactor rule)
    idx = sorted(range(len(shape)), key=lambda i: shape[i])[-2:]
    return min(idx), max(idx)


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def init(cfg: OptimConfig, params: Params) -> OptState:
    if cfg.kind == "adamw":
        def zeros(p):
            return _zeros(p.shape, p)
        return OptState(0, tree_map(zeros, params), tree_map(zeros, params),
                        None, None)
    if cfg.kind == "adafactor":
        def row(p):
            f = _factored_dims(p.shape)
            if f is None:
                return _zeros(p.shape, p)
            shape = list(p.shape)
            del shape[f[1]]
            return _zeros(shape, p)

        def col(p):
            f = _factored_dims(p.shape)
            if f is None:
                return _zeros((1,), p)
            shape = list(p.shape)
            del shape[f[0]]
            return _zeros(shape, p)
        return OptState(0, None, None, tree_map(row, params),
                        tree_map(col, params))
    raise ValueError(cfg.kind)


def _unzip(template: Params, out: Params, n: int):
    """A tree shaped like ``template`` whose leaves are n-tuples -> n trees
    shaped like ``template``."""
    tuples: list = []
    tree_map(lambda _, t: tuples.append(t), template, out)
    return tuple(tree_unflatten(template, [t[i] for t in tuples])
                 for i in range(n))


def _on(x, like: torch.Tensor) -> torch.Tensor:
    """A host f32 scalar as a 0-d tensor on ``like``'s device."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@torch.no_grad()
def apply(cfg: OptimConfig, state: OptState, params: Params, grads: Params,
          gnorm: Optional[torch.Tensor] = None
          ) -> Tuple[Params, OptState, dict]:
    """One update. Returns (new params, new state, {"grad_norm": f32 0-d
    tensor, "lr": f32}). ``gnorm`` is the gradient's global norm, computed
    here unless given: a mesh rank updates its block of the params and
    AdamW moments with the whole gradient's norm, and every AdamW step is
    elementwise, so the block is the block of the whole update, bit for
    bit."""
    grads = tree_map(lambda g: g.float(), grads)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, gnorm)
    lr = lr_at(cfg, state.step)
    step = state.step + 1

    if cfg.kind == "adamw":
        b1c = f32(1.0) - f32(cfg.b1) ** f32(step)
        b2c = f32(1.0) - f32(cfg.b2) ** f32(step)

        def upd(p, g, m, v):
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * g * g
            mhat = m / _on(b1c, m)
            vhat = v / _on(b2c, v)
            delta = mhat / (torch.sqrt(vhat) + cfg.eps)
            delta = delta + cfg.weight_decay * p.float()
            return (p.float() - float(lr) * delta).to(p.dtype), m, v

        new_p, new_m, new_v = _unzip(
            params, tree_map(upd, params, grads, state.mu, state.nu), 3)
        return new_p, OptState(step, new_m, new_v, None, None), {
            "grad_norm": gnorm, "lr": lr}
    if cfg.kind != "adafactor":
        raise ValueError(cfg.kind)

    # ---------------- adafactor (factored 2nd moment, no 1st moment)
    decay = f32(1.0) - f32(step) ** f32(-0.8)
    keep = f32(1.0) - decay
    lr_wd = f32(lr) * f32(cfg.weight_decay)

    def upd_af(p, g, vr, vc):
        fd = _factored_dims(p.shape)
        g2 = g * g + 1e-30
        if fd is None:
            vr_n = float(decay) * vr + float(keep) * g2
            precond = g * torch.rsqrt(vr_n + 1e-30)
            vc_n = vc
        else:
            r, c = fd
            vr_n = float(decay) * vr + float(keep) * g2.mean(dim=c)
            vc_n = float(decay) * vc + float(keep) * g2.mean(dim=r)
            denom = vr_n.mean() + 1e-30
            rfac = (vr_n / denom).unsqueeze(c)
            cfac = vc_n.unsqueeze(r)
            precond = g * torch.rsqrt(rfac * cfac + 1e-30)
        # update clipping (Adafactor rms-1 rule)
        rms = torch.sqrt(torch.mean(precond ** 2) + 1e-30)
        precond = precond / torch.clamp(rms, min=1.0)
        newp = (p.float() - float(lr) * precond
                - float(lr_wd) * p.float())
        return newp.to(p.dtype), vr_n, vc_n

    new_p, new_vr, new_vc = _unzip(
        params, tree_map(upd_af, params, grads, state.vr, state.vc), 3)
    return new_p, OptState(step, None, None, new_vr, new_vc), {
        "grad_norm": gnorm, "lr": lr}
