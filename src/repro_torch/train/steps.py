"""Train and serve step factories for every architecture family.

Counterpart of ``repro.train.steps``. ``make_train_step(cfg, optim_cfg)``
returns a (state, batch) -> (state, metrics) function: the loss and its
gradient by autograd with respect to the f32 master params, then one
optimizer update (``optim.adamw``). ``make_prefill_step`` /
``make_decode_step`` / ``make_denoise_step`` build the serving steps.
The JAX package jit-compiles these functions; the port runs them eagerly.

The train state carries a host-int ``seed`` where the reference carries a
PRNG key: the diffusion loss draws its timesteps and noise from a CPU
generator keyed by (seed, step), as the reference folds the step into
its key (with microbatches, every microbatch draws from the key
(seed, step, 0), as the reference's fold-in of 0 does). The draws are made
on the CPU and moved to the batch's device, so the card and the CPU take
the same step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.data.synthetic import generator
from repro_torch.diffusion import schedule as sched_lib
from repro_torch.models import dit as dit_lib
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models import unet as unet_lib
from repro_torch.models.common import ModelConfig
from repro_torch.optim import adamw as optim_lib
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt: optim_lib.OptState
    step: int
    seed: int


def init_model_params(cfg: ModelConfig, seed: int, device="cuda") -> Any:
    if cfg.family in tf_lib.FAMILIES:
        return tf_lib.init_params(cfg, seed, device)
    if cfg.family == "encdec":
        return encdec_lib.init_params(cfg, seed, device)
    if cfg.family == "dit":
        return dit_lib.init_params(cfg, seed, device)
    if cfg.family == "unet":
        return unet_lib.init_params(cfg, seed, device)
    raise ValueError(cfg.family)


def init_train_state(cfg: ModelConfig, optim_cfg: optim_lib.OptimConfig,
                     seed: int = 0, device="cuda") -> TrainState:
    params = init_model_params(cfg, seed, device)
    return TrainState(params, optim_lib.init(optim_cfg, params), 0, seed)


# ----------------------------------------------------------------- losses
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy; logits f32 (B, S, V), labels (B, S)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)


def _lm_loss(cfg: ModelConfig, params, batch) -> Tuple[torch.Tensor, Dict]:
    tokens = batch["tokens"]
    vis = batch.get("vis_embeds")
    logits, aux = tf_lib.forward(cfg, params, tokens[:, :-1],
                                 vis_embeds=vis)
    labels = tokens[:, 1:]
    if vis is not None:
        # loss only over text positions (the vis prefix predicts nothing)
        logits = logits[:, cfg.vis_tokens:]
    loss = softmax_xent(logits, labels) + 0.01 * aux
    return loss, {"aux_loss": aux}


def _encdec_loss(cfg: ModelConfig, params, batch
                 ) -> Tuple[torch.Tensor, Dict]:
    memory = encdec_lib.encode(cfg, params, batch["frames"])
    logits = encdec_lib.decode_train(cfg, params, batch["tokens"][:, :-1],
                                     memory)
    return softmax_xent(logits, batch["tokens"][:, 1:]), {}


def _diffusion_loss(cfg: ModelConfig, params, batch,
                    gen: Optional[torch.Generator] = None,
                    t: Optional[torch.Tensor] = None,
                    eps: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict]:
    """Standard DDPM epsilon-prediction MSE. ``t`` (B,) and ``eps`` (the
    latents' shape) are drawn from ``gen`` on the CPU unless given."""
    latents = batch["latents"]
    b = latents.shape[0]
    sched = sched_lib.DdpmSchedule.default(1000)
    if t is None:
        t = torch.randint(0, sched.num_steps, (b,), generator=gen)
    if eps is None:
        eps = torch.randn(tuple(latents.shape), generator=gen)
    t, eps = t.to(latents.device), eps.to(latents.device)
    x_t = sched.q_sample(latents, t, eps)
    if cfg.family == "dit":
        if cfg.cond_tokens:
            pred, _ = dit_lib.forward(cfg, params, x_t, t.float(), None,
                                      text=batch["text"])
        else:
            pred, _ = dit_lib.forward(cfg, params, x_t, t.float(),
                                      batch["labels"])
    else:
        pred = unet_lib.forward(cfg, params, x_t, t.float(),
                                batch.get("text"))
    return torch.mean((pred - eps) ** 2), {}


def loss_fn(cfg: ModelConfig, params, batch, gen: torch.Generator
            ) -> Tuple[torch.Tensor, Dict]:
    """The family's training loss and its extras."""
    if cfg.family in tf_lib.FAMILIES:
        return _lm_loss(cfg, params, batch)
    if cfg.family == "encdec":
        return _encdec_loss(cfg, params, batch)
    if cfg.family in ("dit", "unet"):
        return _diffusion_loss(cfg, params, batch, gen)
    raise ValueError(cfg.family)


def value_and_grad(cfg: ModelConfig, params, batch, gen: torch.Generator
                   ) -> Tuple[torch.Tensor, Dict, Any]:
    """(loss, extras, grads): the gradient of ``loss_fn`` with respect to
    every leaf of ``params`` (zeros for a leaf the loss does not reach,
    as JAX gives), all detached."""
    live = [leaf.detach().requires_grad_(True)
            for leaf in tree_leaves(params)]
    with torch.enable_grad():
        loss, extras = loss_fn(cfg, tree_unflatten(params, live), batch,
                               gen)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return (loss.detach(), {k: v.detach() for k, v in extras.items()},
            tree_unflatten(params, grads))


def make_train_step(cfg: ModelConfig, optim_cfg: optim_lib.OptimConfig,
                    microbatches: int = 1
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """Build the train step; ``microbatches > 1`` accumulates the gradient
    over that many slices of the batch, one after another, dividing the
    live-activation footprint by the microbatch count."""
    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        if microbatches <= 1:
            loss, extras, grads = value_and_grad(
                cfg, state.params, batch, generator(state.seed, state.step))
        else:
            grads = tree_map(torch.zeros_like, state.params)
            loss = 0.0
            for i in range(microbatches):
                mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                l_i, extras, g_i = value_and_grad(
                    cfg, state.params, mb,
                    generator(state.seed, state.step, 0))
                grads = tree_map(torch.add, grads, g_i)
                loss = loss + l_i
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
        params, opt, om = optim_lib.apply(optim_cfg, state.opt, state.params,
                                          grads)
        metrics = {"loss": loss, **extras, **om}
        return TrainState(params, opt, state.step + 1, state.seed), metrics

    return train_step


# ----------------------------------------------------------- serve steps
def make_prefill_step(cfg: ModelConfig, max_seq: int):
    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.family == "encdec":
            memory = encdec_lib.encode(cfg, params, batch["frames"])
            return encdec_lib.decode_train(cfg, params, batch["tokens"],
                                           memory)
        logits, cache = tf_lib.prefill(cfg, params, batch["tokens"], max_seq,
                                       vis_embeds=batch.get("vis_embeds"))
        return logits[:, -1], cache
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def decode_step(params, cache, tokens):
        if cfg.family == "encdec":
            return encdec_lib.decode_step(cfg, params, cache, tokens)
        logits, cache2, _ = tf_lib.decode_step(cfg, params, cache, tokens)
        return logits, cache2
    return decode_step


def make_denoise_step(cfg: ModelConfig):
    """One diffusion sampling step (the paper's serve unit); ``t`` is a
    host int."""
    sched = sched_lib.DdpmSchedule.default(1000)

    @torch.no_grad()
    def denoise_step(params, latents, t: int, cond):
        tt = torch.full((latents.shape[0],), float(t), dtype=torch.float32,
                        device=latents.device)
        if cfg.family == "dit":
            if cfg.cond_tokens:
                eps, _ = dit_lib.forward(cfg, params, latents, tt, None,
                                         text=cond)
            else:
                eps, _ = dit_lib.forward(cfg, params, latents, tt, cond)
        else:
            eps = unet_lib.forward(cfg, params, latents, tt, cond)
        return sched.ddim_step(latents, eps, t, t - 1)
    return denoise_step
