"""Train and serve step factories for every architecture family.

Counterpart of ``repro.train.steps``. ``make_train_step(cfg, optim_cfg)``
returns a (state, batch) -> (state, metrics) function: the loss and its
gradient by autograd with respect to the f32 master params, then one
optimizer update (``optim.adamw``). ``make_prefill_step`` /
``make_decode_step`` / ``make_denoise_step`` build the serving steps.
The JAX package jit-compiles these functions; the port runs them eagerly.

With a mesh (``make_train_step(..., mesh=)``) the step runs SPMD on the
ranks of a ``launch.mesh.Mesh`` (``make_sharded_train_step``): params and
moments rest as ``Shard`` leaves, each rank computes on its rows of the
global batch, and the gradient is summed over the data axes. The MoE
layers route the global batch all the same (``models.moe.moe_layer``).

The train state carries a host-int ``seed`` where the reference carries a
PRNG key: the diffusion loss draws its timesteps and noise from a CPU
generator keyed by (seed, step), as the reference folds the step into
its key (with microbatches, every microbatch draws from the key
(seed, step, 0), as the reference's fold-in of 0 does). The draws are made
on the CPU and moved to the batch's device, so the card and the CPU take
the same step.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.data.synthetic import generator
from repro_torch.diffusion import schedule as sched_lib
from repro_torch.distributed import constraints
from repro_torch.distributed import sharding as shd
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


def _diffusion_draws(latents: torch.Tensor, gen: Optional[torch.Generator]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The diffusion loss's (t, eps) for ``latents``: the (B,) timesteps,
    then the noise of the latents' shape, drawn from ``gen`` on the CPU."""
    t = torch.randint(0, sched_lib.DdpmSchedule.default(1000).num_steps,
                      (latents.shape[0],), generator=gen)
    return t, torch.randn(tuple(latents.shape), generator=gen)


def _diffusion_loss(cfg: ModelConfig, params, batch,
                    gen: Optional[torch.Generator] = None,
                    t: Optional[torch.Tensor] = None,
                    eps: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict]:
    """Standard DDPM epsilon-prediction MSE. ``t`` (B,) and ``eps`` (the
    latents' shape) are given together, or ``_diffusion_draws`` draws them
    from ``gen``."""
    latents = batch["latents"]
    sched = sched_lib.DdpmSchedule.default(1000)
    if t is None:
        t, eps = _diffusion_draws(latents, gen)
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


def loss_fn(cfg: ModelConfig, params, batch, gen: torch.Generator,
            draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """The family's training loss and its extras; ``draws`` is the
    diffusion loss's (t, eps), drawn from ``gen`` unless given."""
    if cfg.family in tf_lib.FAMILIES:
        return _lm_loss(cfg, params, batch)
    if cfg.family == "encdec":
        return _encdec_loss(cfg, params, batch)
    if cfg.family in ("dit", "unet"):
        return _diffusion_loss(cfg, params, batch, gen, *(draws or ()))
    raise ValueError(cfg.family)


def value_and_grad(cfg: ModelConfig, params, batch, gen: torch.Generator,
                   draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Dict, Any]:
    """(loss, extras, grads): the gradient of ``loss_fn`` with respect to
    every leaf of ``params`` (zeros for a leaf the loss does not reach,
    as JAX gives), all detached."""
    live = [leaf.detach().requires_grad_(True)
            for leaf in tree_leaves(params)]
    with torch.enable_grad():
        loss, extras = loss_fn(cfg, tree_unflatten(params, live), batch,
                               gen, draws)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return (loss.detach(), {k: v.detach() for k, v in extras.items()},
            tree_unflatten(params, grads))


def _rows_value_and_grad(cfg: ModelConfig, params, batch: Dict,
                         gen: torch.Generator, rows: slice, mesh=None
                         ) -> Tuple[torch.Tensor, Dict, Any]:
    """``value_and_grad`` on ``rows`` of ``batch``; the diffusion loss's
    ``t`` and ``eps`` are drawn for the whole batch (``_diffusion_draws``)
    and cut to the same rows. With ``mesh`` (the rows split over its data
    axes) inside ``constraints.split_rows(mesh)``."""
    draws = None
    if cfg.family in ("dit", "unet"):
        draws = tuple(x[rows] for x in _diffusion_draws(batch["latents"],
                                                        gen))
    scope = (contextlib.nullcontext() if mesh is None
             else constraints.split_rows(mesh))
    with scope:
        return value_and_grad(cfg, params,
                              {k: v[rows] for k, v in batch.items()},
                              gen, draws)


def _batch_grads(cfg: ModelConfig, params, batch: Dict, state: "TrainState",
                 microbatches: int, rows_of: Callable[[int], slice],
                 mesh=None) -> Tuple[torch.Tensor, Dict, Any, bool]:
    """(loss, extras, grads, split) over ``batch``: with ``microbatches >
    1`` accumulated over that many slices of it, one after another
    (dividing the live-activation footprint by the microbatch count), each
    drawing from the generator (seed, step, 0) as the reference's fold-in
    of 0 does; ``rows_of(m)`` is the rows of m this rank computes of each
    (``split``: fewer than all, over ``mesh``'s data axes)."""
    n = next(iter(batch.values())).shape[0]
    m = n // max(microbatches, 1)
    rows = rows_of(m)
    split = rows.stop - rows.start < m
    scope = mesh if split else None
    if microbatches <= 1:
        return _rows_value_and_grad(
            cfg, params, batch, generator(state.seed, state.step),
            rows, scope) + (split,)
    grads = tree_map(torch.zeros_like, params)
    loss = 0.0
    for i in range(microbatches):
        mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
        l_i, extras, g_i = _rows_value_and_grad(
            cfg, params, mb, generator(state.seed, state.step, 0), rows,
            scope)
        grads = tree_map(torch.add, grads, g_i)
        loss = loss + l_i
    grads = tree_map(lambda g: g / microbatches, grads)
    return loss / microbatches, extras, grads, split


def make_train_step(cfg: ModelConfig, optim_cfg: optim_lib.OptimConfig,
                    microbatches: int = 1, mesh=None
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """Build the train step; ``microbatches > 1`` accumulates the gradient
    over that many slices of the batch, one after another, dividing the
    live-activation footprint by the microbatch count. With a ``mesh``
    the step runs SPMD on its ranks (``make_sharded_train_step``)."""
    if mesh is not None:
        return make_sharded_train_step(cfg, optim_cfg, mesh, microbatches)

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        loss, extras, grads, _ = _batch_grads(
            cfg, state.params, batch, state, microbatches,
            lambda m: slice(0, m))
        params, opt, om = optim_lib.apply(optim_cfg, state.opt, state.params,
                                          grads)
        metrics = {"loss": loss, **extras, **om}
        return TrainState(params, opt, state.step + 1, state.seed), metrics

    return train_step


# ------------------------------------------------------ sharded train step
def _same_on_every_rank(mesh, values) -> None:
    """Raise unless every rank holds the same bits of each f32 0-d tensor
    in ``values`` (one integer sum of every rank's bits, in its slot)."""
    mine = torch.stack([v.detach().float().reshape(()) for v in values])
    slots = torch.zeros((mesh.size, len(values)), dtype=torch.int32,
                        device=mine.device)
    slots[mesh.rank] = mine.view(torch.int32)
    mesh.sum_bytes(slots)
    if slots.is_meta:       # a count (launch.dryrun): no values to compare
        return
    if not bool((slots == slots[mesh.rank]).all()):
        raise RuntimeError(f"replicated values differ across the ranks of "
                           f"{mesh}: {slots.view(torch.float32).tolist()}")


def _data_size(mesh) -> int:
    return math.prod(shd.axis_size(mesh, a) for a in shd.data_axes(mesh))


def sharded_value_and_grad(cfg: ModelConfig, state: TrainState,
                           batch: Dict, mesh, microbatches: int = 1
                           ) -> Tuple[Any, torch.Tensor, Dict, Any]:
    """(whole params, loss, extras, whole gradient) of a sharded step: the
    params gathered whole, exactly (integer sums over their bits);
    ``value_and_grad`` on the rank's rows of each microbatch of the GLOBAL
    ``batch`` (``sharding.batch_rows``: a block over the (pod, data) axes,
    or every row when they do not divide it; the diffusion draws made for
    the whole microbatch); when the rows were split, the gradient, loss
    and extras summed over the data axes and divided by their size (every
    loss here is a token or element mean with no mask, so that is the
    global batch's mean).

    While the rows are split, each microbatch's ``value_and_grad`` runs
    inside ``constraints.split_rows(mesh)``: an MoE layer routes the
    microbatch's global tokens and returns the global aux loss on every
    rank. A rank's objective is then xent_r + 0.01 aux; the gather's
    backward sums over the ranks, so the summed gradient is that of
    sum_r xent_r + n 0.01 aux, and dividing by n gives the gradient of
    the global batch's loss, mean xent + 0.01 aux."""
    params = constraints.gather(state.params, mesh)
    loss, extras, grads, split = _batch_grads(
        cfg, params, batch, state, microbatches,
        lambda m: shd.batch_rows(m, mesh), mesh)
    if split:
        dsize = _data_size(mesh)
        grads = tree_map(lambda g: g.contiguous(), grads)
        for g in tree_leaves(grads):
            mesh.all_reduce(g, group=mesh.data_group).div_(dsize)
        names = sorted(extras)
        sums = torch.stack([loss] + [extras[k] for k in names])
        mesh.all_reduce(sums, group=mesh.data_group).div_(dsize)
        loss, extras = sums[0], dict(zip(names, sums[1:]))
    return params, loss, extras, grads


def sharded_update(optim_cfg: optim_lib.OptimConfig, state: TrainState,
                   grads: Any, gnorm: torch.Tensor, mesh,
                   params: Any = None) -> Tuple[Any, optim_lib.OptState,
                                                Dict]:
    """(new params, new optimizer state, metrics): the optimizer applied
    with the whole gradient's norm ``gnorm``, each rank keeping its block.
    AdamW runs on the blocks of the params, moments and ``grads`` (it is
    elementwise, so each block is the block of the whole update, bit for
    bit); Adafactor, whose factored statistics span whole tensors, on the
    whole ``params`` (gathered unless given) and gathered moments, cut to
    blocks after."""
    opt = state.opt
    if optim_cfg.kind == "adamw":
        new_p, new_opt, om = optim_lib.apply(
            optim_cfg, opt._replace(mu=shd.local(opt.mu),
                                    nu=shd.local(opt.nu)),
            shd.local(state.params), shd.block_of(grads, state.params, mesh),
            gnorm=gnorm)
        return (shd.rewrap(new_p, state.params),
                new_opt._replace(mu=shd.rewrap(new_opt.mu, opt.mu),
                                 nu=shd.rewrap(new_opt.nu, opt.nu)), om)
    if params is None:
        params = constraints.gather(state.params, mesh)
    new_p, new_opt, om = optim_lib.apply(
        optim_cfg, constraints.gather(opt, mesh), params, grads, gnorm=gnorm)
    return (shd.reshard_like(new_p, state.params, mesh),
            shd.reshard_like(new_opt, opt, mesh), om)


def make_sharded_train_step(cfg: ModelConfig,
                            optim_cfg: optim_lib.OptimConfig, mesh,
                            microbatches: int = 1
                            ) -> Callable[[TrainState, Dict],
                                          Tuple[TrainState, Dict]]:
    """The train step SPMD on ``mesh`` (``launch.mesh.Mesh``): the data
    and tensor parallelism the reference's jitted step computes under
    GSPMD. The state holds its params and moments as ``Shard`` leaves
    (``sharding.shard_state``); the step takes the GLOBAL batch, which
    every rank regenerates (``data.synthetic.batch_at``), and runs
    ``sharded_value_and_grad``, checks that every rank holds the same
    loss and gradient norm, then ``sharded_update``. On the ``model`` axis
    alone every rank computes the whole batch and the step is bit-equal
    to one process. The MoE family routes over the whole batch (capacity,
    drops and the aux loss count all T tokens): on a data axis above 1
    each MoE layer gathers the global tokens (``models.moe.moe_layer``)."""
    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        params, loss, extras, grads = sharded_value_and_grad(
            cfg, state, batch, mesh, microbatches)
        if optim_cfg.kind == "adamw":
            params = None       # the update reads blocks only: free it
        norm = optim_lib.global_norm(grads)
        _same_on_every_rank(mesh, [loss, norm])
        new_p, new_opt, om = sharded_update(optim_cfg, state, grads, norm,
                                            mesh, params)
        metrics = {"loss": loss, **extras, **om}
        return TrainState(new_p, new_opt, state.step + 1,
                          state.seed), metrics

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
