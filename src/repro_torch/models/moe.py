"""Mixture-of-Experts FFN: top-k routing, capacity-based dispatch.

Counterpart of ``repro.models.moe``. Sort-based dispatch: the token ->
expert assignments are ranked inside each expert (a stable ``argsort``
and ``searchsorted``), dropped beyond the capacity, scattered into
``(E, C, d)`` slots, run through dense batched expert GEMMs
(``torch.bmm``) and combined back with the router weights. Shared experts
run as a plain gated FFN on every token. Covers deepseek-moe (2 shared +
64 routed, top-6) and kimi-k2 (1 shared + 384 routed, top-8).

Kept as the reference has them: the capacity ``max(int(cf * T * k / E),
1)`` rounded up to a multiple of 64; dropped assignments scatter zeros
into slot 0; the top-k weights renormalised with a 1e-9 floor; the router
applied cast to the activation dtype with an f32 softmax; silu in f32.
Top-k is a stable descending sort, so equal probabilities go to the lower
expert index first, as ``lax.top_k`` orders them (``torch.topk`` leaves
ties unordered): a faulted residual that overflows the norm leaves a zero
row, and its router probabilities all tie.
The combine adds each token's k contributions in assignment order onto
zeros, as the reference's scatter-add does, but as k dense adds: an
``index_add_`` on the card adds with atomics, in no fixed order, and a
decode must give the same tokens on every replay. The reference's
sharding constraints have no counterpart here: the sharded engine runs
a language model's bucket whole on every rank (``serving.sharded``).

A train step whose rows are split over a mesh's data axes routes the
global batch, as the reference's jitted step does under GSPMD
(``moe_layer``): each rank gathers the group's tokens, runs ``moe_ffn``
on all T of them (capacity, drops and the aux loss count every token)
and keeps its own rows of ``y``. The expert compute is duplicated on
every data rank (ROADMAP Queue A 15).

The expert FFNs are unprotected, as in the reference: no GEMM here goes
through an execution context, so serving injects and detects on the
attention projections only.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import constraints
from repro_torch.models.common import (ModelConfig, Params, dense_init,
                                       trunc_normal)


def init_moe_params(cfg: ModelConfig, generator: torch.Generator,
                    device="cpu", cast: Callable = lambda w: w) -> Params:
    """The reference's init law, drawn from ``generator`` in its order:
    the router (kept f32), the routed experts' ``w_gate``, ``w_up``,
    ``w_down`` (std d^-1/2, d^-1/2, f^-1/2), then the shared experts'.
    ``cast`` takes each weight as it is drawn."""
    e, d, f, pdt = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.param_dtype

    def draw(shape, std):
        return cast(trunc_normal(shape, std, pdt, device, generator))

    p: Params = {
        "router": cast(dense_init(d, e, torch.float32, device, generator)),
        "w_gate": draw((e, d, f), d ** -0.5),
        "w_up": draw((e, d, f), d ** -0.5),
        "w_down": draw((e, f, d), f ** -0.5),
    }
    if cfg.n_shared_experts:
        fs = cfg.d_ff * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": cast(dense_init(d, fs, pdt, device, generator)),
            "w_up": cast(dense_init(d, fs, pdt, device, generator)),
            "w_down": cast(dense_init(fs, d, pdt, device, generator)),
        }
    return p


def capacity(cfg: ModelConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens: ``cf * T * k / E``, at least 1,
    rounded up to a multiple of 64."""
    c = max(int(cfg.capacity_factor * t * cfg.top_k / cfg.n_experts), 1)
    return -(-c // 64) * 64


class Routing(NamedTuple):
    """Where each of the T * k assignments (token-major) goes."""
    probs: torch.Tensor      # (T, E) f32 router softmax
    flat_e: torch.Tensor     # (T*k,) expert of each assignment
    flat_w: torch.Tensor     # (T*k,) renormalised router weight, f32
    rank: torch.Tensor       # (T*k,) int32 position inside its expert
    keep: torch.Tensor       # (T*k,) bool: rank < capacity
    slot: torch.Tensor       # (T*k,) flat slot, 0 where dropped
    capacity: int


def route(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor
          ) -> Routing:
    """Top-k routing of ``x`` (T, d) and each assignment's slot."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, t)
    logits = (x @ router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    flat_e = top_i.reshape(-1)
    n = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    run_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.empty((n,), dtype=torch.int32, device=x.device)
    rank[order] = (torch.arange(n, device=x.device)
                   - run_start).to(torch.int32)
    keep = rank < cap
    slot = torch.where(keep, flat_e * cap + rank, 0)
    return Routing(probs, flat_e, top_w.reshape(-1), rank, keep, slot, cap)


def moe_ffn(cfg: ModelConfig, p: Params, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) -> (y: (T, d), aux_loss: f32 scalar)."""
    t, d = x.shape
    e, k, dt = cfg.n_experts, cfg.top_k, x.dtype
    r = route(cfg, p["router"], x)
    cap = r.capacity

    # dispatch: kept assignments land in distinct slots, dropped ones add
    # zeros into slot 0
    keep_x = r.keep[:, None].to(dt)
    x_rep = x.repeat_interleave(k, dim=0)                  # (T*k, d)
    dispatched = torch.zeros((e * cap, d), dtype=dt, device=x.device)
    dispatched.index_add_(0, r.slot, x_rep * keep_x)
    xd = dispatched.reshape(e, cap, d)

    # dense expert GEMMs
    gate = torch.bmm(xd, p["w_gate"].to(dt))
    up = torch.bmm(xd, p["w_up"].to(dt))
    h = F.silu(gate.float()).to(dt) * up
    ye = torch.bmm(h, p["w_down"].to(dt))

    # combine, each token's k contributions in assignment order
    gathered = torch.where(r.keep[:, None], ye.reshape(e * cap, d)[r.slot],
                           torch.zeros((1, d), dtype=dt, device=x.device))
    contrib = (gathered * r.flat_w[:, None].to(dt)).reshape(t, k, d)
    y = torch.zeros((t, d), dtype=dt, device=x.device)
    for j in range(k):
        y = y + contrib[:, j]

    if cfg.n_shared_experts:
        sp = p["shared"]
        g = F.silu((x @ sp["w_gate"].to(dt)).float())
        y = y + (g.to(dt) * (x @ sp["w_up"].to(dt))) @ sp["w_down"].to(dt)

    # load-balance aux loss (Switch-style)
    kept = r.keep.float()
    frac_tokens = torch.zeros((e,), dtype=torch.float32,
                              device=x.device).index_add_(
        0, r.flat_e, kept) / torch.clamp_min(kept.sum(), 1.0)
    aux = e * torch.sum(frac_tokens * r.probs.mean(dim=0))
    return y, aux


def moe_layer(cfg: ModelConfig, p: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A layer's MoE FFN on its flattened tokens x (T_local, d): ``moe_ffn``
    itself, or, inside ``constraints.split_rows(mesh)``, ``moe_ffn`` on
    the data group's tokens (``constraints.gather_rows_grad``, the ranks'
    blocks in order: one process's token order) with this rank's rows of
    ``y`` and the whole batch's aux loss, the same on every rank."""
    mesh = constraints.split_rows_mesh()
    if mesh is None:
        return moe_ffn(cfg, p, x)
    y, aux = moe_ffn(cfg, p, constraints.gather_rows_grad(x, mesh))
    i, _ = constraints.data_block(mesh)
    m = x.shape[0]
    return y[i * m:(i + 1) * m], aux


def moe_param_count(cfg: ModelConfig) -> int:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    n = e * (3 * d * f) + d * e
    if cfg.n_shared_experts:
        n += 3 * d * f * cfg.n_shared_experts
    return n
