"""Diffusion Transformer (DiT) with adaLN-Zero: class-conditional, and the
PixArt-alpha variant with cross-attention to text tokens.

Counterpart of ``repro.models.dit``. Every projection GEMM goes through an
optional ``ExecContext`` with the reference's resilience classes: patch,
timestep, text and final GEMMs are ``CLASS_EMBED`` (one context, scope
1000), block 0 is ``CLASS_FIRST_BLOCK``, the other blocks ``CLASS_BODY``
(one context per block, scope = layer index). The adaLN modulations are
plain, unprotected matmuls, as in the reference. Self-attention runs
through the attention kernel's (B, S, H, D) wrapper ``kernels.
flash_attention.mha_flash``, which takes the plain ``full_attention`` for
CPU tensors.

PixArt (``cfg.cond_tokens > 0``) conditions on ``text`` (B, Tt, cond_dim):
``text_proj`` projects it (GEMM ``"text"``), its token mean takes the class
embedding's place in ``c``, and each block adds a cross-attention branch
between self-attention and the MLP (``xattn.{q,k,v,o}``; k and v from the
projected text). Cross-attention has Tt keys against T queries, which
neither the Pallas kernel nor its port takes, so it runs the plain
``full_attention``, as in the reference.

Parameters are a nested dict like the reference's, except that ``blocks``
is a list with one dict per layer (the reference stacks them on a leading
L axis for ``lax.scan``); ``params_from_jax`` converts.

On the sharded engine (``distributed.constraints``) the weights rest as
shards: ``forward`` gathers the top-level ones once and each block's at
the block boundary. The adaLN modulations (M = batch, a float GEMM whose
library kernel depends on the row count) run on the data group's
gathered conditioning rows; without a mesh policy none of this adds an
op.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import dvfs
from repro_torch.core.exec_ctx import DriftSystemConfig, ExecContext
from repro_torch.distributed import constraints
from repro_torch.kernels.abft_matmul import TILE
from repro_torch.kernels.flash_attention import mha_flash
from repro_torch.models.attention import full_attention
from repro_torch.models.common import (ModelConfig, Params, dense_init,
                                       layernorm, trunc_normal)

EMBED_SCOPE = 1000


def _check_cfg(cfg: ModelConfig) -> None:
    if cfg.family != "dit":
        raise ValueError(f"{cfg.name}: models.dit takes the dit family, got "
                         f"{cfg.family!r}")


# ---------------------------------------------------------------- params
def init_params(cfg: ModelConfig, seed: int, device="cpu") -> Params:
    """Random params from ``seed`` with the reference's init law: truncated
    normal projections, adaLN-Zero (``adaln_w``, ``final_adaln_w`` and
    ``final_w`` are zeros, so a fresh model predicts eps = 0)."""
    _check_cfg(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    d, f, pdim = cfg.d_model, cfg.d_ff, cfg.patch_dim
    hd = cfg.n_heads * cfg.hd
    pdt = cfg.param_dtype

    def dense(a, b):
        return dense_init(a, b, pdt, device, g)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pdt, device=device)

    def attn():
        return {"wq": dense(d, hd), "wk": dense(d, hd), "wv": dense(d, hd),
                "wo": dense(hd, d)}

    blocks = []
    for _ in range(cfg.n_layers):
        blk = {"adaln_w": zeros(d, 6 * d), "adaln_b": zeros(6 * d),
               "attn": attn(), "mlp_w1": dense(d, f), "mlp_w2": dense(f, d)}
        if cfg.cond_tokens:   # PixArt: cross-attention to text tokens
            blk["xattn"] = attn()
        blocks.append(blk)
    p = {
        "patch_w": dense(pdim, d), "patch_b": zeros(d),
        "pos_embed": trunc_normal((cfg.tokens, d), 0.02, pdt, device, g),
        "t_w1": dense(256, d), "t_b1": zeros(d),
        "t_w2": dense(d, d), "t_b2": zeros(d),
        "blocks": blocks,
        "final_adaln_w": zeros(d, 2 * d), "final_adaln_b": zeros(2 * d),
        "final_w": zeros(d, pdim), "final_b": zeros(pdim),
    }
    if cfg.cond_tokens:
        p["text_proj"] = dense(cfg.cond_dim, d)
    else:
        p["class_embed"] = trunc_normal((cfg.num_classes + 1, d), 0.02, pdt,
                                        device, g)
    return p


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Params:
    """The port's params from the reference's param pytree (leaves as numpy
    arrays or anything ``np.asarray`` takes), unstacking the (L, ...)
    ``blocks`` leaves into one dict per layer."""
    def conv(x):
        return torch.from_numpy(np.array(x)).to(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return conv(t)

    out = {k: walk(v) for k, v in tree.items() if k != "blocks"}
    stacked = walk(tree["blocks"])
    n_layers = stacked["mlp_w1"].shape[0]

    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        return t[i].contiguous()
    out["blocks"] = [take(stacked, i) for i in range(n_layers)]
    return out


# --------------------------------------------------------------- helpers
def timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def patchify(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, T, p*p*C)."""
    b, hh, ww, c = x.shape
    p = cfg.patch_size
    x = x.reshape(b, hh // p, p, ww // p, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, (hh // p) * (ww // p),
                                               p * p * c)


def unpatchify(cfg: ModelConfig, x: torch.Tensor, hh: int, ww: int
               ) -> torch.Tensor:
    b = x.shape[0]
    p = cfg.patch_size
    x = x.reshape(b, hh // p, ww // p, p, p, cfg.latent_channels)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww,
                                               cfg.latent_channels)


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _proj(ctx: Optional[ExecContext], x, w, name, rclass):
    if ctx is None:
        return x @ w.to(x.dtype)
    lead = x.shape[:-1]
    y = ctx.matmul(x.reshape(-1, x.shape[-1]), w.to(x.dtype), name=name,
                   rclass=rclass)
    return y.reshape(*lead, -1)


def _adaln(c: torch.Tensor, w, b, dtype) -> torch.Tensor:
    """Plain, unprotected adaLN modulation: SiLU in f32, then a matmul in
    the activation dtype. ``c`` holds the data group's rows (the batch's
    own without a sharded batch); this rank's rows come back."""
    return constraints.own_rows(
        F.silu(c.float()).to(dtype) @ w.to(dtype) + b.to(dtype))


# ---------------------------------------------------------------- blocks
def dit_block(cfg: ModelConfig, p: Params, x: torch.Tensor, c: torch.Tensor,
              text: Optional[torch.Tensor] = None,
              ctx: Optional[ExecContext] = None,
              rclass: int = dvfs.CLASS_BODY) -> torch.Tensor:
    b, t, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    # c: the data group's conditioning rows (see ``forward``)
    mod = _adaln(c, p["adaln_w"], p["adaln_b"], x.dtype)
    s1, sc1, g1, s2, sc2, g2 = torch.chunk(mod, 6, dim=-1)

    xn = _modulate(layernorm(x), s1, sc1)
    q = _proj(ctx, xn, p["attn"]["wq"], "attn.q", rclass).reshape(b, t, h, hd)
    k = _proj(ctx, xn, p["attn"]["wk"], "attn.k", rclass).reshape(b, t, h, hd)
    v = _proj(ctx, xn, p["attn"]["wv"], "attn.v", rclass).reshape(b, t, h, hd)
    o = mha_flash(q, k, v, causal=False)
    o = _proj(ctx, o.reshape(b, t, h * hd), p["attn"]["wo"], "attn.o",
              rclass)
    x = x + g1[:, None, :] * o

    if text is not None and "xattn" in p:
        xn = layernorm(x)
        q = _proj(ctx, xn, p["xattn"]["wq"], "xattn.q", rclass
                  ).reshape(b, t, h, hd)
        k = _proj(ctx, text, p["xattn"]["wk"], "xattn.k", rclass
                  ).reshape(b, -1, h, hd)
        v = _proj(ctx, text, p["xattn"]["wv"], "xattn.v", rclass
                  ).reshape(b, -1, h, hd)
        o = full_attention(q, k, v, causal=False)
        x = x + _proj(ctx, o.reshape(b, t, h * hd), p["xattn"]["wo"],
                      "xattn.o", rclass)

    xn = _modulate(layernorm(x), s2, sc2)
    hdn = _proj(ctx, xn, p["mlp_w1"], "mlp.w1", rclass)
    hdn = F.gelu(hdn.float(), approximate="tanh").to(x.dtype)
    x = x + g2[:, None, :] * _proj(ctx, hdn, p["mlp_w2"], "mlp.w2", rclass)
    return x


@dataclasses.dataclass
class DriftState:
    """Checkpoint stores and per-step drift inputs threaded by the sampler.

    ``embed_store`` maps the embedding GEMM names to (rows, N) f32 buffers;
    ``block_store`` maps each block GEMM name to an (L, rows, N) buffer,
    refreshed in place layer by layer. The Fig 6 block-level study's
    gates multiply the BER per site: ``layer_gate[layer]`` for block
    ``layer``, ``embed_gate`` for the embedding GEMMs (f32, as the
    reference multiplies them); None = all on, and no op is added."""
    cfg: DriftSystemConfig
    flip_source: Any
    step: int
    ber_by_class: np.ndarray
    embed_store: Dict[str, torch.Tensor]
    block_store: Dict[str, torch.Tensor]
    have_ckpt: bool = False
    layer_gate: Any = None              # (L,) or None
    embed_gate: Any = None              # scalar or None


def _gated(ber_by_class, gate) -> np.ndarray:
    """The per-class BER scaled by a Fig 6 gate, in f32."""
    return np.asarray(ber_by_class, np.float32) * np.float32(gate)


def forward(cfg: ModelConfig, params: Params, latents: torch.Tensor,
            t: torch.Tensor, cond: Optional[torch.Tensor],
            drift: Optional[DriftState] = None,
            text: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Predict noise. latents: (B, H, W, C); t: (B,); cond: class ids (B,),
    or, for PixArt (``cfg.cond_tokens``), ignored in favour of ``text``
    (B, Tt, cond_dim).

    Returns (eps_pred f32, stats). With ``drift``, stats holds the device
    counts ``corrected_elems``, ``detected_row_errors``, the per-site
    ``detected_per_block`` (row 0 the embedding GEMMs, rows 1..L the
    blocks) and the summed recovery costs ``extra_compute_flops`` and
    ``extra_dram_bytes``; the checkpoint stores are refreshed in place."""
    _check_cfg(cfg)
    b, hh, ww, _ = latents.shape
    stats: Dict[str, torch.Tensor] = {}
    params = dict(params, **constraints.gather(
        {k: v for k, v in params.items() if k != "blocks"}))

    ectx = None
    if drift is not None:
        e_ber = drift.ber_by_class
        if drift.embed_gate is not None:
            e_ber = _gated(e_ber, drift.embed_gate)
        ectx = ExecContext(drift.cfg, flip_source=drift.flip_source,
                           step=drift.step, scope=EMBED_SCOPE,
                           ber_by_class=e_ber,
                           state_in=drift.embed_store,
                           have_ckpt=drift.have_ckpt)

    dt = cfg.dtype
    x = patchify(cfg, latents.to(dt))
    x = _proj(ectx, x, params["patch_w"], "patch", dvfs.CLASS_EMBED)
    x = x + params["patch_b"].to(dt) + params["pos_embed"].to(dt)

    temb = timestep_embedding(t).to(dt)
    temb = _proj(ectx, temb, params["t_w1"], "t.w1", dvfs.CLASS_EMBED)
    temb = F.silu(temb + params["t_b1"].to(dt))
    temb = _proj(ectx, temb, params["t_w2"], "t.w2", dvfs.CLASS_EMBED)
    temb = temb + params["t_b2"].to(dt)
    text_proj = None
    if cfg.cond_tokens:
        text_proj = _proj(ectx, text.to(dt), params["text_proj"], "text",
                          dvfs.CLASS_EMBED)
        c = temb + text_proj.mean(dim=1)
    else:
        c = temb + params["class_embed"].to(dt)[cond]
    c = constraints.gather_rows(c)      # the adaLN GEMMs' rows

    corrected: List[torch.Tensor] = []
    detected: List[torch.Tensor] = []
    ctxs: List[ExecContext] = []
    for i, p_i in enumerate(params["blocks"]):
        p_i = constraints.gather(p_i)
        bctx = None
        if drift is not None:
            rcl = dvfs.CLASS_FIRST_BLOCK if i < 1 else dvfs.CLASS_BODY
            store_i = {k: v[i] for k, v in drift.block_store.items()}
            b_ber = drift.ber_by_class
            if drift.layer_gate is not None:
                b_ber = _gated(b_ber, drift.layer_gate[i])
            bctx = ExecContext(drift.cfg, flip_source=drift.flip_source,
                               step=drift.step, scope=i,
                               ber_by_class=b_ber,
                               state_in=store_i, have_ckpt=drift.have_ckpt)
            x = dit_block(cfg, p_i, x, c, text_proj, ctx=bctx, rclass=rcl)
            ctxs.append(bctx)
            corrected.append(_as_count(bctx.stats["corrected_elems"],
                                       x.device))
            detected.append(_as_count(bctx.stats["detected_row_errors"],
                                      x.device))
        else:
            x = dit_block(cfg, p_i, x, c, text_proj)

    mod = _adaln(c, params["final_adaln_w"], params["final_adaln_b"], x.dtype)
    shift, scale = torch.chunk(mod, 2, dim=-1)
    x = _modulate(layernorm(x), shift, scale)
    x = _proj(ectx, x, params["final_w"], "final", dvfs.CLASS_EMBED)
    x = x + params["final_b"].to(x.dtype)
    eps = unpatchify(cfg, x, hh, ww).float()

    if drift is not None:
        e_det = _as_count(ectx.stats["detected_row_errors"], x.device)
        e_corr = _as_count(ectx.stats["corrected_elems"], x.device)
        per_block = torch.stack([e_det] + detected)
        stats["detected_per_block"] = per_block
        stats["detected_row_errors"] = per_block.sum()
        stats["corrected_elems"] = torch.stack(corrected).sum() + e_corr
        for cost in ("extra_compute_flops", "extra_dram_bytes"):
            stats[cost] = sum((c_.stats[cost] for c_ in ctxs),
                              ectx.stats[cost])
    return eps, stats


def _as_count(v, device) -> torch.Tensor:
    """A context statistic (a Python 0 or a device tensor) as int64."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64)
    return torch.full((), int(v), dtype=torch.int64, device=device)


def drift_store_spec(cfg: ModelConfig, batch: int, device="cpu"
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """(embed_store, block_store) zero checkpoint stores; block-store
    buffers are (L, rows, N)."""
    _check_cfg(cfg)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.hd
    L = cfg.n_layers
    # a sharded batch's GEMMs of ragged tiles hold the whole batch's rows
    bt = constraints.store_rows(batch * cfg.tokens, TILE)
    btext = constraints.store_rows(batch * cfg.cond_tokens, TILE)
    bc = constraints.store_rows(batch, TILE)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    embed = {"patch": z(bt, d), "t.w1": z(bc, d), "t.w2": z(bc, d),
             "final": z(bt, cfg.patch_dim)}
    block = {"attn.q": z(L, bt, hd), "attn.k": z(L, bt, hd),
             "attn.v": z(L, bt, hd), "attn.o": z(L, bt, d),
             "mlp.w1": z(L, bt, f), "mlp.w2": z(L, bt, d)}
    if cfg.cond_tokens:
        embed["text"] = z(btext, d)
        block.update({"xattn.q": z(L, bt, hd), "xattn.k": z(L, btext, hd),
                      "xattn.v": z(L, btext, hd), "xattn.o": z(L, bt, d)})
    return embed, block


def param_count(cfg: ModelConfig) -> int:
    """Analytical parameter count, the reference's formula (which the
    perfmodel also applies to the UNet's config, as the reference does)."""
    d, f = cfg.d_model, cfg.d_ff
    per_block = 6 * d * d + 4 * d * d + 2 * d * f
    if cfg.cond_tokens:
        per_block += 4 * d * d
    t = (cfg.latent_size // cfg.patch_size) ** 2
    pdim = cfg.patch_size ** 2 * cfg.latent_channels
    base = (pdim * d + t * d + 256 * d + d * d + 2 * d * d + d * pdim)
    return cfg.n_layers * per_block + base
