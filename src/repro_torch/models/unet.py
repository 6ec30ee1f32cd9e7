"""Conditional latent UNet (the Stable Diffusion v1.5 backbone).

Counterpart of ``repro.models.unet``: ResBlocks (GroupNorm + SiLU + 3x3
conv) with timestep injection, self- and cross-attention at the lower
resolutions, a down and an up path joined by skip connections; widths from
``ModelConfig.unet_channels``. Tensors keep the reference's layouts at the
public functions: activations NHWC, convolution weights HWIO.

The convolutions stay unprotected under DRIFT, as in the reference (it
computes them with ``lax.conv_general_dilated``, outside any kernel): here
``F.conv2d`` on NCHW views of the NHWC activations (channels-last memory,
so no copies) with HWIO weights permuted to OIHW. ``"SAME"`` padding is
written out: a stride-2 3x3 conv on an even size pads (0, 1), not (1, 1).
The timestep MLP (``t_w1``, ``t_w2``) is a plain matmul too. Only the
attention blocks' q/k/v/o projections go through ``ExecContext``, named
``f"{block}.{self|cross}.{q,k,v,o}"`` (``block`` is ``down{i}``, ``mid``
or ``up{i}``), all ``CLASS_BODY``. Self-attention runs through the
attention kernel's wrapper ``kernels.flash_attention.mha_flash``;
cross-attention (``cond_tokens`` text keys against the pixels' queries)
runs the plain ``full_attention``, as the reference does, since neither
kernel takes Sq != Skv.

The sampler gives the UNet one context per evaluation, at one fault scope
(0), with a flat name-keyed checkpoint store (``drift_store_spec``).

On the sharded engine (``distributed.constraints``) the weights rest as
shards, gathered at the top and at each level; the timestep MLP and each
ResBlock's timestep projection (M = batch, float GEMMs whose library
kernel depends on the row count) run on the data group's gathered
timestep rows. Without a mesh policy none of this adds an op.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import dvfs
from repro_torch.core.exec_ctx import ExecContext
from repro_torch.distributed import constraints
from repro_torch.kernels.abft_matmul import TILE
from repro_torch.kernels.flash_attention import mha_flash
from repro_torch.models.attention import full_attention
from repro_torch.models.common import (ModelConfig, Params, dense_init,
                                       trunc_normal)
from repro_torch.models.dit import timestep_embedding

SCOPE = 0   # the one fault scope of a UNet evaluation


def _check_cfg(cfg: ModelConfig) -> None:
    if cfg.family != "unet":
        raise ValueError(f"{cfg.name}: models.unet takes the unet family, "
                         f"got {cfg.family!r}")


# ------------------------------------------------------------------ ops
def _same_pad(size: int, k: int, stride: int):
    """XLA's "SAME": (low, high) padding of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC ``x`` through an HWIO ``w`` with "SAME" padding."""
    kh, kw = w.shape[0], w.shape[1]
    ph = _same_pad(x.shape[1], kh, stride)
    pw = _same_pad(x.shape[2], kw, stride)
    xc = x.permute(0, 3, 1, 2)                     # NCHW view, no copy
    if any(ph + pw):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int = 32) -> torch.Tensor:
    """GroupNorm over NHWC in f32, cast back to ``x.dtype``. The population
    variance is taken in two passes, ``mean((x - mu)^2)``, as ``jnp.var``
    takes it, so values past f32's range overflow to the same inf and
    NaN as the reference's (a faulty run reaches them)."""
    b, h, w, c = x.shape
    g = min(groups, c)
    xf = x.float().reshape(b, h, w, g, c // g)
    mu = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=(1, 2, 4), keepdim=True)
    xf = ((xf - mu) * torch.rsqrt(var + 1e-5)).reshape(b, h, w, c)
    return (xf * scale.float() + bias.float()).to(x.dtype)


def _silu_f32(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.float()).to(x.dtype)


# --------------------------------------------------------------- params
def init_params(cfg: ModelConfig, seed: int, device="cpu") -> Params:
    """Random params from ``seed`` with the reference's init law:
    truncated-normal convs (std fan_in^-1/2) and projections, GroupNorm
    scales 1, and a zero ``conv_out`` (a fresh model predicts eps = 0)."""
    _check_cfg(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    pdt = cfg.param_dtype
    chans = cfg.unet_channels
    d = cfg.d_model

    def dense(a, b):
        return dense_init(a, b, pdt, device, g)

    def conv(kh, kw, cin, cout):
        return trunc_normal((kh, kw, cin, cout), (kh * kw * cin) ** -0.5,
                            pdt, device, g)

    def ones(n):
        return torch.ones((n,), dtype=pdt, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=pdt, device=device)

    def res(cin, cout):
        return {"gn1_s": ones(cin), "gn1_b": zeros(cin),
                "conv1": conv(3, 3, cin, cout), "temb_w": dense(d, cout),
                "gn2_s": ones(cout), "gn2_b": zeros(cout),
                "conv2": conv(3, 3, cout, cout),
                "skip": conv(1, 1, cin, cout) if cin != cout else None}

    def attn(ch):
        return {"gn_s": ones(ch), "gn_b": zeros(ch),
                "self": {"wq": dense(ch, ch), "wk": dense(ch, ch),
                         "wv": dense(ch, ch), "wo": dense(ch, ch)},
                "cross": {"wq": dense(ch, ch), "wk": dense(cfg.cond_dim, ch),
                          "wv": dense(cfg.cond_dim, ch),
                          "wo": dense(ch, ch)}}

    p: Params = {
        "t_w1": dense(256, d), "t_w2": dense(d, d),
        "conv_in": conv(3, 3, cfg.latent_channels, chans[0]),
        "down": [], "mid": {}, "up": [],
        "gn_out_s": ones(chans[0]), "gn_out_b": zeros(chans[0]),
        "conv_out": torch.zeros((3, 3, chans[0], cfg.latent_channels),
                                dtype=pdt, device=device),
    }
    cin = chans[0]
    last = len(chans) - 1
    for li, ch in enumerate(chans):
        p["down"].append({"res1": res(cin, ch), "res2": res(ch, ch),
                          "attn": attn(ch) if li >= 1 else None,
                          "down": conv(3, 3, ch, ch) if li < last else None})
        cin = ch
    p["mid"] = {"res1": res(cin, cin), "attn": attn(cin),
                "res2": res(cin, cin)}
    for li, ch in enumerate(reversed(chans)):
        p["up"].append({"res1": res(cin + ch, ch), "res2": res(ch, ch),
                        "attn": attn(ch) if li < last else None,
                        "up": conv(3, 3, ch, ch) if li < last else None})
        cin = ch
    return p


def params_from_jax(tree: Any, device="cpu") -> Params:
    """The port's params from the reference's param pytree (leaves as numpy
    arrays or anything ``np.asarray`` takes); the same nesting of dicts and
    lists, ``None`` kept where a level has no attention, skip or resample
    conv."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


# --------------------------------------------------------------- blocks
def _res_block(p: Params, x: torch.Tensor, temb: torch.Tensor
               ) -> torch.Tensor:
    """``temb`` holds the data group's rows (the batch's own without a
    sharded batch); the projection keeps this rank's."""
    h = _silu_f32(group_norm(x, p["gn1_s"], p["gn1_b"]))
    h = _conv(h, p["conv1"])
    proj = _silu_f32(temb).to(x.dtype) @ p["temb_w"].to(x.dtype)
    h = h + constraints.own_rows(proj)[:, None, None, :]
    h = _silu_f32(group_norm(h, p["gn2_s"], p["gn2_b"]))
    h = _conv(h, p["conv2"])
    skip = x if p["skip"] is None else _conv(x, p["skip"])
    return skip + h


def _proj(ctx: Optional[ExecContext], x, w, name):
    if ctx is None:
        return x @ w.to(x.dtype)
    lead = x.shape[:-1]
    y = ctx.matmul(x.reshape(-1, x.shape[-1]), w.to(x.dtype), name=name,
                   rclass=dvfs.CLASS_BODY)
    return y.reshape(*lead, -1)


def _attn_block(p: Params, x: torch.Tensor, text: Optional[torch.Tensor],
                ctx: Optional[ExecContext], name: str) -> torch.Tensor:
    b, hh, ww, c = x.shape
    heads = max(c // 64, 1)
    hd = c // heads
    xn = group_norm(x, p["gn_s"], p["gn_b"]).reshape(b, hh * ww, c)

    def mha(pp, q_src, kv_src, tag, attend):
        q = _proj(ctx, q_src, pp["wq"], f"{name}.{tag}.q"
                  ).reshape(b, -1, heads, hd)
        k = _proj(ctx, kv_src, pp["wk"], f"{name}.{tag}.k"
                  ).reshape(b, -1, heads, hd)
        v = _proj(ctx, kv_src, pp["wv"], f"{name}.{tag}.v"
                  ).reshape(b, -1, heads, hd)
        o = attend(q, k, v, causal=False)
        return _proj(ctx, o.reshape(b, -1, heads * hd), pp["wo"],
                     f"{name}.{tag}.o")

    y = xn + mha(p["self"], xn, xn, "self", mha_flash)
    if text is not None:
        y = y + mha(p["cross"], y, text.to(x.dtype), "cross",
                    full_attention)
    return x + y.reshape(b, hh, ww, c)


def attention_sites(cfg: ModelConfig):
    """(name, resolution, channels) of each attention block, in the order
    ``forward`` runs them: ``down{i}`` for levels i >= 1, ``mid``, and
    ``up{i}`` for all up levels but the last."""
    chans = cfg.unet_channels
    last = len(chans) - 1
    s = cfg.latent_size
    sites = [(f"down{i}", s >> i, ch) for i, ch in enumerate(chans)
             if i >= 1]
    sites.append(("mid", s >> last, chans[-1]))
    sites += [(f"up{i}", s >> (last - i), ch)
              for i, ch in enumerate(reversed(chans)) if i < last]
    return sites


def forward(cfg: ModelConfig, params: Params, latents: torch.Tensor,
            t: torch.Tensor, text: Optional[torch.Tensor],
            ctx: Optional[ExecContext] = None) -> torch.Tensor:
    """Predict noise. latents (B, H, W, C); t (B,); text (B, Tt, cond_dim).
    Returns eps in f32; with ``ctx`` its stats hold the evaluation's
    counts and its store the refreshed checkpoints."""
    _check_cfg(cfg)
    dt = cfg.dtype
    levels = ("down", "mid", "up")
    params = dict(params, **constraints.gather(
        {k: v for k, v in params.items() if k not in levels}))
    x = latents.to(dt)
    temb = timestep_embedding(constraints.gather_rows(t)).to(dt)
    temb = _silu_f32(temb @ params["t_w1"].to(dt))
    temb = temb @ params["t_w2"].to(dt)

    x = _conv(x, params["conv_in"])
    skips: List[torch.Tensor] = []
    for li, lvl in enumerate(params["down"]):
        lvl = constraints.gather(lvl)
        x = _res_block(lvl["res1"], x, temb)
        x = _res_block(lvl["res2"], x, temb)
        if lvl["attn"] is not None:
            x = _attn_block(lvl["attn"], x, text, ctx, f"down{li}")
        skips.append(x)
        if lvl["down"] is not None:
            x = _conv(x, lvl["down"], stride=2)
    mid = constraints.gather(params["mid"])
    x = _res_block(mid["res1"], x, temb)
    x = _attn_block(mid["attn"], x, text, ctx, "mid")
    x = _res_block(mid["res2"], x, temb)
    for li, lvl in enumerate(params["up"]):
        lvl = constraints.gather(lvl)
        x = torch.cat([x, skips[-(li + 1)]], dim=-1)
        x = _res_block(lvl["res1"], x, temb)
        x = _res_block(lvl["res2"], x, temb)
        if lvl["attn"] is not None:
            x = _attn_block(lvl["attn"], x, text, ctx, f"up{li}")
        if lvl["up"] is not None:
            # jax.image.resize(..., "nearest") at 2x repeats each pixel
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            x = _conv(x, lvl["up"])
    x = _silu_f32(group_norm(x, params["gn_out_s"], params["gn_out_b"]))
    return _conv(x, params["conv_out"]).float()


def drift_store_spec(cfg: ModelConfig, batch: int, device="cpu"
                     ) -> Dict[str, torch.Tensor]:
    """The flat zero checkpoint store of one UNet evaluation: one (rows, N)
    f32 buffer per protected GEMM, as the reference derives it with
    ``eval_shape``."""
    _check_cfg(cfg)
    store = {}
    for name, res, ch in attention_sites(cfg):
        # a sharded batch's GEMMs of ragged tiles hold the whole batch's
        px = constraints.store_rows(batch * res * res, TILE)
        txt = constraints.store_rows(batch * cfg.cond_tokens, TILE)
        for tag, kv_rows in (("self", px), ("cross", txt)):
            for proj, rows in (("q", px), ("k", kv_rows), ("v", kv_rows),
                               ("o", px)):
                store[f"{name}.{tag}.{proj}"] = torch.zeros(
                    (rows, ch), dtype=torch.float32, device=device)
    return store


def protected_gemms(cfg: ModelConfig) -> int:
    """Protected GEMMs per evaluation: 8 per attention block."""
    return 8 * len(attention_sites(cfg))
