"""Decoder-only LM, dense and MoE families: prefill and token-by-token
decode.

Counterpart of ``repro.models.transformer``, reduced to the dense and MoE
families: olmo-1b; gemma2-9b, gemma3-27b and glm4-9b with GQA, per-layer
sliding windows (``cfg.layer_windows()``), the attention softcap and the
logit softcap; deepseek-moe-16b and kimi-k2 with the MoE FFN
(``models.moe``) in place of the dense MLP. Params are nested dicts like
the reference's, except that ``layers`` is a list with one dict per layer
(the reference stacks them on a leading L axis for ``lax.scan``);
``params_from_jax`` converts.

The reference casts every f32 weight to the activation dtype on every call
(``_proj``), and statistical ABFT sums every weight over its output axis
on every call. ``prepare`` does both once: ``Weights`` holds each
projection as a ``Proj`` (the cast weight and its two per-row sums, from
the same ops on the same cast weight, so bit-identical), the cast
embedding, and the MoE router and experts cast (they are unprotected, so
they carry no sums). ``init_weights`` draws the same weights as
``init_params`` and prepares each one as it is drawn, so serving never
holds the f32 masters: at full width it needs the activation-dtype bytes
alone. The model functions take raw params or ``Weights``.

Prefill self-attention runs the attention kernel (``kernels.
flash_attention.mha_flash``, causal, with the layer's window and the
softcap); decode attention is plain PyTorch
(``models.attention.decode_attention``), as the reference's is an einsum.
The KV cache is written in place (the reference returns a new cache);
``Cache.pos`` is a host int, so a decode step never waits for the card.

SSM, hybrid and VLM layers, the mixed/ring decode, ``DriftDecode`` and
the training ``forward`` are not yet ported (ROADMAP Queue A items 12
and 14).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dvfs
from repro_torch.kernels.flash_attention import mha_flash
from repro_torch.kernels.stat_abft import weight_sums
from repro_torch.models import attention, moe
from repro_torch.models.common import (ModelConfig, Params, activation,
                                       apply_norm, apply_rope, dense_init,
                                       embed_init, norm_params, softcap)

def _check_cfg(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not yet ported to "
            "repro_torch; only the dense and MoE LMs are (ROADMAP Queue A "
            "item 12)")


# ============================================================ parameters
def _identity(w):
    return w


def _draw(cfg: ModelConfig, seed: int, device, proj: Callable,
          plain: Callable) -> Params:
    """Random weights from ``seed`` with the reference's init law:
    truncated-normal projections (std 1/sqrt(d_in)), embedding (std 1) and
    MoE experts (``moe.init_moe_params``), drawn in one order from one
    generator. Each projection is handed to ``proj`` and each other weight
    to ``plain`` as soon as it is drawn."""
    _check_cfg(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    h, hkv, pdt = cfg.n_heads, cfg.kv_heads, cfg.param_dtype

    def dense(a, b):
        return proj(dense_init(a, b, pdt, device, g))

    def layer() -> Params:
        lp: Params = {"ln1": norm_params(cfg, device)}
        lp["attn"] = {"wq": dense(d, h * hd), "wk": dense(d, hkv * hd),
                      "wv": dense(d, hkv * hd), "wo": dense(h * hd, d)}
        lp["ln2"] = norm_params(cfg, device)
        if cfg.family == "moe":
            lp["moe"] = moe.init_moe_params(cfg, g, device, plain)
        else:
            lp["mlp"] = {"w_gate": dense(d, f), "w_up": dense(d, f),
                         "w_down": dense(f, d)}
        return lp

    p: Params = {"embed": plain(embed_init(cfg.vocab, d, pdt, device, g))}
    p["layers"] = [layer() for _ in range(cfg.n_layers)]
    p["final_norm"] = norm_params(cfg, device)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense(d, cfg.vocab)
    return p


def init_params(cfg: ModelConfig, seed: int, device="cpu") -> Params:
    """Random params from ``seed`` in ``cfg.param_dtype`` (``_draw``)."""
    return _draw(cfg, seed, device, _identity, _identity)


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Params:
    """The port's params from the reference's param pytree (leaves as numpy
    arrays or anything ``np.asarray`` takes), unstacking the (L, ...)
    ``layers`` leaves into one dict per layer."""
    def walk(t, i=None):
        if isinstance(t, dict):
            return {k: walk(v, i) for k, v in t.items()}
        a = np.array(t) if i is None else np.array(t[i])
        return torch.from_numpy(a).to(device)

    out = {k: walk(v) for k, v in tree.items() if k != "layers"}
    n_layers = len(tree["layers"]["attn"]["wq"])
    out["layers"] = [walk(tree["layers"], i) for i in range(n_layers)]
    return out


class Proj(NamedTuple):
    """One projection weight as the protected GEMMs use it."""
    w: torch.Tensor          # (K, N) in the activation dtype
    w_sum: torch.Tensor      # (K,) f32: sum over N of w cast to f32
    w_abs_sum: torch.Tensor  # (K,) f32: sum over N of |w| cast to f32


def _proj_of(w: torch.Tensor, dtype: torch.dtype) -> Proj:
    wc = w.to(dtype)
    return Proj(wc, *weight_sums(wc))


def _cast_tree(t, dtype: torch.dtype):
    if isinstance(t, dict):
        return {k: _cast_tree(v, dtype) for k, v in t.items()}
    return t.to(dtype)


@dataclasses.dataclass
class Weights:
    """Params prepared once for serving (see the module docstring)."""
    embed: torch.Tensor                 # (V, d) in the activation dtype
    layers: List[Dict[str, Any]]
    final_norm: Params
    lm_head: Optional[Proj]


def prepare(cfg: ModelConfig, params) -> Weights:
    """Cast every weight to ``cfg.dtype`` once and sum each projection for
    detection; ``Weights`` pass through as they are."""
    if isinstance(params, Weights):
        return params
    _check_cfg(cfg)
    dt = cfg.dtype
    layers = []
    for lp in params["layers"]:
        out = {"ln1": lp["ln1"], "ln2": lp["ln2"],
               "attn": {k: _proj_of(v, dt) for k, v in lp["attn"].items()}}
        if "moe" in lp:
            out["moe"] = _cast_tree(lp["moe"], dt)
        else:
            out["mlp"] = {k: _proj_of(v, dt) for k, v in lp["mlp"].items()}
        layers.append(out)
    head = (None if cfg.tie_embeddings
            else _proj_of(params["lm_head"], dt))
    return Weights(params["embed"].to(dt), layers, params["final_norm"],
                   head)


def init_weights(cfg: ModelConfig, seed: int, device="cpu") -> Weights:
    """``prepare(cfg, init_params(cfg, seed, device))``, bit for bit, with
    no f32 master kept: each weight is drawn as ``init_params`` draws it,
    rounded to ``cfg.param_dtype`` and then to ``cfg.dtype``, and its draw
    freed before the next one."""
    dt = cfg.dtype
    p = _draw(cfg, seed, device, lambda w: _proj_of(w, dt),
              lambda w: w.to(dt))
    return Weights(p["embed"], p["layers"], p["final_norm"],
                   p.get("lm_head"))


# ============================================================== caching
class Cache(NamedTuple):
    k: torch.Tensor     # (L, B, S, Hkv, hd), written in place
    v: torch.Tensor
    pos: int            # next write index (host int)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cpu") -> Cache:
    shape = (cfg.n_layers, batch, max_seq, cfg.kv_heads, cfg.hd)
    return Cache(torch.zeros(shape, dtype=dtype, device=device),
                 torch.zeros(shape, dtype=dtype, device=device), 0)


# ====================================================== layer primitives
def _proj(ctx, x: torch.Tensor, p: Proj, name: str, rclass: int):
    if ctx is None:
        return x @ p.w
    return ctx.matmul(x, p, name=name, rclass=rclass)


def _attn_block(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                window: int, positions: torch.Tensor, mode: str, cache_kv,
                cache_pos: int = 0, ctx=None, rclass: int = dvfs.CLASS_BODY
                ) -> torch.Tensor:
    """Self-attention sub-block, mode 'prefill' or 'decode'; writes this
    layer's K and V into ``cache_kv`` in place. ``window`` is the layer's
    (0: global)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    q = _proj(ctx, x, p["wq"], "attn.q", rclass).reshape(b, s, h, hd)
    k = _proj(ctx, x, p["wk"], "attn.k", rclass).reshape(b, s, hkv, hd)
    v = _proj(ctx, x, p["wv"], "attn.v", rclass).reshape(b, s, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    ck, cv = cache_kv
    if mode == "prefill":
        ck[:, :s] = k.to(ck.dtype)
        cv[:, :s] = v.to(cv.dtype)
        o = mha_flash(q, k, v, causal=True, window=window,
                      softcap=cfg.attn_softcap)
    elif mode == "decode":
        ck[:, cache_pos:cache_pos + 1] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + 1] = v.to(cv.dtype)
        o = attention.decode_attention(q, ck, cv, pos=cache_pos,
                                       window=window,
                                       attn_softcap=cfg.attn_softcap)
    else:
        raise ValueError(f"attention mode {mode!r}; ported: prefill, decode")
    o = o.reshape(b, s, h * hd)
    return _proj(ctx, o, p["wo"], "attn.o", rclass)


def _mlp_block(cfg: ModelConfig, p: Params, x: torch.Tensor, ctx=None,
               rclass: int = dvfs.CLASS_BODY) -> torch.Tensor:
    g = _proj(ctx, x, p["w_gate"], "mlp.gate", rclass)
    u = _proj(ctx, x, p["w_up"], "mlp.up", rclass)
    h = activation(cfg, g.float()).to(x.dtype) * u
    return _proj(ctx, h, p["w_down"], "mlp.down", rclass)


def _layer(cfg: ModelConfig, p: Params, x: torch.Tensor, *, window: int,
           positions: torch.Tensor, mode: str, cache_kv, cache_pos: int = 0,
           ctx=None, rclass: int = dvfs.CLASS_BODY) -> torch.Tensor:
    h_in = apply_norm(cfg, p["ln1"], x)
    x = x + _attn_block(cfg, p["attn"], h_in, window=window,
                        positions=positions, mode=mode, cache_kv=cache_kv,
                        cache_pos=cache_pos, ctx=ctx, rclass=rclass)
    h2 = apply_norm(cfg, p["ln2"], x)
    if cfg.family == "moe":       # unprotected: no ctx, as the reference
        y2, _ = moe.moe_ffn(cfg, p["moe"], h2.reshape(-1, h2.shape[-1]))
        return x + y2.reshape(h2.shape)
    return x + _mlp_block(cfg, p["mlp"], h2, ctx=ctx, rclass=rclass)


def _embed(cfg: ModelConfig, w: Weights, tokens: torch.Tensor
           ) -> torch.Tensor:
    x = w.embed[tokens]
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                            device=x.device)


def _unembed(cfg: ModelConfig, w: Weights, x: torch.Tensor) -> torch.Tensor:
    logits = x @ (w.embed.T if w.lm_head is None else w.lm_head.w)
    return softcap(logits.float(), cfg.logit_softcap)


# ================================================================ serving
def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, max_seq: int
            ) -> Tuple[torch.Tensor, Cache]:
    """Process a prompt (B, S); returns (logits (B, S, V) f32, primed
    cache). Runs clean, with no execution context."""
    w = prepare(cfg, params)
    x = _embed(cfg, w, tokens)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, max_seq, cfg.dtype, x.device)
    positions = torch.arange(s, device=x.device)
    for i, (lp, win) in enumerate(zip(w.layers, cfg.layer_windows())):
        x = _layer(cfg, lp, x, window=win, positions=positions,
                   mode="prefill", cache_kv=(cache.k[i], cache.v[i]))
    x = apply_norm(cfg, w.final_norm, x)
    return _unembed(cfg, w, x), cache._replace(pos=s)


def _decode(cfg: ModelConfig, w: Weights, cache: Cache,
            tokens: torch.Tensor, ctx_factory: Optional[Callable]):
    x = _embed(cfg, w, tokens)
    positions = torch.full((1,), cache.pos, dtype=torch.int64,
                           device=x.device)
    ctxs = []
    for i, (lp, win) in enumerate(zip(w.layers, cfg.layer_windows())):
        ctx = None if ctx_factory is None else ctx_factory(i)
        rclass = dvfs.CLASS_FIRST_BLOCK if i < 1 else dvfs.CLASS_BODY
        x = _layer(cfg, lp, x, window=win, positions=positions,
                   mode="decode",
                   cache_kv=(cache.k[i], cache.v[i]), cache_pos=cache.pos,
                   ctx=ctx, rclass=rclass)
        ctxs.append(ctx)
    x = apply_norm(cfg, w.final_norm, x)
    return _unembed(cfg, w, x), cache._replace(pos=cache.pos + 1), ctxs


def decode_step(cfg: ModelConfig, params, cache: Cache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache, None]:
    """One clean decode step. tokens: (B, 1). Returns (logits, cache,
    None); the DRIFT-protected decode (``DriftDecode``) is not yet
    ported (ROADMAP Queue A item 12)."""
    logits, cache, _ = _decode(cfg, prepare(cfg, params), cache, tokens,
                               None)
    return logits, cache, None


def decode_step_stats(cfg: ModelConfig, params, cache: Cache,
                      tokens: torch.Tensor, ctx_factory: Callable
                      ) -> Tuple[torch.Tensor, Cache, Dict[str, Any]]:
    """One decode step through ``ctx_factory(layer_idx)`` contexts (each
    with ``.matmul(x, proj, name=, rclass=)`` and a ``.stats`` dict);
    returns ``(logits, cache, stats)`` with stats summed over layers."""
    logits, cache, ctxs = _decode(cfg, prepare(cfg, params), cache, tokens,
                                  ctx_factory)
    stats: Dict[str, Any] = {}
    for ctx in ctxs:
        for k, v in ctx.stats.items():
            stats[k] = stats[k] + v if k in stats else v
    return logits, cache, stats


def forward(cfg: ModelConfig, params, tokens: torch.Tensor):
    raise NotImplementedError(
        "the teacher-forcing forward is not yet ported to repro_torch "
        "(ROADMAP Queue A item 14, training)")


def decode_step_mixed(cfg: ModelConfig, params, cache, tokens):
    raise NotImplementedError(
        "the windowed (ring-buffer) decode is not yet ported to repro_torch "
        "(ROADMAP Queue A item 12, local/global families)")


def param_count(cfg: ModelConfig) -> int:
    """Analytical parameter count, the reference's formula for the dense
    and MoE families (its SSM terms wait for the families themselves)."""
    _check_cfg(cfg)
    d, h, hkv, hd, f, v = (cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd,
                           cfg.d_ff, cfg.vocab)
    per_layer = d * h * hd + 2 * d * hkv * hd + h * hd * d
    if cfg.family == "moe":
        per_layer += moe.moe_param_count(cfg)
    else:
        per_layer += 3 * d * f
    n = cfg.n_layers * per_layer + v * d
    if not cfg.tie_embeddings:
        n += v * d
    return n
