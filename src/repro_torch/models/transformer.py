"""Decoder-only LM, dense, MoE, SSM, hybrid and VLM families: the
teacher-forcing forward, prefill and token-by-token decode.

Counterpart of ``repro.models.transformer``: olmo-1b; gemma2-9b,
gemma3-27b and glm4-9b with GQA, per-layer sliding windows
(``cfg.layer_windows()``), the attention softcap and the logit softcap;
deepseek-moe-16b and kimi-k2 with the MoE FFN (``models.moe``) in place of
the dense MLP; mamba2-370m, whose layers are SSD blocks alone
(``models.mamba2``), and hymba-1.5b, whose layers run attention and an SSD
block side by side and mix their normalized outputs; internvl2-76b, a
dense backbone with an untied ``lm_head`` whose stream starts with
``vis_embeds``, the stub patch embeddings. Params are nested dicts like
the reference's, except that ``layers`` is a list with one dict per layer
(the reference stacks them on a leading L axis for ``lax.scan``);
``params_from_jax`` converts.

The reference casts every f32 weight to the activation dtype on every call
(``_proj``), and statistical ABFT sums every weight over its output axis
on every call. ``prepare`` does both once for serving: ``Weights`` holds
each projection as a ``Proj`` (the cast weight and its two per-row sums,
from the same ops on the same cast weight, so bit-identical), the cast
embedding, and the MoE router and experts and the SSD blocks' ``in_proj``
and ``out_proj`` cast (they are unprotected, so they carry no sums). The
SSD blocks' small leaves (``A_log``, ``D``, ``dt_bias``, the conv weight
and bias, the norm scale) keep their dtype: the reference reads the conv
weight and norm scale in f32 from its f32 masters. ``init_weights`` draws
the same weights as ``init_params`` and prepares each one as it is drawn,
so serving never holds the f32 masters: at full width it needs the
activation-dtype bytes alone. ``prefill`` and the decode steps take raw
params or ``Weights``.

``forward``, the training pass, takes the raw f32 params only and casts
each weight where it is used, as the reference does, so autograd carries
every gradient to the f32 master (a ``Weights`` copy would stop it at
the cast; training needs no weight sums).

Self-attention over a whole sequence (``forward`` and prefill) runs the
attention kernel (``kernels.flash_attention.mha_flash``, causal, with the
layer's window and the softcap), which autograd differentiates through
the plain version; decode attention is plain PyTorch
(``models.attention.decode_attention``), as the reference's is an einsum.
On the CPU it is the reference's ``attention_any``, which chunks past
4096 tokens. The KV cache is written in place (the reference returns a
new cache); the SSM state is not: each step returns new ``SsmState``
tensors, as the reference does. ``Cache.pos`` is a host int, so a decode
step never waits for the card.

``decode_step(..., drift=DriftDecode(...))`` runs every protected
projection of each layer through a fresh ``ExecContext`` (the ABFT and
rollback kernels in ``drift`` mode) with that layer's slice of a stacked
``(L, B, n_out)`` checkpoint store (``drift_store_spec``), refreshed in
place. ``decode_step_mixed`` is the reference's windowed decode for the
local/global families: local layers keep a window-sized ring buffer
(``MixedCache``, ``decode_attention_ring``), global layers the full
cache; its projections are plain float matmuls, unprotected, as in the
reference.

On the sharded engine the prepared weights rest as shards
(``distributed.sharding.shard_tree``); the serving paths gather the
embedding, final norm and head once per call and each layer's weights at
its boundary (``distributed.constraints.gather``), a no-op without a
mesh policy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dvfs
from repro_torch.core.exec_ctx import DriftSystemConfig, ExecContext
from repro_torch.distributed import constraints
from repro_torch.kernels.flash_attention import mha_flash
from repro_torch.kernels.stat_abft import weight_sums
from repro_torch.models import attention, mamba2, moe
from repro_torch.models.common import (ModelConfig, Params, activation,
                                       apply_norm, apply_rope, dense_init,
                                       embed_init, norm_params, rmsnorm,
                                       softcap)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def _check_cfg(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: models.transformer takes the "
                         f"{', '.join(FAMILIES)} families, got "
                         f"{cfg.family!r}")


# ============================================================ parameters
def _identity(w):
    return w


def _draw(cfg: ModelConfig, seed: int, device, proj: Callable,
          plain: Callable) -> Params:
    """Random weights from ``seed`` with the reference's init law:
    truncated-normal projections (std 1/sqrt(d_in)), embedding (std 1),
    MoE experts (``moe.init_moe_params``) and SSD blocks
    (``mamba2.init_ssm_params``), drawn in one order from one generator.
    Each protected projection is handed to ``proj`` and each other cast
    weight (embedding, experts, SSD projections) to ``plain`` as soon as
    it is drawn; norm scales and the SSD blocks' small leaves are kept as
    drawn."""
    _check_cfg(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    h, hkv, pdt = cfg.n_heads, cfg.kv_heads, cfg.param_dtype

    def dense(a, b):
        return proj(dense_init(a, b, pdt, device, g))

    def layer() -> Params:
        lp: Params = {"ln1": norm_params(cfg, device)}
        if cfg.family == "ssm":
            lp["ssm"] = mamba2.init_ssm_params(cfg, g, device, plain)
            return lp
        lp["attn"] = {"wq": dense(d, h * hd), "wk": dense(d, hkv * hd),
                      "wv": dense(d, hkv * hd), "wo": dense(h * hd, d)}
        lp["ln2"] = norm_params(cfg, device)
        if cfg.family == "moe":
            lp["moe"] = moe.init_moe_params(cfg, g, device, plain)
        else:
            lp["mlp"] = {"w_gate": dense(d, f), "w_up": dense(d, f),
                         "w_down": dense(f, d)}
        if cfg.family == "hybrid":
            lp["ssm"] = mamba2.init_ssm_params(cfg, g, device, plain)
            lp["mix_attn"] = torch.ones((), dtype=torch.float32,
                                        device=device)
            lp["mix_ssm"] = torch.ones((), dtype=torch.float32,
                                       device=device)
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

    def first_leaf(t):
        while isinstance(t, dict):
            t = next(v for v in t.values() if not isinstance(v, dict) or v)
        return t

    out = {k: walk(v) for k, v in tree.items() if k != "layers"}
    n_layers = len(first_leaf(tree["layers"]))
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


#: the SSD block's GEMM weights, cast once by ``prepare``; its other
#: leaves keep their dtype (see the module docstring).
SSM_PROJ = ("in_proj", "out_proj")


def _prepare_ssm(p: Params, dtype: torch.dtype) -> Params:
    return {k: v.to(dtype) if k in SSM_PROJ else v for k, v in p.items()}


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
        out = {"ln1": lp["ln1"]}
        if "attn" in lp:
            out["ln2"] = lp["ln2"]
            out["attn"] = {k: _proj_of(v, dt)
                           for k, v in lp["attn"].items()}
        if "moe" in lp:
            out["moe"] = _cast_tree(lp["moe"], dt)
        elif "mlp" in lp:
            out["mlp"] = {k: _proj_of(v, dt) for k, v in lp["mlp"].items()}
        if "ssm" in lp:
            out["ssm"] = _prepare_ssm(lp["ssm"], dt)
        for k in ("mix_attn", "mix_ssm"):
            if k in lp:
                out[k] = lp[k]
        layers.append(out)
    head = (None if cfg.tie_embeddings
            else _proj_of(params["lm_head"], dt))
    return Weights(params["embed"].to(dt), layers, params["final_norm"],
                   head)


def _gathered(w: Weights) -> Weights:
    """``w`` with its top-level shards gathered (the layers' are
    gathered at each layer); ``w`` itself without a mesh policy."""
    if constraints.get_policy() is None:
        return w
    return Weights(constraints.gather(w.embed), w.layers,
                   constraints.gather(w.final_norm),
                   constraints.gather(w.lm_head))


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
    k: Optional[torch.Tensor]   # (L, B, S, Hkv, hd), written in place;
    v: Optional[torch.Tensor]   # None for the SSM family
    ssm: Optional[Tuple[mamba2.SsmState, ...]]   # one per layer, replaced
    pos: int                    # next write index (host int)


def _has_ssm(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


def _kv_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
              device) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    if cfg.family == "ssm":
        return None, None
    shape = (cfg.n_layers, batch, max_seq, cfg.kv_heads, cfg.hd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cpu") -> Cache:
    k, v = _kv_cache(cfg, batch, max_seq, dtype, device)
    ssm = None
    if _has_ssm(cfg):
        ssm = tuple(mamba2.init_ssm_state(cfg, batch, dtype, device)
                    for _ in range(cfg.n_layers))
    return Cache(k, v, ssm, 0)


def _layer_kv(cache: Cache, i: int):
    return None if cache.k is None else (cache.k[i], cache.v[i])


def _layer_ssm(cache: Cache, i: int) -> Optional[mamba2.SsmState]:
    return None if cache.ssm is None else cache.ssm[i]


# ====================================================== layer primitives
def _proj(ctx, x: torch.Tensor, p, name: str, rclass: int):
    """``p`` is a ``Proj`` or, in ``forward``, the raw master weight, cast
    here as the reference casts it."""
    if ctx is None:
        return x @ (p.w if isinstance(p, Proj) else p.to(x.dtype))
    if isinstance(ctx, ExecContext):    # DriftDecode: the cast weight
        p = p.w if isinstance(p, Proj) else p.to(x.dtype)
    return ctx.matmul(x, p, name=name, rclass=rclass)


def _attn_block(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                window: int, positions: torch.Tensor, mode: str, cache_kv,
                cache_pos: int = 0, ctx=None, rclass: int = dvfs.CLASS_BODY
                ) -> torch.Tensor:
    """Self-attention sub-block, mode 'full' (no cache), 'prefill' or
    'decode'; the last two write this layer's K and V into ``cache_kv`` in
    place. ``window`` is the layer's (0: global)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    q = _proj(ctx, x, p["wq"], "attn.q", rclass).reshape(b, s, h, hd)
    k = _proj(ctx, x, p["wk"], "attn.k", rclass).reshape(b, s, hkv, hd)
    v = _proj(ctx, x, p["wv"], "attn.v", rclass).reshape(b, s, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if mode in ("full", "prefill"):
        if mode == "prefill":
            ck, cv = cache_kv
            ck[:, :s] = k.to(ck.dtype)
            cv[:, :s] = v.to(cv.dtype)
        if q.device.type == "cpu":    # chunked past 4096 tokens
            o = attention.attention_any(q, k, v, causal=True, window=window,
                                        attn_softcap=cfg.attn_softcap)
        else:
            o = mha_flash(q, k, v, causal=True, window=window,
                          softcap=cfg.attn_softcap)
    elif mode == "decode":
        ck, cv = cache_kv
        ck[:, cache_pos:cache_pos + 1] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + 1] = v.to(cv.dtype)
        o = attention.decode_attention(q, ck, cv, pos=cache_pos,
                                       window=window,
                                       attn_softcap=cfg.attn_softcap)
    else:
        raise ValueError(f"attention mode {mode!r}")
    o = o.reshape(b, s, h * hd)
    return _proj(ctx, o, p["wo"], "attn.o", rclass)


def _mlp_block(cfg: ModelConfig, p: Params, x: torch.Tensor, ctx=None,
               rclass: int = dvfs.CLASS_BODY) -> torch.Tensor:
    g = _proj(ctx, x, p["w_gate"], "mlp.gate", rclass)
    u = _proj(ctx, x, p["w_up"], "mlp.up", rclass)
    h = activation(cfg, g.float()).to(x.dtype) * u
    return _proj(ctx, h, p["w_down"], "mlp.down", rclass)


def _ssd(cfg: ModelConfig, p: Params, h_in: torch.Tensor, mode: str,
         ssm_state: Optional[mamba2.SsmState]):
    """The SSD block (unprotected: no ctx, as the reference): the whole
    sequence from a zero state in 'full' and 'prefill', one recurrence
    step in decode. Returns its output and the new state (None in
    'full')."""
    if mode == "decode":
        return mamba2.ssd_decode_step(cfg, p, h_in, ssm_state)
    return mamba2.ssd_forward(cfg, p, h_in, return_state=mode == "prefill")


def _layer(cfg: ModelConfig, p: Params, x: torch.Tensor, *, window: int,
           positions: torch.Tensor, mode: str, cache_kv, cache_pos: int = 0,
           ssm_state: Optional[mamba2.SsmState] = None, ctx=None,
           rclass: int = dvfs.CLASS_BODY
           ) -> Tuple[torch.Tensor, Optional[mamba2.SsmState],
                      Optional[torch.Tensor]]:
    """One dense, MoE, SSM, hybrid or VLM layer; returns (x, new SSM state
    or None, the MoE aux loss or None)."""
    h_in = apply_norm(cfg, p["ln1"], x)
    if cfg.family == "ssm":
        y, new_ssm = _ssd(cfg, p["ssm"], h_in, mode, ssm_state)
        return x + y, new_ssm, None
    attn_out = _attn_block(cfg, p["attn"], h_in, window=window,
                           positions=positions, mode=mode, cache_kv=cache_kv,
                           cache_pos=cache_pos, ctx=ctx, rclass=rclass)
    new_ssm = None
    if cfg.family == "hybrid":
        ssm_out, new_ssm = _ssd(cfg, p["ssm"], h_in, mode, ssm_state)
        # hymba: the mean of the per-branch normalized outputs, scaled
        attn_n = rmsnorm(attn_out, None) * p["mix_attn"].to(x.dtype)
        ssm_n = rmsnorm(ssm_out, None) * p["mix_ssm"].to(x.dtype)
        x = x + 0.5 * (attn_n + ssm_n)
    else:
        x = x + attn_out
    h2 = apply_norm(cfg, p["ln2"], x)
    if cfg.family == "moe":       # unprotected: no ctx, as the reference
        y2, aux = moe.moe_layer(cfg, p["moe"],
                                h2.reshape(-1, h2.shape[-1]))
        return x + y2.reshape(h2.shape), new_ssm, aux
    return (x + _mlp_block(cfg, p["mlp"], h2, ctx=ctx, rclass=rclass),
            new_ssm, None)


def _embed(cfg: ModelConfig, w: Weights, tokens: torch.Tensor,
           vis_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The scaled token embeddings (the gathered rows cast, as the
    reference casts the table and gathers), after the ``vis_embeds``
    prefix (B, vis_tokens, d) when one is given."""
    x = w.embed[tokens].to(cfg.dtype)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                         device=x.device)
    if vis_embeds is not None:
        x = torch.cat([vis_embeds.to(cfg.dtype), x], dim=1)
    return x


def _unembed(cfg: ModelConfig, w: Weights, x: torch.Tensor) -> torch.Tensor:
    if w.lm_head is None:
        head = w.embed.T
    else:
        head = w.lm_head.w if isinstance(w.lm_head, Proj) else w.lm_head
    logits = x @ head.to(x.dtype)
    return softcap(logits.float(), cfg.logit_softcap)


# ================================================================ serving
def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, max_seq: int,
            vis_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Process a prompt (B, S), after the ``vis_embeds`` prefix for the
    VLM; returns (logits (B, S, V) f32, primed cache). Runs clean, with
    no execution context."""
    w = _gathered(prepare(cfg, params))
    x = _embed(cfg, w, tokens, vis_embeds)
    b, s, _ = x.shape
    # the SSD blocks start from a zero state: no SSM state to allocate
    cache = Cache(*_kv_cache(cfg, b, max_seq, cfg.dtype, x.device), None, 0)
    positions = torch.arange(s, device=x.device)
    states = []
    for i, (lp, win) in enumerate(zip(w.layers, cfg.layer_windows())):
        x, st, _ = _layer(cfg, constraints.gather(lp), x, window=win,
                          positions=positions, mode="prefill",
                          cache_kv=_layer_kv(cache, i))
        states.append(st)
    x = apply_norm(cfg, w.final_norm, x)
    ssm = tuple(states) if _has_ssm(cfg) else None
    return _unembed(cfg, w, x), cache._replace(ssm=ssm, pos=s)


def _decode(cfg: ModelConfig, w: Weights, cache: Cache,
            tokens: torch.Tensor, ctx_factory: Optional[Callable]):
    w = _gathered(w)
    x = _embed(cfg, w, tokens)
    positions = torch.full((1,), cache.pos, dtype=torch.int64,
                           device=x.device)
    ctxs, states = [], []
    for i, (lp, win) in enumerate(zip(w.layers, cfg.layer_windows())):
        ctx = None if ctx_factory is None else ctx_factory(i)
        rclass = dvfs.CLASS_FIRST_BLOCK if i < 1 else dvfs.CLASS_BODY
        x, st, _ = _layer(cfg, constraints.gather(lp), x, window=win,
                          positions=positions, mode="decode",
                          cache_kv=_layer_kv(cache, i),
                          cache_pos=cache.pos,
                          ssm_state=_layer_ssm(cache, i), ctx=ctx,
                          rclass=rclass)
        ctxs.append(ctx)
        states.append(st)
    x = apply_norm(cfg, w.final_norm, x)
    ssm = tuple(states) if _has_ssm(cfg) else None
    return (_unembed(cfg, w, x),
            cache._replace(ssm=ssm, pos=cache.pos + 1), ctxs)


@dataclasses.dataclass(frozen=True)
class DriftDecode:
    """The inputs of one DRIFT-protected decode step.

    In place of the reference's JAX key it carries a flip source (as
    ``serving.ar`` builds one); each layer's context draws at scope = the
    layer index, as the reference folds ``layer_idx`` into its key.
    ``store`` is the stacked ``(L, B, n_out)`` f32 checkpoint store
    (``drift_store_spec``), refreshed in place."""
    cfg: DriftSystemConfig
    flip_source: Any
    ber_by_class: np.ndarray       # (N_CLASSES,)
    store: Dict[str, torch.Tensor]
    step: int                      # decode step (refresh and have_ckpt)


def _drift_ctx_factory(drift: DriftDecode) -> Callable:
    def make(i: int) -> ExecContext:
        return ExecContext(drift.cfg, flip_source=drift.flip_source,
                           step=drift.step, scope=i,
                           ber_by_class=drift.ber_by_class,
                           state_in={k: v[i] for k, v in drift.store.items()},
                           have_ckpt=drift.step > 0)
    return make


def decode_step(cfg: ModelConfig, params, cache: Cache,
                tokens: torch.Tensor, drift: Optional[DriftDecode] = None
                ) -> Tuple[torch.Tensor, Cache,
                           Optional[Dict[str, torch.Tensor]]]:
    """One decode step. tokens: (B, 1). Returns (logits, cache, store):
    store is None without ``drift``; with it, the checkpoint store the
    layers' contexts refreshed (``drift.store`` itself, written in
    place; empty for the SSM family, whose layers run no protected GEMM,
    as the reference's stacked ``state_out`` is)."""
    factory = None if drift is None else _drift_ctx_factory(drift)
    logits, cache, _ = _decode(cfg, prepare(cfg, params), cache, tokens,
                               factory)
    if drift is None:
        return logits, cache, None
    return logits, cache, ({} if cfg.family == "ssm" else drift.store)


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


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            vis_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training (teacher-forcing) pass over tokens (B, S), after the
    ``vis_embeds`` prefix for the VLM: causal self-attention over the
    whole stream with no cache. Takes the raw params (see the module
    docstring). Returns (logits (B, S', V) f32, the f32 aux loss: the mean
    over layers of the MoE load-balance loss, 0 for the other families)."""
    if isinstance(params, Weights):
        raise TypeError("forward takes the raw params, not Weights: "
                        "gradients must reach the f32 masters")
    _check_cfg(cfg)
    # the raw params in ``Weights``' places, nothing cast or summed
    w = Weights(params["embed"], params["layers"], params["final_norm"],
                params.get("lm_head"))
    x = _embed(cfg, w, tokens, vis_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    auxs = []
    for lp, win in zip(w.layers, cfg.layer_windows()):
        x, _, aux = _layer(cfg, lp, x, window=win, positions=positions,
                           mode="full", cache_kv=None)
        auxs.append(torch.zeros((), device=x.device) if aux is None
                    else aux)
    x = apply_norm(cfg, w.final_norm, x)
    return _unembed(cfg, w, x), torch.stack(auxs).mean()


# ================================================== windowed decode
class MixedCache(NamedTuple):
    """The windowed decode's cache: local layers' ring buffers and global
    layers' full caches, each written in place."""
    k_local: torch.Tensor    # (n_local, B, W, Hkv, hd)
    v_local: torch.Tensor
    k_global: torch.Tensor   # (n_global, B, S, Hkv, hd)
    v_global: torch.Tensor
    pos: int                 # next write position (host int)


def mixed_layout(cfg: ModelConfig):
    """(cycle kinds, n_cycles, tail kinds, local layer indices, global
    layer indices), as the reference's."""
    kinds = cfg.layer_kinds()
    cycle = len(cfg.attn_pattern)
    n_cycles = cfg.n_layers // cycle
    tail = kinds[n_cycles * cycle:]
    local_idx = [i for i, k in enumerate(kinds) if k == "local"]
    global_idx = [i for i, k in enumerate(kinds) if k == "global"]
    return (cfg.attn_pattern, n_cycles, tail, local_idx, global_idx)


def supports_mixed_decode(cfg: ModelConfig) -> bool:
    kinds = cfg.layer_kinds()
    return (cfg.family == "dense" and "local" in kinds and cfg.window > 0
            and not cfg.global_layer_indices)


def init_mixed_cache(cfg: ModelConfig, batch: int, max_seq: int,
                     dtype=torch.bfloat16, device="cpu") -> MixedCache:
    _, _, _, local_idx, global_idx = mixed_layout(cfg)
    shape_l = (len(local_idx), batch, cfg.window, cfg.kv_heads, cfg.hd)
    shape_g = (len(global_idx), batch, max_seq, cfg.kv_heads, cfg.hd)

    def z(shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return MixedCache(z(shape_l), z(shape_l), z(shape_g), z(shape_g), 0)


def mixed_from_full(cfg: ModelConfig, cache: Cache) -> MixedCache:
    """A full prefill cache in the windowed layout: position ``p`` lands
    in ring slot ``p % W`` (the last W positions before ``cache.pos``,
    clipped to the cache, rolled into place)."""
    _, _, _, local_idx, global_idx = mixed_layout(cfg)
    w, pos, s = cfg.window, cache.pos, cache.k.shape[2]
    start = min(max(pos - w, 0), s - w)

    def ring(full):   # (B, S, Hkv, hd) -> (B, W, Hkv, hd)
        # entry i holds position start + i -> slot (start + i) % W
        return torch.roll(full[:, start:start + w], start % w, dims=1)

    def stack(src, idx, fn):
        if not idx:
            return src.new_zeros((0,))
        return torch.stack([fn(src[i]) for i in idx])
    return MixedCache(stack(cache.k, local_idx, ring),
                      stack(cache.v, local_idx, ring),
                      stack(cache.k, global_idx, lambda t: t),
                      stack(cache.v, global_idx, lambda t: t), pos)


def _mixed_layer(cfg: ModelConfig, p, x: torch.Tensor, *, kind: str,
                 positions: torch.Tensor, pos: int, kv) -> torch.Tensor:
    """One decode layer of a static local/global kind: plain float
    projections (no ``ctx``, as the reference), K and V written into the
    ring slot ``pos % W`` (local) or slot ``pos`` (global) in place."""
    h_in = apply_norm(cfg, p["ln1"], x)
    b, s, _ = x.shape
    hh, hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    ap = p["attn"]
    q = _proj(None, h_in, ap["wq"], "attn.q", 0).reshape(b, s, hh, hd)
    k = _proj(None, h_in, ap["wk"], "attn.k", 0).reshape(b, s, hkv, hd)
    v = _proj(None, h_in, ap["wv"], "attn.v", 0).reshape(b, s, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    ck, cv = kv
    slot = pos % cfg.window if kind == "local" else pos
    ck[:, slot:slot + 1] = k.to(ck.dtype)
    cv[:, slot:slot + 1] = v.to(cv.dtype)
    if kind == "local":
        o = attention.decode_attention_ring(q, ck, cv, pos=pos,
                                            attn_softcap=cfg.attn_softcap)
    else:
        o = attention.decode_attention(q, ck, cv, pos=pos, window=0,
                                       attn_softcap=cfg.attn_softcap)
    x = x + _proj(None, o.reshape(b, s, hh * hd), ap["wo"], "attn.o", 0)
    h2 = apply_norm(cfg, p["ln2"], x)
    return x + _mlp_block(cfg, p["mlp"], h2)


def decode_step_mixed(cfg: ModelConfig, params, cache: MixedCache,
                      tokens: torch.Tensor
                      ) -> Tuple[torch.Tensor, MixedCache]:
    """Windowed decode: ring buffers for the local layers. The reference
    scans one pattern cycle per step and unrolls the leftover tail (62 =
    10 x 6 + 2 layers for gemma3-27b); the port loops over the layers in
    order, each with its static kind and the cache it reads (the local
    caches in local-layer order, the global ones in global-layer
    order). Returns (logits, cache with ``pos + 1``)."""
    w = _gathered(prepare(cfg, params))
    pos = cache.pos
    x = _embed(cfg, w, tokens)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    li = gi = 0
    for lp, kind in zip(w.layers, cfg.layer_kinds()):
        if kind == "local":
            kv = (cache.k_local[li], cache.v_local[li])
            li += 1
        else:
            kv = (cache.k_global[gi], cache.v_global[gi])
            gi += 1
        x = _mixed_layer(cfg, constraints.gather(lp), x, kind=kind,
                         positions=positions, pos=pos, kv=kv)
    x = apply_norm(cfg, w.final_norm, x)
    return _unembed(cfg, w, x), cache._replace(pos=pos + 1)


def drift_store_spec(cfg: ModelConfig, batch: int, device="cpu"
                     ) -> Dict[str, torch.Tensor]:
    """Zero stacked checkpoint store of ``DriftDecode``: (L, batch, n_out)
    f32 per protected projection (one token per decode step); MoE layers
    protect the attention projections only."""
    d, h, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd,
                        cfg.d_ff)

    def z(nout):
        return torch.zeros((cfg.n_layers, batch, nout), dtype=torch.float32,
                           device=device)
    store = {"attn.q": z(h * hd), "attn.k": z(hkv * hd),
             "attn.v": z(hkv * hd), "attn.o": z(d)}
    if cfg.family != "moe":
        store.update({"mlp.gate": z(f), "mlp.up": z(f), "mlp.down": z(d)})
    return store


def param_count(cfg: ModelConfig) -> int:
    """Analytical parameter count, the reference's formula (the SSD
    blocks' projections; not their conv, ``A_log``, ``D``, ``dt_bias`` or
    norm scale). Like the reference's, it prices any other family as
    dense: an enc-dec config by its decoder's layers and embedding."""
    d, h, hkv, hd, f, v = (cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd,
                           cfg.d_ff, cfg.vocab)
    per_layer = 0
    if cfg.family != "ssm":
        per_layer += d * h * hd + 2 * d * hkv * hd + h * hd * d
    if cfg.family == "moe":
        per_layer += moe.moe_param_count(cfg)
    elif cfg.family != "ssm":
        per_layer += 3 * d * f
    if cfg.family in ("ssm", "hybrid"):
        di = cfg.d_inner
        per_layer += d * (2 * di + 2 * cfg.ssm_groups * cfg.ssm_state
                          + cfg.ssm_heads) + di * d
    n = cfg.n_layers * per_layer + v * d
    if not cfg.tie_embeddings:
        n += v * d
    return n
