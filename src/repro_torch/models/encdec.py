"""Encoder-decoder transformer (whisper-base backbone).

Counterpart of ``repro.models.encdec``. The audio frontend (log-mel and
conv downsampling) is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, encoder_seq, d_model). A pre-LN encoder
runs full self-attention over the frames; the decoder runs causal
self-attention, cross-attention to the encoder's output and a gelu
(tanh) MLP.

Kept as the reference has them: RoPE applied to the decoder's token
embeddings (not to q and k), learned encoder positions added to the
frames, the unembedding tied to the token embedding, and the DRIFT note
of the reference's docstring left to its code, which has no execution
context here: nothing in this model is protected (ROADMAP Queue C).

Self-attention over a whole sequence (the encoder's, non-causal; the
decoder's in ``decode_train``, causal) runs the attention kernel
(``kernels.flash_attention.mha_flash``). Cross-attention has the tokens'
queries against the frames' keys, which the kernel does not take (one
length for q and kv, as the Pallas kernel), so it runs the plain
``full_attention``, as the UNet's does; the reference's is plain XLA
too. On the CPU every whole-sequence attention is the reference's
``attention_any``. Decode attention is the plain ``decode_attention``,
as for the decoder LMs, and the self-attention cache is written in
place; ``EncDecCache.pos`` is a host int.

Params are nested dicts like the reference's, except that ``enc_layers``
and ``dec_layers`` are lists with one dict per layer (the reference
stacks them on a leading L axis); ``params_from_jax`` converts.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import mha_flash
from repro_torch.models import attention
from repro_torch.models.common import (ModelConfig, Params, apply_norm,
                                       apply_rope, dense_init, embed_init,
                                       norm_params, trunc_normal)


def _check_cfg(cfg: ModelConfig) -> None:
    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name}: models.encdec takes the encdec "
                         f"family, got {cfg.family!r}")


# ---------------------------------------------------------------- params
def init_params(cfg: ModelConfig, seed: int, device="cpu") -> Params:
    """Random params from ``seed`` with the reference's init law:
    truncated-normal projections (std d_in^-1/2), embedding (std 1) and
    encoder positions (std 0.02); LayerNorm scales 1 and biases 0."""
    _check_cfg(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    d, f, pdt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    h, hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd

    def dense(a, b):
        return dense_init(a, b, pdt, device, g)

    def attn():
        return {"wq": dense(d, h * hd), "wk": dense(d, hkv * hd),
                "wv": dense(d, hkv * hd), "wo": dense(h * hd, d)}

    def mlp():
        return {"w_up": dense(d, f), "w_down": dense(f, d)}

    def norm():
        return norm_params(cfg, device)

    p: Params = {"embed": embed_init(cfg.vocab, d, pdt, device, g),
                 "enc_pos": trunc_normal((cfg.encoder_seq, d), 0.02, pdt,
                                         device, g)}
    p["enc_layers"] = [{"ln1": norm(), "attn": attn(), "ln2": norm(),
                        "mlp": mlp()} for _ in range(cfg.n_encoder_layers)]
    p["enc_final"] = norm()
    p["dec_layers"] = [{"ln1": norm(), "attn": attn(), "ln_x": norm(),
                        "xattn": attn(), "ln2": norm(), "mlp": mlp()}
                       for _ in range(cfg.n_layers)]
    p["dec_final"] = norm()
    return p


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Params:
    """The port's params from the reference's pytree (leaves as numpy
    arrays or anything ``np.asarray`` takes), unstacking the (L, ...)
    ``enc_layers`` and ``dec_layers`` leaves into one dict per layer."""
    def walk(t, i=None):
        if isinstance(t, dict):
            return {k: walk(v, i) for k, v in t.items()}
        a = np.array(t) if i is None else np.array(t[i])
        return torch.from_numpy(a).to(device)

    def depth(t):
        while isinstance(t, dict):
            t = next(iter(t.values()))
        return len(t)

    stacked = ("enc_layers", "dec_layers")
    out = {k: walk(v) for k, v in tree.items() if k not in stacked}
    for k in stacked:
        out[k] = [walk(tree[k], i) for i in range(depth(tree[k]))]
    return out


# ---------------------------------------------------------------- blocks
def _mha(cfg: ModelConfig, p: Params, x: torch.Tensor,
         kv_src: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """Attention over a whole sequence: self-attention when ``kv_src`` is
    ``x`` (the kernel on the card), cross-attention otherwise (plain)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, h, hd)
    k = (kv_src @ p["wk"].to(x.dtype)).reshape(b, -1, hkv, hd)
    v = (kv_src @ p["wv"].to(x.dtype)).reshape(b, -1, hkv, hd)
    if q.device.type == "cpu":
        o = attention.attention_any(q, k, v, causal=causal)
    elif kv_src is x:
        o = mha_flash(q, k, v, causal=causal)
    else:
        o = attention.full_attention(q, k, v, causal=causal)
    return o.reshape(b, s, h * hd) @ p["wo"].to(x.dtype)


def _mha_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                cache_kv: Tuple[torch.Tensor, torch.Tensor], pos: int,
                self_attn: bool) -> torch.Tensor:
    """One token's attention against a cache: self-attention writes the
    token's k and v at ``pos`` in place and reads slots 0..pos;
    cross-attention reads every frame of the static memory."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, h, hd)
    ck, cv = cache_kv
    if self_attn:
        k = (x @ p["wk"].to(x.dtype)).reshape(b, s, hkv, hd)
        v = (x @ p["wv"].to(x.dtype)).reshape(b, s, hkv, hd)
        ck[:, pos:pos + 1] = k.to(ck.dtype)
        cv[:, pos:pos + 1] = v.to(cv.dtype)
    else:
        pos = ck.shape[1] - 1
    o = attention.decode_attention(q, ck, cv, pos=pos)
    return o.reshape(b, s, h * hd) @ p["wo"].to(x.dtype)


def _mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu((x @ p["w_up"].to(x.dtype)).float(), approximate="tanh")
    return h.to(x.dtype) @ p["w_down"].to(x.dtype)


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens].to(cfg.dtype)
    return apply_rope(x[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]


def _unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    return (x @ params["embed"].to(x.dtype).T).float()


# ---------------------------------------------------------------- passes
def encode(cfg: ModelConfig, params: Params,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, encoder_seq, d_model) stub embeddings -> memory."""
    _check_cfg(cfg)
    x = frames.to(cfg.dtype) + params["enc_pos"].to(cfg.dtype)
    for p_i in params["enc_layers"]:
        h = apply_norm(cfg, p_i["ln1"], x)
        x = x + _mha(cfg, p_i["attn"], h, h, causal=False)
        x = x + _mlp(cfg, p_i["mlp"], apply_norm(cfg, p_i["ln2"], x))
    return apply_norm(cfg, params["enc_final"], x)


def decode_train(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 memory: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder pass over tokens (B, S) -> logits (B, S, V)
    f32."""
    _check_cfg(cfg)
    x = _embed(cfg, params, tokens,
               torch.arange(tokens.shape[1], device=tokens.device))
    for p_i in params["dec_layers"]:
        h = apply_norm(cfg, p_i["ln1"], x)
        x = x + _mha(cfg, p_i["attn"], h, h, causal=True)
        x = x + _mha(cfg, p_i["xattn"], apply_norm(cfg, p_i["ln_x"], x),
                     memory, causal=False)
        x = x + _mlp(cfg, p_i["mlp"], apply_norm(cfg, p_i["ln2"], x))
    return _unembed(params, apply_norm(cfg, params["dec_final"], x))


class EncDecCache(NamedTuple):
    self_k: torch.Tensor     # (L, B, S_max, Hkv, hd), written in place
    self_v: torch.Tensor
    cross_k: torch.Tensor    # (L, B, enc_seq, Hkv, hd)
    cross_v: torch.Tensor
    pos: int                 # next write index (host int)


def init_decode_cache(cfg: ModelConfig, params: Params,
                      memory: torch.Tensor, max_seq: int) -> EncDecCache:
    """Zero self-attention caches and each decoder layer's cross-attention
    k and v of ``memory``, in ``cfg.dtype``."""
    _check_cfg(cfg)
    b = memory.shape[0]
    hkv, hd = cfg.kv_heads, cfg.hd
    shape = (cfg.n_layers, b, max_seq, hkv, hd)
    ks, vs = [], []
    for p_i in params["dec_layers"]:
        xp = p_i["xattn"]
        ks.append((memory @ xp["wk"].to(memory.dtype)).reshape(b, -1, hkv,
                                                                hd))
        vs.append((memory @ xp["wv"].to(memory.dtype)).reshape(b, -1, hkv,
                                                                hd))
    dev = memory.device
    return EncDecCache(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                       torch.zeros(shape, dtype=cfg.dtype, device=dev),
                       torch.stack(ks).to(cfg.dtype),
                       torch.stack(vs).to(cfg.dtype), 0)


def decode_step(cfg: ModelConfig, params: Params, cache: EncDecCache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, EncDecCache]:
    """One decode token. tokens: (B, 1) -> (logits (B, 1, V) f32, the
    cache one position on; its self-attention k and v written in
    place)."""
    _check_cfg(cfg)
    pos = cache.pos
    x = _embed(cfg, params, tokens,
               torch.full((1,), pos, dtype=torch.int64,
                          device=tokens.device))
    for i, p_i in enumerate(params["dec_layers"]):
        x = x + _mha_decode(cfg, p_i["attn"], apply_norm(cfg, p_i["ln1"], x),
                            (cache.self_k[i], cache.self_v[i]), pos, True)
        x = x + _mha_decode(cfg, p_i["xattn"],
                            apply_norm(cfg, p_i["ln_x"], x),
                            (cache.cross_k[i], cache.cross_v[i]), pos, False)
        x = x + _mlp(cfg, p_i["mlp"], apply_norm(cfg, p_i["ln2"], x))
    logits = _unembed(params, apply_norm(cfg, params["dec_final"], x))
    return logits, cache._replace(pos=pos + 1)
