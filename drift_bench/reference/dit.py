"""Plain reference: DRIFT-protected DiT and PixArt-alpha sampling.

What one batch of the cell computes, written from the papers and the
configuration's stated precisions, in plain PyTorch:

* DiT-XL/2 (arXiv:2212.09748): patch embedding, a frequency timestep
  embedding through a two-layer MLP, a class table, N blocks of adaLN
  modulated self-attention and a tanh-GELU MLP with gated residuals, a
  modulated final layer. PixArt-alpha (arXiv:2310.00426) adds a projection
  of the text tokens, whose token mean takes the class embedding's place,
  and a cross-attention branch in each block between self-attention and
  the MLP (per-block adaLN, the port's choice, in place of adaLN-single).
* Activations in the configuration's ``dtype`` (bfloat16 at full width);
  layer norms, softmax, GELU, SiLU of the conditioning, the quantization
  scales and the dequantization in float32; the adaLN projections are
  unprotected matmuls in the activation dtype. TF32 is off.
* Every projection is a DRIFT GEMM (``protected_gemm``): symmetric
  quantization to ``bits`` (8: int8; the activation per tensor, the
  weight per output column), an exact integer product (float64, exact for
  these sizes), the flip mask xored into the int32 words, ABFT over 32 x
  32 tiles (each tile's row and column sums against the sums the operands
  predict, mod 2^32), a tile row or column flagged at |difference| >=
  2^10, every element of a flagged row or column of a tile replaced from
  the checkpoint (zeros before the first), the checkpoint refreshed from
  the corrected output every ``interval`` steps.
* Resilience classes: the patch, timestep, text and final GEMMs and block
  0 run at BER 0, the other blocks at the operating point's BER, except
  for the first ``nominal_steps`` steps, which run at BER 0 everywhere.
* DDIM (eta 0) over the evenly spaced timesteps of a linear-beta DDPM
  schedule of 1000 steps, x0 clipped to [-4, 4]; the final latents
  clipped to [-1, 1].

Nothing here imports the port or JAX. Parameters come as the tree of
``drift_bench.weights``; flip masks from a flip source ``(site, shape,
ber) -> int32 mask`` (``drift_bench.flips``), asked with the port's site
names.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from drift_bench.flips import Site

TILE = 32
THRESHOLD = 1 << 10
EMBED_SCOPE = 1000
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 mod 2^32 as int32 two's complement."""
    return (torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


def _round_up(n: int) -> int:
    return -(-n // TILE) * TILE


def quantize(x: torch.Tensor, bits: int, axis: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(integer levels as float64, float32 scale): symmetric, in the
    input's dtype, round half to even; per tensor, or per slice along
    ``axis``."""
    qmax = float(2 ** (bits - 1) - 1)
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=1 - axis, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return q.double(), scale.float()


def drift_gemm(aq: torch.Tensor, sx: torch.Tensor, bq: torch.Tensor,
               sw: torch.Tensor, flips: Optional[torch.Tensor],
               ckpt: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output f32 (M, N), replaced elements bool (M, N)) of the DRIFT GEMM
    on quantized operands: ``aq (M, K)`` and ``bq (K, N)`` integer levels
    (float64), the activation scale ``sx`` and the weight's column scales
    ``sw``, the int32 flip mask (M, N) or None, the checkpoint (M, N) or
    None for zeros. The product is exact in float64 and wrapped to int32;
    ABFT over 32 x 32 tiles flags a tile row or column whose sum differs
    from the operands' prediction by 2^10 or more, mod 2^32; the flagged
    rows and columns of a tile take the checkpoint."""
    m, k = aq.shape
    n = bq.shape[1]
    mp, np_ = _round_up(m), _round_up(n)
    mt, nt = mp // TILE, np_ // TILE
    a = F.pad(aq, (0, 0, 0, mp - m))
    b = F.pad(bq, (0, np_ - n))
    acc = wrap_i32((a @ b).long())
    if flips is not None:
        acc = acc ^ F.pad(flips, (0, np_ - n, 0, mp - m))
    acc64 = acc.long()
    row_diff = wrap_i32(acc64.reshape(mp, nt, TILE).sum(2)
                        - (a @ b.reshape(k, nt, TILE).sum(2)).long())
    col_diff = wrap_i32(acc64.reshape(mt, TILE, np_).sum(1)
                        - (a.reshape(mt, TILE, k).sum(1) @ b).long())
    flag_r = (row_diff >= THRESHOLD) | (row_diff <= -THRESHOLD)
    flag_c = (col_diff >= THRESHOLD) | (col_diff <= -THRESHOLD)
    mask = (flag_r.repeat_interleave(TILE, 1)
            | flag_c.repeat_interleave(TILE, 0))[:m, :n]
    y = acc[:m, :n].float() * sx * sw.reshape(1, -1)
    return torch.where(mask, ckpt if ckpt is not None
                       else torch.zeros_like(y), y), mask


def tile_counts(mask: torch.Tensor) -> torch.Tensor:
    """Replaced elements of each 32 x 32 tile of an (M, N) mask, int32."""
    m, n = mask.shape
    mp, np_ = _round_up(m), _round_up(n)
    full = F.pad(mask.int(), (0, np_ - n, 0, mp - m))
    return full.reshape(mp // TILE, TILE, np_ // TILE, TILE).sum(
        (1, 3)).int()


#: the parameter of each block GEMM, by the port's site name
BLOCK_WEIGHTS = {"attn.q": ("attn", "wq"), "attn.k": ("attn", "wk"),
                 "attn.v": ("attn", "wv"), "attn.o": ("attn", "wo"),
                 "xattn.q": ("xattn", "wq"), "xattn.k": ("xattn", "wk"),
                 "xattn.v": ("xattn", "wv"), "xattn.o": ("xattn", "wo"),
                 "mlp.w1": ("mlp_w1",), "mlp.w2": ("mlp_w2",)}


def block_weight(params: dict, scope: int, name: str) -> torch.Tensor:
    """The (K, N) weight of GEMM ``name`` of block ``scope``."""
    node = params["blocks"][scope]
    for key in BLOCK_WEIGHTS[name]:
        node = node[key]
    return node


class Drift:
    """The protection state of one sampling run. ``on_gemm(step, scope,
    name, aq, sx, ckpt, out, mask)``, where given, sees every GEMM."""

    def __init__(self, bits: int, ber: float, nominal_steps: int,
                 interval: int, flip_source: Optional[Callable],
                 on_gemm: Optional[Callable] = None):
        self.bits = bits
        self.ber = float(ber)
        self.nominal_steps = nominal_steps
        self.interval = interval
        self.flip_source = flip_source
        self.on_gemm = on_gemm
        self.store: Dict[Tuple[int, str], torch.Tensor] = {}
        self.step = 0
        self.corrected = 0

    def ber_at(self, scope: int) -> float:
        """BER of a GEMM of block ``scope`` (``EMBED_SCOPE``: the
        embedding GEMMs) at the current step."""
        if self.step < self.nominal_steps or scope in (EMBED_SCOPE, 0):
            return 0.0
        return self.ber

    def gemm(self, x: torch.Tensor, w: torch.Tensor, scope: int,
             name: str) -> torch.Tensor:
        """``x (..., K) @ w (K, N)`` through the DRIFT GEMM, in x's dtype."""
        lead = x.shape[:-1]
        y = self.protected_gemm(x.reshape(-1, x.shape[-1]), w.to(x.dtype),
                                scope, name)
        return y.reshape(*lead, -1).to(x.dtype)

    def protected_gemm(self, x: torch.Tensor, w: torch.Tensor, scope: int,
                       name: str) -> torch.Tensor:
        xq, sx = quantize(x, self.bits)
        wq, sw = quantize(w, self.bits, axis=1)
        ber = self.ber_at(scope)
        flips = (self.flip_source(Site(self.step, scope, name),
                                  (x.shape[0], w.shape[1]), ber)
                 if ber > 0.0 else None)
        key = (scope, name)
        ckpt = self.store.get(key) if self.step > 0 else None
        out, mask = drift_gemm(xq, sx, wq, sw, flips, ckpt)
        self.corrected += int(mask.sum())
        if self.on_gemm is not None:
            self.on_gemm(self.step, scope, name, xq, sx, ckpt, out, mask)
        if self.step % self.interval == 0:
            self.store[key] = out.clone()
        return out


# ------------------------------------------------------------------ model
def layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Softmax attention of (B, Sq, H, D) q against (B, Sk, H, D) k, v in
    float32, one batch row at a time; out in q's dtype."""
    d = q.shape[-1]
    out = []
    for i in range(q.shape[0]):
        qi = q[i].float().transpose(0, 1)          # (H, Sq, D)
        ki = k[i].float().transpose(0, 1)
        vi = v[i].float().transpose(0, 1)
        p = torch.softmax((qi @ ki.transpose(1, 2)) * d ** -0.5, dim=-1)
        out.append((p @ vi).transpose(0, 1))
    return torch.stack(out).to(q.dtype)


def adaln(c: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype
          ) -> torch.Tensor:
    return F.silu(c.float()).to(dtype) @ w.to(dtype) + b.to(dtype)


def block(cfg: dict, p: dict, x, c, text, dr: Drift, i: int):
    bsz, t, _ = x.shape
    h, hd = cfg["n_heads"], cfg["head_dim"]
    s1, sc1, g1, s2, sc2, g2 = torch.chunk(
        adaln(c, p["adaln_w"], p["adaln_b"], x.dtype), 6, dim=-1)
    xn = modulate(layernorm(x), s1, sc1)
    a = p["attn"]
    q = dr.gemm(xn, a["wq"], i, "attn.q").reshape(bsz, t, h, hd)
    k = dr.gemm(xn, a["wk"], i, "attn.k").reshape(bsz, t, h, hd)
    v = dr.gemm(xn, a["wv"], i, "attn.v").reshape(bsz, t, h, hd)
    o = dr.gemm(attention(q, k, v).reshape(bsz, t, h * hd), a["wo"], i,
                "attn.o")
    x = x + g1[:, None, :] * o
    if text is not None:
        a = p["xattn"]
        xn = layernorm(x)
        q = dr.gemm(xn, a["wq"], i, "xattn.q").reshape(bsz, t, h, hd)
        k = dr.gemm(text, a["wk"], i, "xattn.k").reshape(bsz, -1, h, hd)
        v = dr.gemm(text, a["wv"], i, "xattn.v").reshape(bsz, -1, h, hd)
        x = x + dr.gemm(attention(q, k, v).reshape(bsz, t, h * hd),
                        a["wo"], i, "xattn.o")
    xn = modulate(layernorm(x), s2, sc2)
    hid = dr.gemm(xn, p["mlp_w1"], i, "mlp.w1")
    hid = F.gelu(hid.float(), approximate="tanh").to(x.dtype)
    return x + g2[:, None, :] * dr.gemm(hid, p["mlp_w2"], i, "mlp.w2")


def timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def forward(cfg: dict, params: dict, latents, t, cond, text, dr: Drift
            ) -> torch.Tensor:
    """Predicted noise (B, H, W, C) float32."""
    dt = DTYPES[cfg["dtype"]]
    bsz, hh, ww, ch = latents.shape
    p = cfg["patch_size"]
    x = latents.to(dt).reshape(bsz, hh // p, p, ww // p, p, ch).permute(
        0, 1, 3, 2, 4, 5).reshape(bsz, (hh // p) * (ww // p), p * p * ch)
    x = dr.gemm(x, params["patch_w"], EMBED_SCOPE, "patch")
    x = x + params["patch_b"].to(dt) + params["pos_embed"].to(dt)
    temb = timestep_embedding(t).to(dt)
    temb = dr.gemm(temb, params["t_w1"], EMBED_SCOPE, "t.w1")
    temb = F.silu(temb + params["t_b1"].to(dt))
    temb = dr.gemm(temb, params["t_w2"], EMBED_SCOPE, "t.w2")
    temb = temb + params["t_b2"].to(dt)
    txt = None
    if cfg["cond_tokens"]:
        txt = dr.gemm(text.to(dt), params["text_proj"], EMBED_SCOPE, "text")
        c = temb + txt.mean(dim=1)
    else:
        c = temb + params["class_embed"].to(dt)[cond]
    for i, p_i in enumerate(params["blocks"]):
        x = block(cfg, p_i, x, c, txt, dr, i)
    shift, scale = torch.chunk(adaln(c, params["final_adaln_w"],
                                     params["final_adaln_b"], dt), 2, dim=-1)
    x = modulate(layernorm(x), shift, scale)
    x = dr.gemm(x, params["final_w"], EMBED_SCOPE, "final")
    x = x + params["final_b"].to(dt)
    x = x.reshape(bsz, hh // p, ww // p, p, p, ch).permute(
        0, 1, 3, 2, 4, 5).reshape(bsz, hh, ww, ch)
    return x.float()


# ---------------------------------------------------------------- sampler
def ddim_timesteps(train_steps: int, steps: int) -> np.ndarray:
    return np.linspace(train_steps - 1, 0, steps).round().astype(np.int32)


def alphas_cumprod(train_steps: int = 1000) -> np.ndarray:
    betas = np.linspace(1e-4, 2e-2, train_steps, dtype=np.float32)
    return np.cumprod(1.0 - betas)


def ddim_step(x, eps, a_t: np.float32, a_p: np.float32):
    x0 = (x - float(np.sqrt(np.float32(1.0) - a_t)) * eps) \
        / float(np.sqrt(a_t))
    x0 = torch.clamp(x0, -4.0, 4.0)
    return float(np.sqrt(a_p)) * x0 \
        + float(np.sqrt(np.float32(1.0) - a_p)) * eps


def sample(cfg: dict, params: dict, latents, cond, text, *, steps: int,
           ber: float, nominal_steps: int, interval: int,
           flip_source: Optional[Callable], bits: int = 8,
           on_eval: Optional[Callable] = None,
           on_gemm: Optional[Callable] = None) -> Tuple[torch.Tensor, int]:
    """(final latents clipped to [-1, 1], corrected elements) of one
    batch: ``steps`` DDIM steps from ``latents``, the body at ``ber``;
    ``on_eval(step, latents, eps)`` sees every evaluation, ``on_gemm``
    every GEMM (``Drift``)."""
    ac = alphas_cumprod()
    ts = ddim_timesteps(len(ac), steps)
    dr = Drift(bits, ber, nominal_steps, interval, flip_source, on_gemm)
    x = latents
    with torch.no_grad():
        for i, t in enumerate(ts):
            dr.step = i
            tvec = torch.full((x.shape[0],), float(t), dtype=torch.float32,
                              device=x.device)
            eps = forward(cfg, params, x, tvec, cond, text, dr)
            if on_eval is not None:
                on_eval(i, x, eps)
            a_p = ac[ts[i + 1]] if i + 1 < len(ts) else np.float32(1.0)
            x = ddim_step(x, eps, ac[int(t)], a_p)
    return torch.clamp(x, -1.0, 1.0), dr.corrected
