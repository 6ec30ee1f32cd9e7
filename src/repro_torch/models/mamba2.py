"""Mamba-2 (SSD, state-space duality) blocks: chunked scan and the decode
recurrence.

Counterpart of ``repro.models.mamba2``. The SSD algorithm of Dao & Gu
(arXiv:2405.21060): the sequence splits into chunks; within a chunk the
recurrence is a masked quadratic form, across chunks a linear recurrence
carries the (H, N, P) state. Decode is the per-token recurrence.

The reference computes all of it in plain ``jnp`` (einsums and a
``lax.scan`` over chunks), outside any Pallas kernel, so the port computes
it in plain PyTorch: einsums, the depthwise causal conv as a sum over its
taps, and a Python loop over chunks. The dtypes follow the reference's
step for step: the causal conv runs in the activation dtype in
``ssd_forward`` and in f32 in ``ssd_decode_step``; ``dt``, ``A``, the
cumulative sums, their ``exp`` and the state are f32.

The in and out projections are GEMMs but, as in the reference, they do
not go through the ABFT context: the SSD block is unprotected.

Every function returns new tensors and writes none of its inputs, so a
``SsmState`` held by a caller stays as it was (the decode loop's rollback
snapshot relies on this, ``serving/ar.py``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ModelConfig, Params, dense_init,
                                       trunc_normal)


class SsmState(NamedTuple):
    h: torch.Tensor        # (B, G, Hg, N, P) f32 recurrent state
    conv: torch.Tensor     # (B, convw-1, conv_ch) causal-conv tail


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def init_ssm_params(cfg: ModelConfig, generator: torch.Generator,
                    device="cpu", cast: Callable = lambda w: w) -> Params:
    """The reference's init law, drawn from ``generator``: ``in_proj`` and
    ``out_proj`` (handed to ``cast`` as drawn), the conv weight (std
    ``convw ** -0.5``) in ``param_dtype``; ``A_log = log(1..H)``, ``D = 1``
    and ``dt_bias = softplus^-1(0.01)`` in f32; zero conv bias and norm
    scale in ``param_dtype``."""
    d, di, nh, pdt = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.param_dtype
    cch = conv_channels(cfg)
    proj_out = 2 * di + 2 * cfg.ssm_groups * cfg.ssm_state + nh
    f32 = dict(dtype=torch.float32, device=device)
    p: Params = {
        "in_proj": cast(dense_init(d, proj_out, pdt, device, generator)),
        "conv_w": trunc_normal((cfg.ssm_conv_width, cch),
                               cfg.ssm_conv_width ** -0.5, pdt, device,
                               generator),
        "conv_b": torch.zeros((cch,), dtype=pdt, device=device),
        "A_log": torch.log(torch.arange(1, nh + 1, **f32)),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.full((nh,), 1e-2, **f32))),
        "norm_scale": torch.zeros((di,), dtype=pdt, device=device),
    }
    p["out_proj"] = cast(dense_init(di, d, pdt, device, generator))
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal 1-D conv in ``x.dtype``. x: (B, S, C); w: (W, C);
    tail: (B, W-1, C), zeros when None.

    The W taps are summed in f32 (a product of two bf16 values is exact
    there) and the sum rounded to ``x.dtype``, as a conv that accumulates
    in f32 rounds it; the bias is added in ``x.dtype``, as the reference
    adds it. A sum of taps, not ``F.conv1d``: cuDNN would take TF32 for an
    f32 conv on the card."""
    cw, _ = w.shape
    s = x.shape[1]
    if tail is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    wf = w.to(x.dtype).float()
    acc = xp[:, :s].float() * wf[0]
    for i in range(1, cw):
        acc = acc + xp[:, i:i + s].float() * wf[i]
    return acc.to(x.dtype) + b.to(x.dtype)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]
    return z, xbc, dt


def _gated_norm(y: torch.Tensor, z: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """RMS norm of ``y * silu(z)`` in f32 (eps 1e-6), scaled by
    ``1 + scale``, cast to ``y.dtype``."""
    g = y.float() * F.silu(z.float())
    var = (g * g).mean(dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + 1e-6)
            * (1.0 + scale.float())).to(y.dtype)


def ssd_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                return_state: bool = False
                ) -> Tuple[torch.Tensor, Optional[SsmState]]:
    """Chunked SSD over a whole sequence from a zero state. x: (B, S, d)
    -> (B, S, d); with ``return_state``, also the state after the last
    token (the recurrent ``h`` and the conv's input tail)."""
    b, s, _ = x.shape
    nh, hp, ng, ns = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
                      cfg.ssm_state)
    hg = nh // ng
    q = min(cfg.ssm_chunk, s)
    pad = (-s) % q
    di = cfg.d_inner

    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    xbc_conv = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]).float()
                      ).to(x.dtype)
    xs = xbc_conv[..., :di]
    bc = xbc_conv[..., di:]
    b_ssm = bc[..., :ng * ns].reshape(b, s, ng, ns).float()
    c_ssm = bc[..., ng * ns:].reshape(b, s, ng, ns).float()

    dt = F.softplus(dt_raw.float() + p["dt_bias"])           # (B, S, nh)
    a_neg = -torch.exp(p["A_log"])                           # (nh,)
    da = dt * a_neg                                          # (B, S, nh) <= 0

    xh = xs.reshape(b, s, nh, hp).float()
    xdt = xh * dt[..., None]                                 # (B, S, nh, hp)

    if pad:
        def z_pad(t):   # zeros after the last token, on the S axis
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        da, xdt = z_pad(da), z_pad(xdt)
        b_ssm, c_ssm = z_pad(b_ssm), z_pad(c_ssm)
    sp = s + pad
    nc = sp // q

    # chunks, heads grouped (ng, hg)
    da_c = da.reshape(b, nc, q, ng, hg)
    xdt_c = xdt.reshape(b, nc, q, ng, hg, hp)
    b_c = b_ssm.reshape(b, nc, q, ng, ns)
    c_c = c_ssm.reshape(b, nc, q, ng, ns)

    l_t = torch.cumsum(da_c, dim=2).movedim(2, -1)           # (B,nc,ng,hg,Q)
    l_last = l_t[..., -1:]                                   # (B,nc,ng,hg,1)

    # within-chunk quadratic form
    diff = l_t[..., :, None] - l_t[..., None, :]             # (…,Q_t,Q_s)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    m_seg = torch.where(tri, torch.exp(torch.clamp(diff, max=0.0)),
                        torch.zeros((), device=x.device))
    cb = torch.einsum("bcqgn,bcsgn->bcgqs", c_c, b_c)
    y_intra = torch.einsum("bcgqs,bcghqs,bcsghp->bcqghp", cb, m_seg, xdt_c)

    # chunk states, then the linear recurrence across chunks
    decay_to_end = torch.exp(l_last - l_t)                   # (B,nc,ng,hg,Q)
    state_c = torch.einsum("bcsgn,bcghs,bcsghp->bcghnp", b_c, decay_to_end,
                           xdt_c)
    chunk_decay = torch.exp(l_last[..., 0])                  # (B,nc,ng,hg)
    h = torch.zeros((b, ng, hg, ns, hp), dtype=torch.float32,
                    device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)                                       # state BEFORE chunk
        h = chunk_decay[:, c, ..., None, None] * h + state_c[:, c]
    h_in = torch.stack(h_in, dim=1)                          # (B,nc,ng,hg,ns,hp)

    decay_from_start = torch.exp(l_t)                        # (B,nc,ng,hg,Q)
    y_inter = torch.einsum("bcqgn,bcghq,bcghnp->bcqghp", c_c,
                           decay_from_start, h_in)

    y = (y_intra + y_inter).reshape(b, sp, nh, hp)[:, :s]
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(b, s, di).to(x.dtype)
    y = _gated_norm(y, z, p["norm_scale"])
    out = y @ p["out_proj"].to(x.dtype)

    state = None
    if return_state:
        cw = cfg.ssm_conv_width
        tail = F.pad(xbc, (0, 0, cw - 1, 0))[:, -(cw - 1):]
        state = SsmState(h=h, conv=tail)
    return out, state


def ssd_decode_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    state: SsmState) -> Tuple[torch.Tensor, SsmState]:
    """One-token recurrence. x: (B, 1, d) -> (B, 1, d) and the new state
    (new tensors; ``state`` is left as it was)."""
    b = x.shape[0]
    nh, hp, ng, ns = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
                      cfg.ssm_state)
    hg = nh // ng
    di = cfg.d_inner

    zxbcdt = x @ p["in_proj"].to(x.dtype)                    # (B,1,·)
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)

    win = torch.cat([state.conv.to(x.dtype), xbc], dim=1)    # (B,cw,C)
    conv_out = (torch.einsum("bwc,wc->bc", win.float(), p["conv_w"].float())
                + p["conv_b"].float())
    xbc_t = F.silu(conv_out)                                 # (B, C) f32
    new_conv = win[:, 1:]

    xs = xbc_t[:, :di].reshape(b, ng, hg, hp)
    b_t = xbc_t[:, di:di + ng * ns].reshape(b, ng, ns)
    c_t = xbc_t[:, di + ng * ns:].reshape(b, ng, ns)

    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])     # (B, nh)
    a = torch.exp(dt * -torch.exp(p["A_log"])).reshape(b, ng, hg)
    xdt = xs * dt.reshape(b, ng, hg)[..., None]

    h = (a[..., None, None] * state.h
         + torch.einsum("bgn,bghp->bghnp", b_t, xdt))
    y = torch.einsum("bgn,bghnp->bghp", c_t, h)
    y = y + p["D"].reshape(ng, hg)[None, :, :, None] * xs
    y = y.reshape(b, 1, di).to(x.dtype)
    y = _gated_norm(y, z, p["norm_scale"])
    out = y @ p["out_proj"].to(x.dtype)
    return out, SsmState(h=h, conv=new_conv)


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device="cpu") -> SsmState:
    ng, hg = cfg.ssm_groups, cfg.ssm_heads // cfg.ssm_groups
    return SsmState(
        h=torch.zeros((batch, ng, hg, cfg.ssm_state, cfg.ssm_head_dim),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, conv_channels(cfg)),
                         dtype=dtype, device=device))
