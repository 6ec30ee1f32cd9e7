"""Frozen counts of operations and bytes, from the configuration's sizes.

These are the yardstick's own, not the program's: a later change to the
port's accounting cannot move a roofline share or the step's MFU.

* ``gemm_calls(cfg, batch)``: every protected GEMM of one model
  evaluation of a batch, as ``Gemm(scope, name, m, k, n)``: the patch and
  timestep GEMMs, PixArt's text projection, per block q, k, v, o (PixArt:
  and its cross-attention's q, k, v, o), the MLP's two, and the final
  GEMM.
* ``drift_gemm_work(m, k, n, flip_words, ckpt_reads)``: one call of the
  fused DRIFT GEMM: int8 operations of the product and of both expected
  checksums (row sums of A times B's 32-column block sums, A's 32-row
  block sums times B); bytes with each input read once (the two int8
  operands, the flips where the call has them, the activation scale, the
  weight's column scales, the checkpoint words of the masked elements) and
  each output written once (the float32 output, the per-tile row and
  column checksum differences and the per-tile masked counts, int32).
* ``attention_work(b, s, h, d)``: one self-attention call, bf16: 4 D
  FLOPs per (query, key) pair and head; q, k, v read once, o written once.
* ``model_ops_per_image(cfg)``: the model's operations for one image
  and one evaluation: 2 M K N for every projection (protected or the
  unprotected adaLN ones), 4 S_q S_k D H for every attention.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

TILE = 32
EMBED_SCOPE = 1000


class Gemm(NamedTuple):
    scope: int      # block index, or EMBED_SCOPE
    name: str
    m: int
    k: int
    n: int


def tokens(cfg: dict) -> int:
    return (cfg["latent_size"] // cfg["patch_size"]) ** 2


def patch_dim(cfg: dict) -> int:
    return cfg["patch_size"] ** 2 * cfg["latent_channels"]


def gemm_calls(cfg: dict, batch: int) -> List[Gemm]:
    d, f = cfg["d_model"], cfg["d_ff"]
    hd = cfg["n_heads"] * cfg["head_dim"]
    bt = batch * tokens(cfg)
    btext = batch * cfg["cond_tokens"]
    e = EMBED_SCOPE
    calls = [Gemm(e, "patch", bt, patch_dim(cfg), d),
             Gemm(e, "t.w1", batch, 256, d), Gemm(e, "t.w2", batch, d, d)]
    if cfg["cond_tokens"]:
        calls.append(Gemm(e, "text", btext, cfg["cond_dim"], d))
    for i in range(cfg["n_layers"]):
        calls += [Gemm(i, "attn.q", bt, d, hd), Gemm(i, "attn.k", bt, d, hd),
                  Gemm(i, "attn.v", bt, d, hd), Gemm(i, "attn.o", bt, hd, d)]
        if cfg["cond_tokens"]:
            calls += [Gemm(i, "xattn.q", bt, d, hd),
                      Gemm(i, "xattn.k", btext, d, hd),
                      Gemm(i, "xattn.v", btext, d, hd),
                      Gemm(i, "xattn.o", bt, hd, d)]
        calls += [Gemm(i, "mlp.w1", bt, d, f), Gemm(i, "mlp.w2", bt, f, d)]
    calls.append(Gemm(e, "final", bt, d, patch_dim(cfg)))
    return calls


def _tiles(n: int) -> int:
    return -(-n // TILE)


def drift_gemm_work(m: int, k: int, n: int, flip_words: int = 0,
                    ckpt_reads: int = 0) -> Dict[str, int]:
    mt, nt = _tiles(m), _tiles(n)
    mp, np_ = mt * TILE, nt * TILE
    return {"int8_ops": 2 * m * n * k + 2 * m * k * nt + 2 * mt * k * n,
            "flops": 0,
            "bytes": (m * k + k * n + 4 * flip_words + 4 + 4 * n
                      + 4 * ckpt_reads + 4 * m * n + 4 * mp * nt
                      + 4 * mt * np_ + 4 * mt * nt)}


def attention_work(b: int, s: int, h: int, d: int,
                   itemsize: int = 2) -> Dict[str, int]:
    return {"int8_ops": 0, "flops": 4 * b * h * d * s * s,
            "bytes": itemsize * b * s * d * 4 * h}


def model_ops_per_image(cfg: dict) -> Dict[str, int]:
    """{"int8_ops": protected projections, "flops": attention and the
    adaLN projections} for one image and one evaluation."""
    d, h, hd = cfg["d_model"], cfg["n_heads"], cfg["head_dim"]
    t, tt = tokens(cfg), cfg["cond_tokens"]
    gemm = sum(2 * g.m * g.k * g.n for g in gemm_calls(cfg, 1))
    attn = 4 * t * t * hd * h
    if tt:
        attn += 4 * t * tt * hd * h
    adaln = 2 * d * 6 * d
    return {"int8_ops": gemm,
            "flops": cfg["n_layers"] * (attn + adaln) + 2 * d * 2 * d}


def ber_at(traffic: dict, step: int, scope: int) -> float:
    """The BER of a GEMM of block ``scope`` at ``step`` in the cell's
    drift evaluations: 0 for the first ``nominal_steps`` steps, the
    embedding GEMMs and block 0; the operating point's elsewhere."""
    if step < traffic["nominal_steps"] or scope in (EMBED_SCOPE, 0):
        return 0.0
    return float(traffic["ber"])


def bound_s(work: Dict[str, int], peaks: dict) -> float:
    """Least time of ``work`` on the chip: the larger of its operations
    over their peak and its bytes over the memory bandwidth."""
    ops = (work["int8_ops"] / peaks["int8_ops_per_s"]
           + work["flops"] / peaks["bf16_flops_per_s"])
    return max(ops, work["bytes"] / peaks["hbm_bytes_per_s"])
